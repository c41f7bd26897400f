"""Port symmetric supercell ISDF (per-q build, assembly, certificates) ==
JAX reference, and the two identities of tests/test_isdf_sym.py on the
port alone.

Diamond primitive on an even 10^3 mesh (the Nyquist planes are in play)
with the Gamma-centred (3,1,1) k-mesh: k = b1/3 and 2 b1/3 form a
time-reversal pair that is not self-inverse. Both packages take the
reference's Bloch AOs (eval_ao_numpy); the supercell is the 3x1x1 diamond
cell on the matching 30x10x10 mesh. Float64 on the CPU.

Bars: W and Vxi within 1e-10 relative, both certificates within 1e-10
relative of the reference's certify_deficit (c=4: a well-conditioned
solve); the assembled robust K equals the supercell FFTDF K to 1e-8 at
saturated c; the certificate equals the direct supercell trace
tr(D (K_fftdf - K_robust)) to 1% at unsaturated c.

The reference's isdf_q.unique_q rounds the fractional q to 8 decimals,
so on a 3-point k-mesh axis q = 1/3 is off by 3e-9 and its assembled
factorization differs from the dense supercell build on the same points
by 1e-8 to 1e-7 relative (test_q_classes_exact); the port snaps q to exact
multiples of 1/n. The parity test therefore hands the reference the
port's exact q classes.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.linalg as sla

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu.df import isdf_q as ref_isdf_q, isdf_sym as ref_isdf_sym  # noqa: E402
from pyscf_isdf_tpu.k2gamma import dm_k2gamma as ref_dm_k2gamma  # noqa: E402
from pyscf_isdf_tpu.k2gamma import mo_k2gamma as ref_mo_k2gamma  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops.ao_eval import eval_ao_numpy  # noqa: E402

from pyscf_isdf_tpu_torch import lattice  # noqa: E402
from pyscf_isdf_tpu_torch.convert import (  # noqa: E402
    isdfq_from_numpy, sym_from_numpy,
)
from pyscf_isdf_tpu_torch.df import fftdf, isdf, isdf_q, isdf_sym  # noqa: E402
from pyscf_isdf_tpu_torch.k2gamma import dm_k2gamma, mo_k2gamma  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive, diamond_supercell  # noqa: E402
from pyscf_isdf_tpu_torch.ops import coulomb  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ao_eval import eval_ao_kpts  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_kscf_system  # noqa: E402

NREP = (3, 1, 1)
PM = (10, 10, 10)


def rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()


def _tr_orbitals(cell, ksys, kpts):
    """sqrt(occ)-weighted occupied orbitals of the hcore guess, with
    C_{-k} = conj(C_k) imposed on every time-reversal pair, so the
    unfolded supercell density is real to rounding."""
    kpts = np.reshape(kpts, (-1, 3))
    nk = len(kpts)
    nocc = ksys.nelec_tot // (2 * nk)
    frac = kpts @ np.linalg.inv(lattice.reciprocal_vectors(cell.a))
    C_w = [None] * nk
    for k in range(nk):
        d = frac[k] + frac
        partner = int(np.argmin(np.abs(d - np.rint(d)).sum(1)))
        if C_w[partner] is not None:
            C_w[k] = C_w[partner].conj()
            continue
        h = ksys.hcore[k].numpy()
        S = ksys.S[k].numpy()
        _, v = sla.eigh(0.5 * (h + h.conj().T), 0.5 * (S + S.conj().T))
        C_w[k] = np.sqrt(2.0) * v[:, :nocc]
    return np.stack(C_w)


@pytest.fixture(scope="module")
def setup():
    prim, rprim = diamond_primitive(mesh=PM), ref_diamond(mesh=PM)
    kpts = lattice.make_kpts(prim.a, list(NREP), with_gamma_point=True)
    # the reference's Bloch AOs in the port's system: the IP selection of
    # both packages then sees the same near-tied pivots of this symmetric
    # cell (with the port's AOs the two break some ties differently)
    aoR_k = np.stack([eval_ao_numpy(rprim, kpt=k) for k in kpts])
    ksys = dataclasses.replace(build_kscf_system(prim, kpts, device="cpu"),
                               aoR_k=torch.as_tensor(aoR_k))
    sc = diamond_supercell(NREP, mesh=tuple(n * m for n, m in zip(NREP, PM)))
    # the supercell's Γ AOs slab by slab: each call keeps only the images
    # that reach its slab, half the work of one call over the whole grid
    slabs = np.array_split(sc.uniform_grid(), 6)
    ssys = SimpleNamespace(       # what the supercell exchange needs
        aoR=torch.cat([eval_ao_kpts(sc, np.zeros((1, 3)), coords=c, device="cpu")[0]
                       for c in slabs]).real.contiguous(),
        coulG=torch.as_tensor(coulomb.get_coulG(sc)), mesh=tuple(sc.mesh),
        weight=sc.grid_weight)
    C_w = _tr_orbitals(prim, ksys, kpts)
    dm_s = dm_k2gamma(prim, C_w @ C_w.conj().transpose(0, 2, 1), kpts, NREP)
    assert dm_s.dtype == np.float64           # imaginary part below 1e-8
    return rprim, prim, ksys, ssys, kpts, C_w, torch.as_tensor(dm_s)


@pytest.fixture(scope="module")
def built_c4(setup):
    """The port's per-q build at c=4 (a well-conditioned solve) and its
    assembled supercell factorization."""
    _, prim, ksys, ssys, kpts, _, _ = setup
    sym = isdf_sym.build_sym(prim, NREP, ksys.aoR_k, kpts, ssys.coulG.numpy(),
                             c=4.0)
    return sym, isdf_sym.assemble(sym, ssys.aoR, prim.a)


def _direct_deficit(fac, ssys, dm_s):
    vk_ref = fftdf.get_k(ssys.aoR, dm_s, ssys.coulG, ssys.mesh, ssys.weight)
    vk_rob = isdf.get_k_robust(fac, ssys.aoR, dm_s, ssys.weight)
    return vk_ref, vk_rob, float(torch.einsum("ij,ji->", dm_s, vk_ref - vk_rob))


def test_q_classes_exact(setup, monkeypatch):
    """The port's q classes are exact multiples of b/3, and its assembled
    factorization is the dense supercell build on the same points; with
    the reference's rounded q classes it is not."""
    rprim, prim, ksys, ssys, kpts, _, _ = setup
    binv = np.linalg.inv(lattice.reciprocal_vectors(prim.a))
    q, _ = isdf_q.unique_q(prim, kpts)
    assert np.abs(3 * q @ binv - np.rint(3 * q @ binv)).max() < 1e-12
    assert np.abs(ref_isdf_q.unique_q(rprim, kpts)[0] - q).max() > 1e-9

    def assembled_vs_dense():
        sym = isdf_sym.build_sym(prim, NREP, ksys.aoR_k, kpts, ssys.coulG.numpy(),
                                 c=2.0)
        fac = isdf_sym.assemble(sym, ssys.aoR, prim.a)
        _, W, Vxi = isdf._build_from_idx(ssys.aoR, fac.ip_idx, ssys.coulG,
                                         ssys.mesh, ssys.weight, keep_v=True)
        return rel(fac.W, W), rel(fac.Vxi, Vxi)

    assert max(assembled_vs_dense()) < 1e-12
    monkeypatch.setattr(isdf_q, "unique_q", ref_isdf_q.unique_q)
    assert 1e-8 < min(assembled_vs_dense()) and max(assembled_vs_dense()) < 1e-7


def test_build_assemble_certify_parity(setup, built_c4, monkeypatch):
    """Both packages from the same Bloch AOs and supercell aoR."""
    rprim, prim, ksys, ssys, kpts, C_w, _ = setup
    sym, fac = built_c4
    monkeypatch.setattr(ref_isdf_q, "unique_q", isdf_q.unique_q)
    coulG = ssys.coulG.numpy()
    aoR_k = ksys.aoR_k.numpy()
    sym0 = ref_isdf_sym.build_sym(rprim, NREP, jnp.asarray(aoR_k), kpts, coulG,
                                  c=4.0)
    fac0 = ref_isdf_sym.assemble(sym0, jnp.asarray(ssys.aoR.numpy()), rprim.a)
    psi = aoR_k @ C_w
    d0 = ref_isdf_sym.certify_deficit(sym0, jnp.asarray(psi))

    assert np.array_equal(sym.isdfq.ip_idx.numpy(), np.asarray(sym0.isdfq.ip_idx))
    assert np.array_equal(fac.ip_idx.numpy(), np.asarray(fac0.ip_idx))
    assert rel(sym.Mq, sym0.Mq) < 1e-10
    assert rel(fac.W, fac0.W) < 1e-10 and rel(fac.Vxi, fac0.Vxi) < 1e-10
    for d in (isdf_sym.certify_deficit(sym, torch.as_tensor(psi)),
              isdf_sym.certify_deficit_host(sym, torch.as_tensor(psi))):
        assert d > 0 and abs(d - d0) < 1e-10 * d0

    # the reference's per-q pieces carried across assemble to the same W
    q0 = sym0.isdfq
    port0 = sym_from_numpy(
        isdfq_from_numpy(q0.Ag, q0.Wq, q0.qmap, q0.ip_idx, q0.Xq, q0.VXq,
                         q0.phase_q, device="cpu"),
        sym0.q_list, sym0.kpts, sym0.nrep, sym0.prim_mesh, sym0.coulG_q,
        sym0.Mq, sym0.weight)
    assert rel(isdf_sym.assemble(port0, ssys.aoR, prim.a).W, fac0.W) < 1e-10


def test_assembled_robust_k_exact(setup):
    """Rank-saturated c: the assembled robust K is the supercell FFTDF K
    (phases, coset kernels and grid maps are exact)."""
    _, prim, ksys, ssys, kpts, _, dm_s = setup
    sym = isdf_sym.build_sym(prim, NREP, ksys.aoR_k, kpts, ssys.coulG.numpy(),
                             c=16.0)
    vk_ref, vk_rob, _ = _direct_deficit(isdf_sym.assemble(sym, ssys.aoR, prim.a),
                                        ssys, dm_s)
    assert (vk_rob - vk_ref).abs().max() < 1e-8


def test_certificate_matches_direct(setup, built_c4):
    """Unsaturated c: the per-q certificate is the supercell trace
    difference at the same (unfolded) density."""
    _, _, ksys, ssys, _, C_w, dm_s = setup
    sym, fac = built_c4
    _, _, de_direct = _direct_deficit(fac, ssys, dm_s)
    de_cert = isdf_sym.certify_deficit(sym, ksys.aoR_k @ torch.as_tensor(C_w))
    assert de_cert > 0 and de_direct > 0
    assert abs(de_cert - de_direct) < 0.01 * de_direct


def test_k2gamma(setup):
    rprim, prim, _, _, kpts, C_w, _ = setup
    dm_k = C_w @ C_w.conj().transpose(0, 2, 1)
    assert np.abs(dm_k2gamma(prim, dm_k, kpts, NREP)
                  - ref_dm_k2gamma(rprim, dm_k, kpts, NREP)).max() < 1e-12
    assert np.abs(mo_k2gamma(prim, C_w, kpts, NREP)
                  - ref_mo_k2gamma(rprim, list(C_w), kpts, NREP)).max() < 1e-12

"""Port space-group symmetry (symm.py), the IBZ k-point SCF
(scf/khf_ksymm.py, occupations.smearing_occ_ibz) and kmp2_ksymm_energy
== JAX reference.

The diamond primitive cell at 14^3 with a Gamma-centred 2x2x2 k-mesh
(nk 8, nk_ibz 3; the reference's own tests take 24^3). The reference's
IBZ driver runs on the port's system arrays (the same S, hcore, AO values
and kernels in the reference's KSCFSystem) and the port's on the
reference's IBZ data, so the two drivers start from the same numbers.
They exchange through one k-point ISDF factorization (c=4), since the
reference's FFTDF exchange runs eagerly pair by pair (seconds a cycle);
the port's FFTDF band subset is held to its full call, and its IBZ driver
with exact exchange to its full-zone one through the trivial reduction.
The reference's ISDF exchange compiles a new closure on every call, so
it runs as one jitted function of the same products, held to the
reference's own to 1e-12 on its first call, and its closed-shell XC under
one jax.jit. Bars: operations, k-point maps and weights equal,
expansions 1e-12, SCF energies 1e-8 Ha with equal iteration counts,
KMP2 1e-10 Ha.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import lattice as ref_lattice, symm as ref_symm  # noqa: E402
from pyscf_isdf_tpu.df import isdf_k as ref_isdf_k  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.mp import kmp2 as ref_kmp2  # noqa: E402
from pyscf_isdf_tpu.ops import xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.scf import khf_ksymm as ref_ksymm  # noqa: E402
from pyscf_isdf_tpu.scf.khf import KSCFSystem as RefKSCFSystem  # noqa: E402

from pyscf_isdf_tpu_torch import symm  # noqa: E402
from pyscf_isdf_tpu_torch.convert import ibz_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.df import fftdf_k, isdf_k  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.mp.kmp2 import kmp2_energy, kmp2_ksymm_energy  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_kscf_system, kscf_ibz_kernel, kscf_kernel  # noqa: E402

MESH = (14, 14, 14)
TOL = 1e-8
ISDF_C = 4


@partial(jax.jit, static_argnums=(3, 4))
def _isdf_k_exchange(Ug, Wq, dm, qmap, k1_idx):
    """The reference's get_k_kpts products (pyscf_isdf_tpu/df/isdf_k.py:
    393-403) for the band k-points k1_idx, in its order of summation."""
    nk = Ug.shape[0]
    M = [Ug[k] @ dm[k] @ Ug[k].conj().T for k in range(nk)]
    out = []
    for k1 in k1_idx:
        acc = jnp.zeros((Ug.shape[2], Ug.shape[2]), Ug.dtype)
        for k2 in range(nk):
            acc = acc + Ug[k1].conj().T @ (M[k2] * Wq[qmap[k2][k1]].conj()) @ Ug[k1]
        out.append(acc / nk)
    return jnp.stack(out)


@pytest.fixture(scope="module")
def isdf_fac(systems):
    """The port's k-point ISDF factorization of the system at c=4."""
    _, port, _ = systems
    return isdf_k.build_isdf_k(port.cell, port.aoR_k, port.kpts, c=ISDF_C)


@pytest.fixture(scope="module", autouse=True)
def _reference_compiled_once(isdf_fac):
    """The reference's closed-shell XC and ISDF exchange each under one
    jax.jit, and both drivers' k-point ISDF builds replaced by one
    factorization of the same arrays (the port's), so both exchange
    through the same factors and it is built once."""
    closed = jax.jit(ref_xc.XCSpec.exc_vxc, static_argnums=0)
    get_k_isdf = ref_isdf_k.get_k_kpts
    checked = []
    ref_fac = ref_isdf_k.ISDFK(Ug=jnp.asarray(isdf_fac.Ug.numpy()),
                               Wq=jnp.asarray(isdf_fac.Wq.numpy()), qmap=isdf_fac.qmap,
                               ip_idx=jnp.asarray(isdf_fac.ip_idx.numpy()))

    def build(fac):
        def build_isdf_k(cell, aoR_k, kpts, c=8.0, exxdiv=None, omega=0.0,
                         precision=None, **kw):
            assert c == ISDF_C and exxdiv is None and not omega and precision is None
            return fac
        return build_isdf_k

    def get_k(isdfk, dm_k, k1_idx=None):
        out = _isdf_k_exchange(isdfk.Ug, isdfk.Wq, jnp.asarray(dm_k, isdfk.Ug.dtype),
                               tuple(map(tuple, np.asarray(isdfk.qmap).tolist())),
                               tuple(k1_idx))
        if not checked:
            ref = np.asarray(get_k_isdf(isdfk, dm_k, k1_idx=k1_idx))
            assert np.abs(np.asarray(out) - ref).max() <= 1e-12 * np.abs(ref).max()
            checked.append(True)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_xc.XCSpec, "exc_vxc", lambda self, *a: closed(self, *a))
    mp.setattr(ref_isdf_k, "build_isdf_k", build(ref_fac))
    mp.setattr(isdf_k, "build_isdf_k", build(isdf_fac))
    mp.setattr(ref_isdf_k, "get_k_kpts", get_k)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def systems():
    """(reference cell, port system, the reference's KSCFSystem on the
    port's arrays)."""
    rcell = ref_diamond(mesh=MESH)
    kpts = ref_lattice.make_kpts(rcell.a, [2, 2, 2])
    port = build_kscf_system(diamond_primitive(mesh=MESH), kpts, device="cpu")
    ref = RefKSCFSystem(
        cell=rcell, kpts=port.kpts, S=port.S.numpy(), hcore=port.hcore.numpy(),
        X=np.stack([x.numpy() for x in port.X]), aoR_k=jnp.asarray(port.aoR_k.numpy()),
        coulG=port.coulG.numpy(), coulG_pairs=port.coulG_pairs.numpy(),
        expmikr=port.expmikr.numpy(), madelung=port.madelung, e_nuc=port.e_nuc,
        mesh=tuple(port.mesh), weight=port.weight, nelec_tot=port.nelec_tot)
    return rcell, port, ref


@pytest.fixture(scope="module")
def info(systems):
    rcell, port, _ = systems
    return symm.make_kpts_ibz(port.cell, port.kpts), ref_symm.make_kpts_ibz(rcell, port.kpts)


@pytest.fixture(scope="module")
def krhf(systems):
    """The port's KRHF through the shared ISDF factors on the IBZ and on the
    full zone."""
    _, port, _ = systems
    kw = dict(xc=None, df="isdf", isdf_c=ISDF_C, conv_tol=1e-10, device="cpu")
    return kscf_ibz_kernel(port, **kw), kscf_kernel(port, **kw)


def test_space_group_ops(systems):
    rcell, port, _ = systems
    ops, ref_ops = symm.space_group_ops(port.cell), ref_symm.space_group_ops(rcell)
    assert len(ops) == len(ref_ops) == 48
    assert sum(np.linalg.norm(op.t) > 1e-8 for op in ops) == 24
    for op, r in zip(ops, ref_ops):
        assert np.array_equal(op.W, r.W) and np.array_equal(op.perm, r.perm)
        assert np.abs(op.R - r.R).max() < 1e-12 and np.abs(op.t - r.t).max() < 1e-12
    D, D0 = symm.wigner_d_real(1, ops[5].R), ref_symm.wigner_d_real(1, ref_ops[5].R)
    assert np.abs(D - D0).max() < 1e-12


def test_make_kpts_ibz(systems, info):
    rcell, port, _ = systems
    out, ref = info
    assert out.nk_ibz == ref.nk_ibz == 3 and out.weights.sum() == 8
    for f in ("ibz_idx", "weights", "bz2ibz", "op_idx", "tr"):
        assert np.array_equal(getattr(out, f), getattr(ref, f)), f
    kpts3 = ref_lattice.make_kpts(rcell.a, [3, 3, 3])
    assert symm.make_kpts_ibz(port.cell, kpts3).nk_ibz == 4
    # the reference's reduction carried across
    conv = ibz_from_numpy(ref)
    assert np.array_equal(conv.bz2ibz, out.bz2ibz) and len(conv.ops) == 48
    meshes = symm.check_mesh_symmetry(port.cell, out.ops)
    ref_meshes = ref_symm.check_mesh_symmetry(rcell, ref.ops)
    assert meshes.keys() == ref_meshes.keys()
    assert all(np.array_equal(meshes[k], ref_meshes[k]) for k in meshes)


def test_expand_dm_and_mos(systems, info):
    rcell, port, _ = systems
    out, ref = info
    rng = np.random.default_rng(3)
    nao = port.cell.nao
    C = rng.standard_normal((3, nao, nao)) + 1j * rng.standard_normal((3, nao, nao))
    e = rng.standard_normal((3, nao))
    dm = C @ C.conj().transpose(0, 2, 1)
    full = symm.expand_dm(port.cell, out, torch.as_tensor(dm))
    assert np.abs(full.numpy() - ref_symm.expand_dm(rcell, ref, dm)).max() < 1e-12
    es, cs = symm.expand_mos(port.cell, out, [torch.as_tensor(c) for c in C], list(e))
    es0, cs0 = ref_symm.expand_mos(rcell, ref, C, e)
    assert np.abs(np.stack([c.numpy() for c in cs]) - np.stack(cs0)).max() < 1e-12
    assert np.array_equal(np.stack([x.numpy() for x in es]), np.stack(es0))
    # covariance: P S_k P^H == S_{Rk}
    S = symm.expand_dm(port.cell, out, port.S[torch.as_tensor(out.ibz_idx)])
    assert (S - port.S).abs().max() < 1e-12


def test_band_subset_of_exchange(systems, info, isdf_fac):
    """k1_idx gives the rows of the full call, on both k engines."""
    _, port, _ = systems
    ibz = [int(i) for i in info[0].ibz_idx]
    rng = np.random.default_rng(4)
    nk, nao = port.S.shape[:2]
    C = rng.standard_normal((nk, nao, 3)) + 1j * rng.standard_normal((nk, nao, 3))
    dm = torch.as_tensor(C @ C.conj().transpose(0, 2, 1))
    w = port.weight / nk
    full = fftdf_k.get_k_kpts(port.aoR_k, dm, port.coulG_pairs, port.expmikr, port.mesh, w)
    sub = fftdf_k.get_k_kpts(port.aoR_k, dm, port.coulG_pairs, port.expmikr, port.mesh, w,
                             k1_idx=ibz)
    assert (sub - full[ibz]).abs().max() < 1e-13 * full.abs().max()
    full = isdf_k.get_k_kpts(isdf_fac, dm)
    sub = isdf_k.get_k_kpts(isdf_fac, dm, k1_idx=ibz[::-1])
    assert (sub - full[ibz[::-1]]).abs().max() == 0


@pytest.mark.parametrize("xc", [None, "hse06"])
def test_trivial_reduction_is_the_full_zone_scf(xc):
    """With every k-point its own representative (the identity operation,
    weight 1) the IBZ driver is the full-zone SCF with exact exchange
    through the band subset (for HSE06 the full-range and long-range
    pair, each with its Madelung shift): the same energy and iteration
    count as kscf_kernel, on a shifted 1x1x2 k-mesh. (With a real
    reduction the two part by the mesh's symmetry-breaking collocation
    error: 5e-5 Ha at this file's 14^3 mesh, 6e-11 Ha at 24^3.)"""
    cell = diamond_primitive(mesh=(9, 9, 9))
    port = build_kscf_system(cell, ref_lattice.make_kpts(cell.a, [1, 1, 2],
                                                         with_gamma_point=False),
                             device="cpu")
    nk, natm = len(port.kpts), cell.natm
    identity = symm.SpaceGroupOp(R=np.eye(3), t=np.zeros(3), perm=np.arange(natm),
                                 W=np.eye(3, dtype=int))
    trivial = symm.IBZInfo(kpts=port.kpts, ibz_idx=np.arange(nk), weights=np.ones(nk),
                           bz2ibz=np.arange(nk), op_idx=np.zeros(nk, dtype=np.int64),
                           tr=np.zeros(nk, dtype=bool), ops=(identity,))
    out = kscf_ibz_kernel(port, info=trivial, xc=xc, conv_tol=1e-10, device="cpu")
    full = kscf_kernel(port, xc=xc, conv_tol=1e-10, device="cpu")
    assert out["converged"] and full["converged"]
    assert out["niter"] == full["niter"] > 2
    assert abs(out["e_tot"] - full["e_tot"]) < 1e-10


@pytest.mark.parametrize("kw", [dict(xc=None), dict(xc="pbe0"),
                                dict(xc=None, sigma=0.05)],
                         ids=["krhf", "pbe0", "smeared"])
def test_ibz_kscf(systems, krhf, info, kw):
    """KRHF, PBE0 and Fermi-smeared KRHF through the ISDF exchange (c=4):
    the port's driver on the reference's IBZ data against the reference's
    driver, equal iteration counts."""
    _, port, ref = systems
    if kw == dict(xc=None):
        out = krhf[0]
    else:
        out = kscf_ibz_kernel(port, info=ibz_from_numpy(info[1]), df="isdf",
                              isdf_c=ISDF_C, conv_tol=1e-10, device="cpu", **kw)
    ref_out = ref_ksymm.kscf_ibz_kernel(ref, df="isdf", isdf_c=ISDF_C, conv_tol=1e-10, **kw)
    assert out["converged"] and ref_out["converged"]
    assert out["niter"] == ref_out["niter"] > 2
    for key in ("e_tot", "e_free", "entropy", "mu"):
        assert abs((out[key] or 0.0) - ref_out[key]) < TOL, key
    if "sigma" in kw:
        assert out["entropy"] > 1e-8


def test_kmp2_ksymm(systems, krhf):
    rcell, port, ref = systems
    out, full = krhf
    e = kmp2_ksymm_energy(port, out, device="cpu")
    host = dict(out, mo_energy=[x.numpy() for x in out["mo_energy"]],
                mo_coeff=[x.numpy() for x in out["mo_coeff"]],
                ibz=ref_symm.make_kpts_ibz(rcell, port.kpts))
    assert abs(e - ref_kmp2.kmp2_ksymm_energy(ref, host)) < 1e-10
    # against KMP2 on the full-zone SCF: the reference's bar at this mesh
    # (tests/test_ksymm.py:128), set by the collocation's symmetry breaking
    assert abs(e - kmp2_energy(port, full, device="cpu")) < 1e-6


def test_unported_options_raise(systems):
    _, port, _ = systems
    for kw, err in ((dict(isdf_precision="dd", df="isdf"), NotImplementedError),
                    (dict(xc_grids="lebedev"), ValueError),
                    (dict(df="isdf_q"), ValueError)):
        with pytest.raises(err):
            kscf_ibz_kernel(port, xc="pbe0", device="cpu", **kw)
    with pytest.raises((RuntimeError, ValueError)):
        kscf_ibz_kernel(port)

"""Port k-point coupled cluster (cc/kccsd_blocked, krccsd, kccsd) == JAX
reference.

The momentum algebra (KAlgebra's tables, the einsum plans, the blocked
permutations, kein) is held on seeded random momentum-conserving tensors.
The three KCCSD tiers (composite, blocked spin-orbital, closed-shell
spatial), KUCCSD and the occupation padding run on one KRHF state per
cell, converged by the port on the CPU and handed to both packages with
the port's Bloch AOs (so SCF round-off does not enter). Cells: the H2
chain at 3x1x1 of tests/test_kccsd_blocked.py and the H2 chain at 2x1x1
of tests/test_kccsd_padding.py (with its rigid-band doped determinant).

Bars: tables exact, kein and the permutations 1e-12, the chunked kein
against the unchunked one 1e-14; energies 1e-10 Ha against the
reference; the tiers against each other at the reference tests' bars
(1e-9, and 1e-7 with padding); the first iteration against KMP2.
"""
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
import pyscf_isdf_tpu.cc  # noqa: E402,F401

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
import pyscf_isdf_tpu_torch.cc  # noqa: E402,F401
from pyscf_isdf_tpu_torch.mp.kmp2 import kmp2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_kscf_system, kscf_kernel  # noqa: E402

# each package's cc/__init__ exports the functions kccsd, kccsd_blocked and
# krccsd over their modules' names
kccsd, blk, krccsd, ref_kccsd, ref_blk, ref_krccsd = (
    sys.modules[f"{pkg}.cc.{m}"] for pkg in ("pyscf_isdf_tpu_torch", "pyscf_isdf_tpu")
    for m in ("kccsd", "kccsd_blocked", "krccsd"))
E_BAR = 1e-10
SPECS = ["mnef,ijef->mnij", "imae,mbej->ijab", "ijef,abef->ijab", "ia,jb->ijab",
         "mf,mafe->ae", "mnaf,mnef->ae", "ie,me->mi", "je,mnie->mnij",
         "ie,abej->ijab", "imae,me->ia", "ijab,ijab->", "ma,mi->ia"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _host(res):
    keys = ("mo_energy", "mo_coeff", "mo_occ")
    return {k: ([np.asarray(x) for x in v] if k in keys else v)
            for k, v in res.items() if k in keys + ("e_tot",)}


def _k_case(a, atoms, mesh, nkm):
    cell = build_cell(a, atoms, "gth-szv", pseudo="gth-pade", mesh=mesh)
    ref_cell = ref_build_cell(a, atoms, "gth-szv", pseudo="gth-pade", mesh=mesh)
    kpts = ref_lattice.make_kpts(cell.a, nkm)
    ksys = build_kscf_system(cell, kpts, device="cpu")
    res = kscf_kernel(ksys, xc=None, exxdiv="ewald", conv_tol=1e-11, device="cpu")
    assert res["converged"]
    ref = SimpleNamespace(cell=ref_cell, kpts=ksys.kpts, mesh=tuple(ksys.mesh),
                          weight=ksys.weight,
                          aoR_k=jnp.asarray(ksys.aoR_k.numpy()),
                          hcore=ksys.hcore.numpy())
    return SimpleNamespace(sys=ksys, ref=ref, res=_host(res))


@pytest.fixture(scope="module")
def h2_311():
    """tests/test_kccsd_blocked.py's complex 3x1x1 H2 chain; the three
    tiers of both packages on one KRHF state."""
    L = 6.0
    c = _k_case(np.array([[2.8, 0, 0], [0, L, 0], [0, 0, L]]),
                [["H", (0.0, L / 2, L / 2)], ["H", (1.3, L / 2, L / 2)]],
                [8, 16, 16], [3, 1, 1])
    c.comp = kccsd.kccsd(c.sys, c.res, with_t=True, conv_tol=1e-10, device="cpu")
    c.blk = blk.kccsd_blocked(c.sys, c.res, conv_tol=1e-10, device="cpu")
    c.r = krccsd.krccsd(c.sys, c.res, conv_tol=1e-10, device="cpu")
    return c


@pytest.fixture(scope="module")
def h2_chain():
    """tests/test_kccsd_padding.py's 2x1x1 H2 chain and its doped
    determinant (two more electrons in the conduction minimum)."""
    c = _k_case(np.diag([4.4, 12.0, 12.0]),
                [["H", (0.0, 0.0, 0.0)], ["H", (2.2, 0.0, 0.0)]], (12, 10, 10),
                [2, 1, 1])
    occ = np.array(c.res["mo_occ"], copy=True)
    mo_e = np.asarray(c.res["mo_energy"])
    lumo_k = int(np.argmin([mo_e[k][occ[k] < 0.5].min() for k in range(len(occ))]))
    occ[lumo_k, int(np.where(occ[lumo_k] < 0.5)[0][0])] = 2.0
    c.doped = dict(c.res, mo_occ=occ)
    assert len(set((occ > 0.5).sum(axis=1).tolist())) > 1
    return c


def _kalgebra(nkm=(2, 2, 2)):
    from pyscf_isdf_tpu_torch.models import diamond_primitive

    a = diamond_primitive(mesh=(8,) * 3).a
    kpts = ref_lattice.make_kpts(a, list(nkm))
    return blk.KAlgebra(a, kpts), ref_blk.KAlgebra(a, kpts)


def test_kalgebra_and_plan_tables():
    """The group tables, the fingerprint and every plan of the update
    program equal the reference's (2x2x2 and a 3x1x1 mesh)."""
    for nkm in ((2, 2, 2), (3, 1, 1)):
        ka, ka0 = _kalgebra(nkm)
        for name in ("ksub", "kadd", "kcons"):
            assert np.array_equal(getattr(ka, name), getattr(ka0, name))
        assert ka.fingerprint == ka0.fingerprint
        for spec in SPECS:
            ins, out = spec.split("->")
            shapes = tuple(len(t) == 2 for t in ins.split(",")) + (len(out) == 2,)
            p, p0 = blk._make_plan(spec, shapes, ka), ref_blk._make_plan(spec, shapes, ka0)
            assert (p.sub_exec, p.nout, p.ninner) == (p0.sub_exec, p0.nout, p0.ninner)
            assert all(np.array_equal(x, y) for x, y in zip(p.idx, p0.idx))
            assert (p.mask is None) == (p0.mask is None)
            assert p.mask is None or np.array_equal(p.mask, p0.mask)


def _rand(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("spec", SPECS)
def test_kein_and_chunks(spec):
    """kein on seeded random blocked tensors against the reference's, and
    the chunked outer grid (one block row a chunk) against one chunk."""
    ka, ka0 = _kalgebra()
    nk, rng = ka.nk, np.random.default_rng(3)
    ins, _ = spec.split("->")
    dims = [tuple(2 if x in "ijmn" else 3 for x in t) for t in ins.split(",")]
    ops = [_rand(rng, ((nk,) if len(d) == 2 else (nk, nk, nk)) + d) for d in dims]
    out = blk.kein(spec, *(torch.as_tensor(x) for x in ops), ka)
    ref = np.asarray(ref_blk.kein(spec, *(jnp.asarray(x) for x in ops), ka0))
    assert _rel(out.numpy(), ref) < 1e-12
    chunked = blk.kein(spec, *(torch.as_tensor(x) for x in ops), ka, max_bytes=1)
    assert np.abs((chunked - out).numpy()).max() <= 1e-14 * np.abs(ref).max()


def test_block_permutations_and_symmetrization():
    ka, ka0 = _kalgebra()
    nk, rng = ka.nk, np.random.default_rng(4)
    T = _rand(rng, (nk, nk, nk, 2, 3, 4, 5))
    for port, ref in ((blk._perm_last2, ref_blk._perm_last2),
                      (blk._perm_first2, ref_blk._perm_first2),
                      (blk._transpose_t2_to_vvoo, ref_blk._transpose_t2_to_vvoo)):
        assert np.array_equal(port(torch.as_tensor(T), ka).numpy(),
                              np.asarray(ref(jnp.asarray(T), ka0)))
    eri7 = _rand(rng, (nk, nk, nk, 3, 3, 3, 3))
    Vs = blk.symmetrized_phys_tensor(torch.as_tensor(eri7), ka, nk, 3)
    Vs0 = ref_blk.symmetrized_phys_tensor(eri7, ka0, nk, 3)
    assert np.array_equal(Vs.numpy(), Vs0)
    sp, sz = np.arange(6) // 2, np.arange(6) % 2
    B = blk._expand_spin_blocks(Vs, ka, nk, sp, sz, 2, 4)
    B0 = ref_blk._expand_spin_blocks(Vs0, ka0, nk, sp, sz, 2, 4)
    assert all(np.array_equal(B[k].numpy(), B0[k]) for k in B0)


def test_three_tiers(h2_311):
    """Composite, blocked and spatial KCCSD (and the composite (T)) equal
    the reference's on one KRHF state, and each other at 1e-9."""
    c = h2_311
    comp0 = ref_kccsd.kccsd(c.ref, c.res, with_t=True, conv_tol=1e-10)
    assert c.comp["converged"] and c.blk["converged"] and c.r["converged"]
    assert abs(c.comp["e_corr"] - comp0["e_corr"]) < E_BAR
    assert abs(c.comp["e_t"] - comp0["e_t"]) < E_BAR
    blk0 = ref_blk.kccsd_blocked(c.ref, c.res, conv_tol=1e-10)
    assert abs(c.blk["e_corr"] - blk0["e_corr"]) < E_BAR
    assert c.blk["niter"] == blk0["niter"]
    r0 = ref_krccsd.krccsd(c.ref, c.res, conv_tol=1e-10)
    assert abs(c.r["e_corr"] - r0["e_corr"]) < E_BAR and c.r["niter"] == r0["niter"]
    assert _rel(c.r["t2"].numpy(), r0["t2"]) < 1e-6
    assert abs(c.blk["e_corr"] - c.comp["e_corr"]) < 1e-9
    assert abs(c.r["e_corr"] - c.comp["e_corr"]) < 1e-9


def test_composite_integrals(h2_311):
    """The composite <PQ||RS> (complex: the guard is not vacuous) and h1."""
    c = h2_311
    f, eri, no = kccsd.build_composite_eris(c.sys, c.res, device="cpu")
    f0, eri0, no0 = ref_kccsd.build_composite_eris(c.ref, c.res)
    assert no == no0 and np.abs(f.numpy() - f0).max() == 0
    assert _rel(eri.numpy(), eri0) < 1e-12 and np.abs(eri0.imag).max() > 1e-4
    h1 = kccsd.composite_h1so(c.sys, c.res, device="cpu")
    assert _rel(h1.numpy(), ref_kccsd.composite_h1so(c.ref, c.res)) < 1e-12


def test_spatial_classes_and_mp2_start(h2_311):
    """krccsd's integral classes against the reference's, and its start
    energy (t1 = 0, t2 = MP2) against the reference's and KMP2's."""
    c = h2_311
    ka, B, eo, ev, no, nv = krccsd.build_spatial_eris(c.sys, c.res, device="cpu")
    ka0, B0, eo0, ev0, no0, nv0 = ref_krccsd.build_spatial_eris(c.ref, c.res)
    assert (no, nv) == (no0, nv0) and np.abs(eo - eo0).max() == 0
    for name in B0:
        for p in B0[name].c:
            assert _rel(B[name].c[p].numpy(), B0[name].c[p]) < 1e-12
    nk = ka.nk
    D1, D2 = blk.blocked_denominators(ka, eo, ev, "cpu")
    T0 = np.asarray(ref_blk._transpose_t2_to_vvoo(B0["vvoo"].c[ref_krccsd._PAB],
                                                  ka0)) / D2.numpy()
    e0 = ref_krccsd.sk_energy(
        ref_krccsd.SK({(0, 0): jnp.zeros((nk, no, nv), dtype=complex)}),
        ref_krccsd._t2_from_mixed(jnp.asarray(T0), ka0), B0["oovv"], ka0) / nk
    assert abs(c.r["e_mp2"] - e0) < E_BAR
    # KMP2 reads the raw grid ERIs, the CC tiers their bra/ket-symmetrized
    # projection: the two start energies part at second order in the
    # asymmetry, 1.5e-8 Ha on this coarse 8x16x16 mesh
    assert abs(c.r["e_mp2"] - kmp2_energy(c.sys, c.res, device="cpu")) < 1e-7


def test_padding(h2_chain):
    """Non-uniform occupation: blocked == composite (1e-7, the reference's
    bar), both == the reference's, and uniform padding is a no-op."""
    c = h2_chain
    out_c = kccsd.kccsd(c.sys, c.doped, conv_tol=1e-11, device="cpu")
    out_b = blk.kccsd_blocked(c.sys, c.doped, conv_tol=1e-11, device="cpu")
    assert out_c["converged"] and out_b["converged"]
    assert abs(out_b["e_corr"] - out_c["e_corr"]) < 1e-7 and out_b["e_corr"] < -1e-4
    ref_b = ref_blk.kccsd_blocked(c.ref, c.doped, conv_tol=1e-11)
    assert abs(out_b["e_corr"] - ref_b["e_corr"]) < E_BAR
    uni_b = blk.kccsd_blocked(c.sys, c.res, conv_tol=1e-11, device="cpu")
    uni_c = kccsd.kccsd(c.sys, c.res, conv_tol=1e-11, device="cpu")
    assert abs(uni_b["e_corr"] - uni_c["e_corr"]) < 1e-9
    with pytest.raises(NotImplementedError, match="uniform"):
        krccsd.krccsd(c.sys, c.doped, device="cpu")


def test_kuccsd(h2_chain):
    """KUCCSD (composite and blocked) on identical spin channels carrying
    the non-uniform fill: == the reference's, == restricted blocked."""
    c = h2_chain
    occ = np.asarray(c.doped["mo_occ"])
    res_u = dict(c.doped, mo_coeff=(c.doped["mo_coeff"],) * 2,
                 mo_energy=(c.doped["mo_energy"],) * 2, mo_occ=(occ / 2, occ / 2))
    u_c = kccsd.kuccsd(c.sys, res_u, conv_tol=1e-11, with_t=True, device="cpu")
    u_b = blk.kuccsd_blocked(c.sys, res_u, conv_tol=1e-11, device="cpu")
    u_b0 = ref_blk.kuccsd_blocked(c.ref, res_u, conv_tol=1e-11)
    u_c0 = ref_kccsd.kuccsd(c.ref, res_u, conv_tol=1e-11, with_t=True)
    assert abs(u_b["e_corr"] - u_b0["e_corr"]) < E_BAR
    assert abs(u_c["e_corr"] - u_c0["e_corr"]) < E_BAR
    assert abs(u_c["e_t"] - u_c0["e_t"]) < E_BAR
    r = blk.kccsd_blocked(c.sys, c.doped, conv_tol=1e-11, device="cpu")
    assert abs(u_c["e_corr"] - r["e_corr"]) < 1e-7
    assert abs(u_b["e_corr"] - r["e_corr"]) < 1e-7


def test_k_entry_points_need_cuda(h2_chain, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = h2_chain
    for fn in (kccsd.kccsd, kccsd.kuccsd, kccsd.build_composite_eris,
               kccsd.composite_h1so, blk.kccsd_blocked, blk.kuccsd_blocked,
               krccsd.krccsd, krccsd.build_spatial_eris):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(c.sys, c.res)

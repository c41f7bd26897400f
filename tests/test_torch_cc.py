"""Port coupled cluster at Gamma (cc/gccsd, fci, cisd, eom, density, adc)
== JAX reference.

One SCF state per cell, converged by the port on the CPU, goes to both
packages: its orbitals and energies, and its grid arrays in a namespace
the reference's functions read (so SCF round-off does not enter). The
algebra is held on seeded random inputs. Cells: the two-electron Be cell
and the H4 chain of tests/test_ccsd.py, the H2 triplet of
tests/test_kuccsd.py.

Bars: spin expansion, one amplitude update, the EOM sigma against
jax.jvp, matrices 1e-12 (relative to the largest element); energies,
roots, pole strengths and densities 1e-10 Ha; the reference tests'
structural identities (two-electron CCSD == FCI, the first iteration ==
MP2, ADC's Koopmans limit and fold identity) on the port's side.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu.cc import adc as ref_adc  # noqa: E402
import sys  # noqa: E402
from pyscf_isdf_tpu.cc import density as ref_density  # noqa: E402
from pyscf_isdf_tpu.cc import eom as ref_eom  # noqa: E402
from pyscf_isdf_tpu.cc import fci as ref_fci  # noqa: E402
from pyscf_isdf_tpu.cc import gccsd as ref_gccsd  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.cc import adc, density, eom, fci, gccsd  # noqa: E402
from pyscf_isdf_tpu_torch.convert import isdf_from_numpy, scf_result_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.df import isdf as isdf_mod  # noqa: E402
from pyscf_isdf_tpu_torch.mp import mp2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system, scf_kernel, uhf_kernel  # noqa: E402

# the package's __init__ exports the function cisd over the module's name
cisd = sys.modules["pyscf_isdf_tpu_torch.cc.cisd"]
ref_cisd = sys.modules["pyscf_isdf_tpu.cc.cisd"]
E_BAR = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else (None if x is None else np.asarray(x))


def _ref_system(sys_):
    """The port's Gamma arrays in the shape the reference's functions read."""
    return SimpleNamespace(cell=sys_.cell, aoR=jnp.asarray(sys_.aoR.numpy()),
                           coulG=sys_.coulG.numpy(), mesh=tuple(sys_.mesh),
                           weight=sys_.weight, nelec=sys_.nelec,
                           hcore=sys_.hcore.numpy(), e_nuc=sys_.e_nuc)


def _host(res):
    def h(x):
        return tuple(h(y) for y in x) if isinstance(x, tuple) else _np(x)
    return {k: (h(v) if k in ("mo_energy", "mo_coeff", "mo_occ") else v)
            for k, v in res.items() if k in ("mo_energy", "mo_coeff", "mo_occ",
                                             "e_tot", "nelec")}


def _case(cell):
    sys_ = build_scf_system(cell, device="cpu")
    res = _host(scf_kernel(sys_, xc=None, exxdiv=None, conv_tol=1e-12))
    mo = torch.as_tensor(res["mo_coeff"])
    h1so, eri_so = gccsd.spinorb_from_spatial(mo.T @ sys_.hcore @ mo,
                                              gccsd._mo_eri_gamma(sys_, mo))
    return SimpleNamespace(sys=sys_, ref=_ref_system(sys_), res=res,
                           h1so=h1so.numpy(), eri=eri_so.numpy())


@pytest.fixture(scope="module")
def be():
    """tests/test_ccsd.py's two-electron Be cell, with the port's CCSD(T)
    and the reference's on the same state."""
    L = 7.0
    a = L * np.eye(3)
    a[1, 0] = 5.0
    c = _case(build_cell(a, [["Be", (L / 2, L / 2, L / 2)]], basis="gth-szv",
                         pseudo="gth-pade-q2", mesh=[12] * 3))
    c.out = gccsd.ccsd(c.sys, c.res, with_t=True, conv_tol=1e-12, device="cpu")
    c.ref_out = ref_gccsd.ccsd(c.ref, c.res, with_t=True, conv_tol=1e-12)
    return c


@pytest.fixture(scope="module")
def h4():
    L = 8.0
    c = _case(build_cell(np.eye(3) * L,
                         [["H", (L / 2 - 1.8, L / 2, L / 2)],
                          ["H", (L / 2 - 0.6, L / 2, L / 2)],
                          ["H", (L / 2 + 0.7, L / 2, L / 2)],
                          ["H", (L / 2 + 1.9, L / 2, L / 2)]],
                         basis="gth-szv", pseudo="gth-pade", mesh=[14] * 3))
    c.out = gccsd.ccsd(c.sys, c.res, with_t=True, conv_tol=1e-11, device="cpu")
    c.ref_out = ref_gccsd.ccsd(c.ref, c.res, with_t=True, conv_tol=1e-11)
    mo_e = c.res["mo_energy"]
    c.f = np.diag(np.repeat(mo_e, 2))
    c.t1, c.t2 = np.asarray(c.ref_out["t1"]), np.asarray(c.ref_out["t2"])
    return c


def _random_asym(rng, n, complex_=False):
    V = rng.standard_normal((n,) * 4)
    if complex_:
        V = V + 1j * rng.standard_normal((n,) * 4)
    V = V - V.transpose(0, 1, 3, 2)
    V = V - V.transpose(1, 0, 2, 3)
    return 0.5 * (V + V.transpose(2, 3, 0, 1).conj())


def test_spinorb_from_spatial():
    rng = np.random.default_rng(0)
    h1 = rng.standard_normal((5, 5))
    eri = rng.standard_normal((5,) * 4)
    h, e = gccsd.spinorb_from_spatial(torch.as_tensor(h1), torch.as_tensor(eri))
    h0, e0 = ref_gccsd.spinorb_from_spatial(h1, eri)
    assert np.abs(h.numpy() - h0).max() == 0.0
    assert _rel(e.numpy(), e0) < 1e-12


@pytest.mark.parametrize("complex_", [False, True])
def test_one_update_and_energy(complex_):
    """One Stanton update and the energy on a seeded random problem (a
    complex Hermitian Fock with off-diagonal blocks)."""
    rng = np.random.default_rng(1)
    no, nv = 3, 4
    n = no + nv
    f = rng.standard_normal((n, n)) + (1j * rng.standard_normal((n, n))
                                       if complex_ else 0)
    f = 0.1 * (f + f.conj().T) + np.diag(np.r_[-np.arange(1, no + 1), np.arange(1, nv + 1)])
    eri = 0.1 * _random_asym(rng, n, complex_)
    dt = complex if complex_ else float
    t1 = (0.05 * rng.standard_normal((no, nv))).astype(dt)
    t2 = 0.05 * rng.standard_normal((no, no, nv, nv)).astype(dt)
    t2 = t2 - t2.transpose(1, 0, 2, 3)
    t2 = t2 - t2.transpose(0, 1, 3, 2)
    a = gccsd._update(*(torch.as_tensor(x) for x in (t1, t2, f, eri)), no)
    b = ref_gccsd._update(*(jnp.asarray(x) for x in (t1, t2, f, eri)), no)
    for x, y in zip(a, b):
        assert _rel(x.numpy(), y) < 1e-12
    e = float(gccsd.energy(*(torch.as_tensor(x) for x in (t1, t2, f, eri)), no))
    e0 = float(ref_gccsd.energy(*(jnp.asarray(x) for x in (t1, t2, f, eri)), no))
    assert abs(e - e0) < 1e-13


def test_ccsd_two_electrons_is_fci(be):
    """2-electron CCSD == FCI (port), == the reference's CCSD, E(T) == 0."""
    out, ref = be.out, be.ref_out
    assert out["converged"] and out["niter"] == ref["niter"]
    assert abs(out["e_corr"] - ref["e_corr"]) < E_BAR
    (e_fci,), n = fci.fci_ground_state(be.h1so, be.eri, be.sys.nelec)
    (e_ref,), n_ref = ref_fci.fci_ground_state(be.h1so, be.eri, be.sys.nelec)
    assert n == n_ref and abs(e_fci - e_ref) < E_BAR
    assert abs(be.res["e_tot"] + out["e_corr"] - (e_fci + be.sys.e_nuc)) < 1e-12
    assert out["e_t"] == 0.0 and ref["e_t"] == 0.0


def test_first_iteration_is_mp2(be):
    mo_e = be.res["mo_energy"]
    no = be.sys.nelec
    f = torch.as_tensor(np.diag(np.repeat(mo_e, 2)))
    eri = torch.as_tensor(be.eri)
    t1, t2 = gccsd._mp2_start(f, eri, no)
    e = float(gccsd.energy(t1, t2, f, eri, no))
    assert abs(e - mp2_energy(be.sys, be.res, device="cpu")) < E_BAR


def test_ccsd_t_h4(h4):
    out, ref = h4.out, h4.ref_out
    assert out["converged"] and out["niter"] == ref["niter"]
    assert abs(out["e_corr"] - ref["e_corr"]) < E_BAR
    assert abs(out["e_t"] - ref["e_t"]) < E_BAR
    assert _rel(out["t2"].numpy(), ref["t2"]) < 1e-7
    (e_fci,), _ = fci.fci_ground_state(h4.h1so, h4.eri, h4.sys.nelec)
    d_ccsd = h4.res["e_tot"] + out["e_corr"] - e_fci - h4.sys.e_nuc
    assert abs(d_ccsd) < 5e-5 and abs(d_ccsd + out["e_t"]) < abs(d_ccsd)
    # (T) on the reference's amplitudes, carried to the port
    e_t = gccsd.ccsd_t(torch.as_tensor(h4.t1), torch.as_tensor(h4.t2),
                       h4.f, h4.eri, h4.sys.nelec)
    assert abs(e_t - ref["e_t"]) < 1e-13


def test_thc_ccsd(h4):
    """THC integrals and THC-CCSD on one ISDF factorization (the port's,
    carried to the reference)."""
    s = h4.sys
    fac = isdf_mod.build_isdf(s.aoR, s.coulG, s.mesh, s.weight, c=20)
    ref_fac = SimpleNamespace(aoRg=jnp.asarray(fac.aoRg.numpy()), W=fac.W.numpy())
    same = isdf_from_numpy(fac.aoRg.numpy(), fac.W.numpy(), fac.ip_idx.numpy(),
                           device="cpu")
    eri = gccsd.thc_mo_eri(same, h4.res["mo_coeff"])
    assert _rel(eri.numpy(), ref_gccsd.thc_mo_eri(ref_fac, h4.res["mo_coeff"])) < 1e-12
    thc = gccsd.ccsd(s, h4.res, conv_tol=1e-11, isdf=same, device="cpu")
    ref = ref_gccsd.ccsd(h4.ref, h4.res, conv_tol=1e-11, isdf=ref_fac)
    assert thc["converged"] and abs(thc["e_corr"] - ref["e_corr"]) < E_BAR
    assert abs(thc["e_corr"] - h4.out["e_corr"]) < 1e-6


def test_uccsd_triplet_is_sector_fci():
    """tests/test_kuccsd.py's H2 triplet: UCCSD == the reference's and ==
    the Sz = 1 FCI; the UHF basis and antisymmetrization on the way."""
    L = 8.0
    cell = build_cell(np.eye(3) * L, [["H", (L / 2 - 0.8, L / 2, L / 2)],
                                      ["H", (L / 2 + 0.8, L / 2, L / 2)]],
                      basis="gth-dzvp", pseudo="gth-pade", mesh=[16] * 3, spin=2)
    s = build_scf_system(cell, device="cpu")
    res = _host(uhf_kernel(s, xc=None, exxdiv=None, conv_tol=1e-12))
    out = gccsd.uccsd(s, res, conv_tol=1e-12, with_t=True, device="cpu")
    ref = ref_gccsd.uccsd(_ref_system(s), res, conv_tol=1e-12, with_t=True)
    assert out["converged"] and abs(out["e_corr"] - ref["e_corr"]) < E_BAR
    assert 1e-4 < abs(out["e_corr"]) < 1e-1 and abs(out["e_t"]) < 1e-14

    C, e_so, sz, nocc = gccsd.uhf_spinorb_basis(res["mo_coeff"], res["mo_energy"],
                                                res["nelec"])
    C0, e0, sz0, nocc0 = ref_gccsd.uhf_spinorb_basis(res["mo_coeff"], res["mo_energy"],
                                                     res["nelec"])
    assert np.abs(C.numpy() - C0).max() == 0 and np.array_equal(sz, sz0)
    assert nocc == nocc0 and np.abs(e_so.numpy() - e0).max() == 0
    chem = gccsd._mo_eri_gamma(s, C)
    eri = gccsd.antisymmetrize_spin_chem(chem, sz)
    assert _rel(eri.numpy(), ref_gccsd.antisymmetrize_spin_chem(chem.numpy(), sz)) < 1e-12
    h1so = (C.T @ s.hcore @ C).numpy() * (sz[:, None] == sz[None, :])
    (e_fci,), ndet = fci.fci_ground_state(h1so, eri, s.nelec, sz_labels=sz,
                                          target_2sz=2)
    (e_ref,), _ = ref_fci.fci_ground_state(h1so, eri.numpy(), s.nelec,
                                           sz_labels=sz, target_2sz=2)
    assert ndet == 45 and abs(e_fci - e_ref) < E_BAR
    assert abs(out["e_tot"] - (e_fci + s.e_nuc)) < 1e-12


def test_fci_and_cisd(h4):
    from itertools import combinations

    dets = list(combinations(range(h4.eri.shape[0]), 4))[::7]
    H = fci.build_hamiltonian(h4.h1so, h4.eri, dets)
    assert _rel(H.numpy(), ref_fci.build_hamiltonian(h4.h1so, h4.eri, dets)) < 1e-12
    w, n = fci.fci_ground_state(h4.h1so, h4.eri, 4, nroots=3)
    w0, n0 = ref_fci.fci_ground_state(h4.h1so, h4.eri, 4, nroots=3)
    assert n == n0 and np.abs(w - w0).max() < E_BAR
    wc, nc = cisd.cisd_ground_state(h4.h1so, h4.eri, 4, nroots=2)
    wc0, nc0 = ref_cisd.cisd_ground_state(h4.h1so, h4.eri, 4, nroots=2)
    assert nc == nc0 and np.abs(wc - wc0).max() < E_BAR
    assert cisd.cisd_determinants(8, 4) == ref_cisd.cisd_determinants(8, 4)
    e_corr, e_tot = cisd.cisd(h4.sys, h4.res, device="cpu")
    e_corr0, e_tot0 = ref_cisd.cisd(h4.ref, h4.res)
    assert abs(e_corr - e_corr0) < E_BAR and abs(e_tot - e_tot0) < E_BAR
    # variational: E_HF > E_CISD > E_FCI
    assert 0 > e_corr > w[0] + h4.sys.e_nuc - h4.res["e_tot"]


@pytest.mark.parametrize("sector", ["ee", "ip", "ea"])
def test_eom_determinant_oracle(be, h4, sector):
    for c in (be, h4):
        t1, t2 = np.asarray(c.ref_out["t1"]), np.asarray(c.ref_out["t2"])
        w = eom.eom_ccsd(c.h1so, c.eri, t1, t2, c.sys.nelec, sector=sector, nroots=6)
        w0 = ref_eom.eom_ccsd(c.h1so, c.eri, t1, t2, c.sys.nelec, sector=sector,
                              nroots=6)
        assert np.abs(w - w0).max() < E_BAR
    # the exact transform from the reference's amplitudes: EOM == FCI for
    # two electrons in EE, and the lowest EE root is the CCSD ground state
    if sector == "ee":
        from itertools import combinations
        nso = be.eri.shape[0]
        dets = list(combinations(range(nso), 2))
        w_fci = np.linalg.eigvalsh(fci.build_hamiltonian(be.h1so, be.eri, dets).numpy())
        w = eom.eom_ccsd(be.h1so, be.eri, np.asarray(be.ref_out["t1"]),
                         np.asarray(be.ref_out["t2"]), 2, nroots=len(dets))
        assert np.abs(np.sort(w) - w_fci).max() < 1e-9
        e_cc = be.res["e_tot"] - be.sys.e_nuc + be.out["e_corr"]
        assert abs(w.min() - e_cc) < 1e-9
    ips = eom.eom_from_scf(be.sys, be.res, be.out, sector=sector, nroots=2,
                           device="cpu")
    ips0 = ref_eom.eom_from_scf(be.ref, be.res, be.ref_out, sector=sector, nroots=2)
    assert np.abs(ips - ips0).max() < E_BAR


def test_eom_sigma_against_jax_jvp(h4):
    """The sigma (torch.func.jvp through the update) against jax.jvp on
    seeded tangents, and batched (vmap) against one at a time."""
    no = h4.sys.nelec
    rng = np.random.default_rng(2)
    r1 = rng.standard_normal(h4.t1.shape)
    r2 = rng.standard_normal(h4.t2.shape)
    sigma, _, _, _ = eom._make_sigma(h4.f, h4.eri, h4.t1, h4.t2, no)
    s1, s2 = sigma(torch.as_tensor(r1), torch.as_tensor(r2))
    ref_sigma, _, _ = ref_eom._make_sigma(h4.f, h4.eri, h4.t1, h4.t2, no)
    j1, j2 = ref_sigma(jnp.asarray(r1), jnp.asarray(r2))
    assert _rel(s1.numpy(), j1) < 1e-12 and _rel(s2.numpy(), j2) < 1e-12
    b1, b2 = sigma.batched(torch.as_tensor(np.stack([r1, 2 * r1])),
                           torch.as_tensor(np.stack([r2, 2 * r2])))
    assert _rel(b1[1].numpy(), 2 * s1.numpy()) < 1e-14
    assert _rel(b2[0].numpy(), s2.numpy()) < 1e-14
    A = eom.eom_ee_jacobian(h4.f, h4.eri, h4.t1, h4.t2, no)
    pack, unpack, dim = eom._packers(4, 4, torch.float64, "cpu")
    assert A.shape == (dim, dim)
    v = torch.as_tensor(rng.standard_normal(dim))
    assert _rel((A @ v).numpy(), pack(*sigma(*unpack(v))).numpy()) < 1e-12


def test_eom_ee_energies(h4):
    """Dense Jacobian roots == the reference's; the Arnoldi roots (plain
    and shift-invert) each on a reference root. ARPACK's start vector is
    random and the roots come in spin multiplets, so the iterative solvers
    of the two packages may return different copies of a multiplet."""
    no = h4.sys.nelec
    w = eom.eom_ee_energies(h4.f, h4.eri, h4.t1, h4.t2, no, nroots=6)
    w0 = ref_eom.eom_ee_energies(h4.f, h4.eri, h4.t1, h4.t2, no, nroots=6)
    assert np.abs(w - w0).max() < E_BAR

    def on_ref_roots(x):
        return np.abs(x[:, None] - w0[None, :]).min(axis=1).max() < E_BAR

    wi = eom.eom_ee_iterative(h4.f, h4.eri, h4.t1, h4.t2, no, nroots=3)
    wi0 = ref_eom.eom_ee_iterative(h4.f, h4.eri, h4.t1, h4.t2, no, nroots=3)
    assert on_ref_roots(wi) and on_ref_roots(wi0) and abs(wi[0] - wi0[0]) < E_BAR
    # shift-invert about an interior root
    wt = eom.eom_ee_iterative(h4.f, h4.eri, h4.t1, h4.t2, no, nroots=2,
                              target=w0[4] + 1e-3)
    assert on_ref_roots(wt) and np.abs(wt - w0[4]).min() < E_BAR


@pytest.mark.parametrize("sector", ["ip", "ea"])
def test_eom_ip_ea(h4, sector):
    """The continuum-orbital IP/EA (Arnoldi) with pole strengths; the small
    dense path on the two-electron cell; the bare-orbital limit."""
    no = h4.sys.nelec
    w, qp, r1s = eom.eom_ip_ea_energies(h4.f, h4.eri, h4.t1, h4.t2, no,
                                        sector=sector, nroots=3,
                                        return_weights=True)
    w0, qp0, r10 = ref_eom.eom_ip_ea_energies(h4.f, h4.eri, h4.t1, h4.t2, no,
                                              sector=sector, nroots=3,
                                              return_weights=True)
    assert np.abs(w - w0).max() < E_BAR and np.abs(qp - qp0).max() < E_BAR
    # the orbital-resolved strengths sum to the pole strength (the roots
    # are spin-degenerate pairs, so r1 itself is one of many in its pair)
    assert np.abs((np.abs(r1s) ** 2).sum(axis=1) - qp).max() < 1e-12
    rng = np.random.default_rng(7)
    nso, nb = 8, 4
    e = np.r_[np.sort(rng.uniform(-2.0, -0.5, nb)), np.sort(rng.uniform(0.3, 2.0, nso - nb))]
    ref_e = -e[:nb][::-1] if sector == "ip" else e[nb:]
    wb, qb, _ = eom.eom_ip_ea_energies(np.diag(e), np.zeros((nso,) * 4),
                                       np.zeros((nb, nso - nb)),
                                       np.zeros((nb, nb, nso - nb, nso - nb)), nb,
                                       sector=sector, nroots=2, return_weights=True)
    assert np.abs(np.sort(wb) - np.sort(ref_e[:2])).max() < 1e-10
    assert np.abs(qb - 1.0).max() < 1e-10


def test_rdm1(be, h4):
    """The response density == the reference's; == FCI for two electrons."""
    for c in (be, h4):
        t1, t2 = np.asarray(c.ref_out["t1"]), np.asarray(c.ref_out["t2"])
        g = density.ccsd_rdm1(c.h1so, c.eri, t1, t2, c.sys.nelec)
        g0 = ref_density.ccsd_rdm1(c.h1so, c.eri, t1, t2, c.sys.nelec)
        assert np.abs(g.numpy() - g0).max() < E_BAR
        gf = density.fci_rdm1(c.h1so, c.eri, c.sys.nelec)
        gf0 = ref_density.fci_rdm1(c.h1so, c.eri, c.sys.nelec)
        assert np.abs(gf.numpy() - gf0).max() < E_BAR
        assert abs(float(torch.trace(g)) - c.sys.nelec) < 1e-10
    gb = density.ccsd_rdm1(be.h1so, be.eri, be.out["t1"], be.out["t2"], 2)
    assert np.abs((gb - density.fci_rdm1(be.h1so, be.eri, 2)).numpy()).max() < 1e-9


def test_adc2(h4):
    no = h4.sys.nelec
    e_so = np.repeat(h4.res["mo_energy"], 2)
    eo, ev = e_so[:no], e_so[no:]
    for port, ref in ((adc.ip_adc2_matrix, ref_adc.ip_adc2_matrix),
                      (adc.ea_adc2_matrix, ref_adc.ea_adc2_matrix)):
        assert _rel(port(eo, ev, h4.eri).numpy(), ref(eo, ev, h4.eri)) < 1e-12
    for port, ref in ((adc.ip_adc2, ref_adc.ip_adc2), (adc.ea_adc2, ref_adc.ea_adc2)):
        assert np.abs(port(eo, ev, h4.eri, 3) - ref(eo, ev, h4.eri, 3)).max() < E_BAR
    ip, ea = adc.adc2_from_scf(h4.sys, h4.res, device="cpu")
    ip0, ea0 = ref_adc.adc2_from_scf(h4.ref, h4.res)
    assert np.abs(ip - ip0).max() < E_BAR and np.abs(ea - ea0).max() < E_BAR


def test_adc2_koopmans_and_fold():
    """tests/test_adc.py's identities on the port: zero integrals give the
    bare orbital energies; the fold equals the 2h1p self-energy."""
    rng = np.random.default_rng(0)
    eo = -np.sort(rng.uniform(0.3, 2.0, size=4))[::-1]
    ev = np.sort(rng.uniform(0.1, 1.5, size=6))
    V = np.zeros((10,) * 4)
    assert np.abs(np.sort(adc.ip_adc2(eo, ev, V, 4)) - np.sort(-eo)).max() < 1e-14
    assert np.abs(np.sort(adc.ea_adc2(eo, ev, V, 6)) - np.sort(ev)).max() < 1e-14
    rng = np.random.default_rng(1)
    no, nv = 3, 4
    eo = -np.sort(rng.uniform(0.3, 2.0, size=no))[::-1]
    ev = np.sort(rng.uniform(0.1, 1.5, size=nv))
    V = rng.normal(size=(no + nv,) * 4)
    V = V - V.transpose(0, 1, 3, 2)
    V = V - V.transpose(1, 0, 2, 3)
    V = 0.5 * (V + V.transpose(2, 3, 0, 1))
    A = adc.ip_adc2_matrix(eo, ev, V).numpy()
    U, D, E = A[:no, no:], np.diag(A[no:, no:]), -0.123
    fold = (U / (E - D)[None, :]) @ U.conj().T
    Vovoo = V[:no, no:, :no, :no]
    ref = 0.5 * np.einsum("iakl,jakl,akl->ij", Vovoo, Vovoo.conj(),
                          1.0 / (E + ev[:, None, None] - eo[None, :, None]
                                 - eo[None, None, :]))
    assert np.abs(fold - ref).max() < 1e-12


def test_jax_scf_result_to_port_and_no_cuda(be, monkeypatch):
    """A JAX SCF result carried into the port (convert.scf_result_from_numpy)
    gives the reference's CCSD on it; every cc entry point that takes a
    system defaults to CUDA and raises without it."""
    from pyscf_isdf_tpu import build_cell as ref_build_cell
    from pyscf_isdf_tpu.scf import build_scf_system as ref_build, scf_kernel as ref_scf

    L = 7.0
    a = L * np.eye(3)
    a[1, 0] = 5.0
    ref_sys = ref_build(ref_build_cell(a, [["Be", (L / 2, L / 2, L / 2)]],
                                       basis="gth-szv", pseudo="gth-pade-q2",
                                       mesh=[12] * 3))
    jres = ref_scf(ref_sys, xc=None, exxdiv=None, conv_tol=1e-12)
    res = scf_result_from_numpy(jres, device="cpu")
    assert torch.is_tensor(res["mo_coeff"]) and res["e_tot"] == jres["e_tot"]
    out = gccsd.ccsd(be.sys, res, conv_tol=1e-12, device="cpu")
    ref = ref_gccsd.ccsd(ref_sys, jres, conv_tol=1e-12)
    assert abs(out["e_corr"] - ref["e_corr"]) < E_BAR
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (lambda: gccsd.ccsd(be.sys, res), lambda: gccsd.uccsd(be.sys, res),
               lambda: cisd.cisd(be.sys, res), lambda: adc.adc2_from_scf(be.sys, res),
               lambda: eom.eom_from_scf(be.sys, res, out)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()

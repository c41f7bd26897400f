"""Port GW and RPA (gw/) == JAX reference.

The cells and ground states of the reference's tests (tests/test_gw.py,
tests/test_gw_rsh.py, tests/test_ugw.py): the diamond primitive cell on
12^3 (LDA and HF, a 1x1x1 and a 2x1x1 k-mesh, closed-shell UKS and KUKS),
the same cell on 14^3 with HSE06, and the H3 radical chain. Each system is
the reference's, built once a module and carried into the port
(``convert``); each SCF is the port's on it, and both packages take the
same converged state, and, where the reference's function takes one, the
reference's own MO-basis fit tensor, so GW parity rests neither on two
SCFs nor on two GDF fits. All float64 on the CPU.

Bars: Sigma(iw) and the chunked W, Pi and Sigma pieces 1e-12 relative to
the largest entry (also with a budget that forces one frequency a chunk
and column blocks); QP energies and correlation energies 1e-8 Ha; the
Cholesky log-determinant RPA against the reference's eigvalsh form
1e-10 Ha; then the reference tests' own physics bars on the port's
numbers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell, lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.gw import gw_cd as ref_cd, gw_exact as ref_exact  # noqa: E402
from pyscf_isdf_tpu.gw import krgw as ref_krgw, rgw as ref_rgw, ugw as ref_ugw  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.scf.hf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_kbuild  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.convert import (  # noqa: E402
    kscf_system_from_numpy, lmo_from_numpy, system_from_numpy)
from pyscf_isdf_tpu_torch.df import fftdf  # noqa: E402
from pyscf_isdf_tpu_torch.gw import gw_cd, gw_exact, krgw, rgw, ugw  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.scf import kscf_kernel, kuhf_kernel, scf_kernel, uhf_kernel  # noqa: E402

REL = 1e-12       # chunked pieces against the reference's batched ones
QP = 1e-8         # QP energies, Ha
EC = 1e-8         # correlation energies, Ha
LOGDET = 1e-10    # Cholesky log-det RPA against the eigvalsh form, Ha


def _cell_key(cell):
    return (np.asarray(cell.a).tobytes(), np.asarray(cell.coords).tobytes(),
            tuple(cell.symbols), tuple(cell.mesh), cell.nao)


@pytest.fixture(scope="module", autouse=True)
def compiled_and_shared():
    """Module-wide: each package's GDF fits of one cell share its auxiliary
    basis on the grid (seconds a collocation on the CPU), and the
    reference's closed-shell and spin XC run under one jax.jit a functional
    (eager autodiff otherwise)."""
    import jax

    from pyscf_isdf_tpu.ops import ao_eval as ref_ao_eval, xc as ref_xc
    from pyscf_isdf_tpu_torch.df import gdf

    plain, cache = gdf.collocate_aux, {}

    def cached(cell, auxcell, device, timer=None):
        key = _cell_key(auxcell) + (str(device),)
        if key not in cache:
            cache[key] = plain(cell, auxcell, device, timer)
        return cache[key]

    ref_plain, ref_cache = ref_ao_eval.eval_ao_numpy, {}

    def ref_cached(cell, *a, **k):
        if a or k:
            return ref_plain(cell, *a, **k)
        key = _cell_key(cell)
        if key not in ref_cache:
            ref_cache[key] = ref_plain(cell)
        return ref_cache[key]

    def top_level_jit(fn):
        """fn under one jit (self static) when called with arrays, as is
        inside the reference's own traces."""
        jitted = jax.jit(fn, static_argnums=0,
                         compiler_options={"xla_backend_optimization_level": 0})
        return lambda self, *a: (fn(self, *a) if any(isinstance(x, jax.core.Tracer)
                                                     for x in a) else jitted(self, *a))

    spin, closed = ref_xc.XCSpec.exc_vxc_spin, ref_xc.XCSpec.exc_vxc
    gdf.collocate_aux = cached
    ref_ao_eval.eval_ao_numpy = ref_cached
    ref_xc.XCSpec.exc_vxc_spin = top_level_jit(spin)
    ref_xc.XCSpec.exc_vxc = top_level_jit(closed)
    yield
    gdf.collocate_aux = plain
    ref_ao_eval.eval_ao_numpy = ref_plain
    ref_xc.XCSpec.exc_vxc_spin = spin
    ref_xc.XCSpec.exc_vxc = closed


def _port_system(cell, ref_sys):
    return system_from_numpy(cell, ref_sys.S, ref_sys.hcore, ref_sys.X,
                             np.asarray(ref_sys.aoR), ref_sys.coulG, ref_sys.madelung,
                             ref_sys.e_nuc, device="cpu")


def _port_ksystem(cell, kpts, ref):
    return kscf_system_from_numpy(cell, kpts, ref.S, ref.hcore, ref.X,
                                  np.asarray(ref.aoR_k), ref.coulG, ref.coulG_pairs,
                                  ref.expmikr, ref.madelung, ref.e_nuc, device="cpu")


def _np(res):
    """A port SCF result with its tensors as numpy arrays (the reference's
    input)."""
    def conv(v):
        if isinstance(v, (tuple, list)):
            return tuple(conv(x) for x in v)
        return v.numpy() if torch.is_tensor(v) else v
    return {k: conv(v) for k, v in res.items()}


def _states(sys_, run, xcs, **kw):
    """{xc: (reference's input, port's result)} of the port's SCFs."""
    out = {}
    for xc in xcs:
        res = run(sys_, xc=xc, **kw)
        assert res["converged"]
        out[xc] = (_np(res), res)
    return out


_REF = {}


def _ref_once(key, fn):
    """The reference's value of ``key``, computed once a module (the
    chunk-budget cases share it)."""
    if key not in _REF:
        _REF[key] = fn()
    return _REF[key]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _ref_lmo_k(ref_sys, res):
    return [[np.asarray(x) for x in row]
            for row in ref_krgw.build_lmo_kpts(ref_sys, res["mo_coeff"])]


@pytest.fixture(scope="module")
def lda12():
    """Diamond 12^3: the reference's system, the port's on its arrays, the
    port's LDA and HF states and the reference's MO fit tensors of them."""
    ref_sys = ref_build(ref_diamond(mesh=(12,) * 3))
    sys_ = _port_system(diamond_primitive(mesh=(12,) * 3), ref_sys)
    out = {"ref_sys": ref_sys, "sys": sys_}
    for name, (res, pres) in zip(("lda", "hf"),
                                 _states(sys_, scf_kernel, ("lda,vwn", None)).values()):
        L = np.asarray(ref_rgw.build_lmo(ref_sys, res["mo_coeff"]))
        out[name] = (res, pres, L, lmo_from_numpy(L, "cpu"))
    return out


@pytest.fixture(scope="module")
def lda_runs(lda12):
    """G0W0-AC (each package's), the oracle and the RPA quadrature on the
    12^3 LDA state, computed once for the tests that read them."""
    res, pres, L, Lt = lda12["lda"]
    ref_sys, sys_ = lda12["ref_sys"], lda12["sys"]
    return {"ac": rgw.gw_ac_gamma(sys_, pres, xc="lda,vwn", Lmo=Lt, device="cpu"),
            "ref_ac": ref_rgw.gw_ac_gamma(ref_sys, res, xc="lda,vwn", Lmo=jnp.asarray(L)),
            "exact": gw_exact.gw_exact_gamma(sys_, pres, xc="lda,vwn", Lmo=Lt,
                                             device="cpu"),
            "rpa": rgw.rpa_ecorr_gamma(sys_, pres, Lmo=Lt, device="cpu")}


def _kstate(mesh_k, spin=False):
    """A k-mesh of the 12^3 cell: the reference's k-system, the port's on its
    arrays, and the port's KRKS (and KUKS) states."""
    cell = diamond_primitive(mesh=(12,) * 3)
    kpts = np.zeros((1, 3)) if mesh_k == 1 else ref_lattice.make_kpts(cell.a, [2, 1, 1])
    ref = ref_kbuild(ref_diamond(mesh=(12,) * 3), kpts)
    sys_k = _port_ksystem(cell, kpts, ref)
    states = _states(sys_k, kscf_kernel, ("lda,vwn",), device="cpu")
    if spin:
        states["u"] = _states(sys_k, kuhf_kernel, ("lda,vwn",), device="cpu")["lda,vwn"]
    return ref, sys_k, states


@pytest.fixture(scope="module")
def k1():
    """The 1x1x1 k-mesh: KRKS LDA and the reference's k fit of it."""
    ref, sys_k, states = _kstate(1)
    res, pres = states["lda,vwn"]
    L = _ref_lmo_k(ref, res)
    return ref, sys_k, res, pres, L, lmo_from_numpy(L, "cpu")


@pytest.fixture(scope="module")
def k2():
    """The 2x1x1 k-mesh: KRKS and KUKS LDA."""
    ref, sys_k, states = _kstate(2, spin=True)
    res, pres = states["lda,vwn"]
    L = _ref_lmo_k(ref, res)
    return (ref, sys_k, res, pres, L, lmo_from_numpy(L, "cpu")) + states["u"]


@pytest.fixture(scope="module")
def k2_ac(k2):
    """The port's k-GW on the 2x1x1 KRKS state, all bands and k-points."""
    return krgw.kgw_ac(k2[1], k2[3], xc="lda,vwn", Lmo=k2[5], device="cpu")


def _h3(builder):
    L = 8.0
    return builder(np.eye(3) * L,
                   [["H", (L / 2 - 1.5, L / 2, L / 2)], ["H", (L / 2, L / 2, L / 2)],
                    ["H", (L / 2 + 1.5, L / 2, L / 2)]],
                   "gth-szv", pseudo="gth-pade", mesh=[12] * 3, spin=1)


@pytest.fixture(scope="module")
def h3():
    """The H3 radical chain (doublet): UHF and UKS LDA."""
    ref_sys = ref_build(_h3(ref_build_cell))
    sys_ = _port_system(_h3(build_cell), ref_sys)
    return ref_sys, sys_, _states(sys_, uhf_kernel, (None, "lda,vwn"))


def _same_qp(a, b, bar=QP):
    """|a - b| below ``bar`` (a scalar or per-orbital bars, rgw.qp_bars)."""
    assert np.all(np.abs(np.asarray(a) - np.asarray(b)) < bar)


def _gap(qp, nocc):
    return qp[nocc] - qp[nocc - 1]


def _grid(nw=100):
    f, w = rgw.scaled_legendre(nw)
    return f, w, rgw.sigma_grid(f)


# ---------------------------------------------------------------- Gamma AC
@pytest.mark.parametrize("budget", [None, 1 << 18])
def test_sigma_iw_chunks(lda12, budget, monkeypatch):
    """Sigma(iw') over frequency chunks (and, with a budget of 256 KiB, one
    frequency a chunk and column blocks of the triangular solve) against
    the reference's all-frequency program; ``orbs`` rows alone too."""
    if budget is not None:
        monkeypatch.setattr(rgw, "CHUNK_BYTES", budget)
    res, _, L, Lt = lda12["lda"]
    mo = np.asarray(res["mo_energy"])
    nocc = 4
    ef = 0.5 * (mo[nocc - 1] + mo[nocc])
    f, w, og = _grid()
    ref = _ref_once("sigma", lambda: np.asarray(ref_rgw._sigma_iw_batched(
        jnp.asarray(L), jnp.asarray(mo), nocc, jnp.asarray(f), jnp.asarray(w),
        jnp.asarray(og), ef)))
    assert _rel(rgw._sigma_iw_batched(Lt, mo, nocc, f, w, og, ef).numpy(), ref) < REL
    sub = rgw._sigma_iw_batched(Lt, mo, nocc, f, w, og, ef, orbs=[0, 3, 4]).numpy()
    assert np.abs(sub - ref[[0, 3, 4]]).max() < REL * np.abs(ref).max()


def test_gw_ac_vs_exact(lda12, lda_runs):
    """tests/test_gw.py:31 on the port: AC and the Lehmann-sum oracle each
    against the reference's, then AC against the oracle (5e-6), the opened
    gap and 0.8 < Z < 1."""
    res, pres, L, Lt = lda12["lda"]
    out, ref = lda_runs["ac"], lda_runs["ref_ac"]
    qp_ex, conv = lda_runs["exact"]
    ref_ex, _ = ref_exact.gw_exact_gamma(lda12["ref_sys"], res, xc="lda,vwn",
                                         Lmo=jnp.asarray(L))
    _same_qp(out.qp_energy, ref.qp_energy, rgw.qp_bars(out))
    assert np.abs(out.sigma_x - ref.sigma_x).max() < 1e-12
    assert np.abs(out.v_mf - ref.v_mf).max() < 1e-12
    _same_qp(qp_ex, ref_ex)
    assert out.converged and conv
    assert np.abs(out.qp_energy - qp_ex).max() < 5e-6
    gap_ks = _gap(np.asarray(res["mo_energy"]), out.nocc)
    assert _gap(out.qp_energy, out.nocc) > gap_ks
    assert np.all(out.qp_weight > 0.8) and np.all(out.qp_weight < 1.0)


def test_linearized_and_orbs_subset(lda12, lda_runs):
    """The linearized QP equation against the reference's, both packages
    and the oracle; ``orbs`` restricts Sigma's columns without changing
    them (1e-12) or those levels (the AC bars)."""
    res, pres, L, Lt = lda12["lda"]
    ref_sys, sys_ = lda12["ref_sys"], lda12["sys"]
    out = rgw.gw_ac_gamma(sys_, pres, xc="lda,vwn", Lmo=Lt, linearized=True, device="cpu")
    ref = ref_rgw.gw_ac_gamma(ref_sys, res, xc="lda,vwn", Lmo=jnp.asarray(L),
                              linearized=True)
    _same_qp(out.qp_energy, ref.qp_energy, rgw.qp_bars(out))
    assert np.abs(out.qp_weight - ref.qp_weight).max() < 1e-6
    ex, _ = gw_exact.gw_exact_gamma(sys_, pres, xc="lda,vwn", Lmo=Lt, linearized=True,
                                    device="cpu")
    ref_ex, _ = ref_exact.gw_exact_gamma(ref_sys, res, xc="lda,vwn", Lmo=jnp.asarray(L),
                                         linearized=True)
    _same_qp(ex, ref_ex)
    full = lda_runs["ac"]
    sub = rgw.gw_ac_gamma(sys_, pres, xc="lda,vwn", Lmo=Lt, orbs=[3, 4], device="cpu")
    assert np.abs(sub.sigma_iw - full.sigma_iw[[3, 4]]).max() < 1e-12
    _same_qp(sub.qp_energy[[3, 4]], full.qp_energy[[3, 4]], rgw.qp_bars(full)[[3, 4]])
    assert np.array_equal(np.delete(sub.qp_energy, [3, 4]),
                          np.delete(np.asarray(res["mo_energy"]), [3, 4]))


def test_drpa_spectrum(lda12):
    """The dense dRPA spectrum against the reference's (1e-10 relative) and
    the Lehmann-sum self-energy on it (1e-10)."""
    res, _, L, Lt = lda12["lda"]
    mo = np.asarray(res["mo_energy"])
    om, xpy, d, K = gw_exact.drpa_diagonalize(mo, 4, Lt)
    r_om, r_xpy, r_d, r_K = ref_exact.drpa_diagonalize(mo, 4, L)
    assert _rel(om.numpy(), r_om) < 1e-10
    assert _rel(K.numpy(), r_K) < 1e-14 and _rel(d.numpy(), r_d) < 1e-14
    # the eigenvectors are fixed only up to rotations within degenerate
    # roots: the Lehmann sums they enter are compared
    t = gw_exact._transition_densities(xpy, Lt, 4, np.arange(8))
    Lov = L[:, :4, 4:]
    r_t = np.sqrt(2.0) * np.einsum("vP,Ppq->vpq", np.einsum("via,Pia->vP", r_xpy, Lov), L)
    for w in (0.3 * mo[3] + 0.7 * mo[4], mo[0] - 1.0, mo[7] + 0.5):
        for p in (0, 3, 4, 7):
            assert abs(gw_exact.exact_sigma(w, mo, 4, om, t, p)
                       - ref_exact.exact_sigma(w, mo, 4, r_om, r_t, p)) < 1e-10


def test_rpa_plasmon_identity(lda12, lda_runs):
    """tests/test_gw.py:49: the Cholesky log-det quadrature against the
    reference's eigvalsh form, the plasmon formula against the reference's,
    and quadrature against plasmon (1e-10)."""
    res, pres, L, Lt = lda12["lda"]
    ec_q = lda_runs["rpa"]
    ec_p = gw_exact.rpa_ecorr_plasmon(res["mo_energy"], 4, Lt)
    assert abs(ec_q - ref_rgw.rpa_ecorr_gamma(lda12["ref_sys"], res,
                                              Lmo=jnp.asarray(L))) < LOGDET
    assert abs(ec_p - ref_exact.rpa_ecorr_plasmon(res["mo_energy"], 4, L)) < EC
    assert ec_p < -0.05
    assert abs(ec_q - ec_p) < 1e-10


def test_gw_at_hf_and_evgw(lda12, lda_runs):
    """tests/test_gw.py:59 and :88: GW@HF's exchange cancels, G0W0 and evGW
    from HF and LDA against the reference's, the G0W0 gaps agree across
    starting points and evGW tightens them."""
    ref_sys, sys_ = lda12["ref_sys"], lda12["sys"]
    out, ref = {}, {}
    for name, xc in (("lda", "lda,vwn"), ("hf", None)):
        res, pres, L, Lt = lda12[name]
        if name == "lda":
            g0, ref_g0 = lda_runs["ac"], lda_runs["ref_ac"]
        else:
            g0 = rgw.gw_ac_gamma(sys_, pres, xc=xc, Lmo=Lt, device="cpu")
            ref_g0 = ref_rgw.gw_ac_gamma(ref_sys, res, xc=xc, Lmo=jnp.asarray(L))
        out[name] = (g0, rgw.evgw_gamma(sys_, pres, xc=xc, Lmo=Lt, device="cpu"))
        ref[name] = (ref_g0, ref_rgw.evgw_gamma(ref_sys, res, xc=xc, Lmo=jnp.asarray(L)))
        for o, r, ev in zip(out[name], ref[name], (False, True)):
            _same_qp(o.qp_energy, r.qp_energy, rgw.qp_bars(o, ev))
    g0_h, ev_h = out["hf"]
    assert np.abs(g0_h.sigma_x - g0_h.v_mf).max() < 1e-12
    assert ev_h.converged and out["lda"][1].converged
    gap_hf = _gap(np.asarray(lda12["hf"][0]["mo_energy"]), 4)
    gap_ks = _gap(np.asarray(lda12["lda"][0]["mo_energy"]), 4)
    assert abs(gap_hf - gap_ks) > 0.5
    d_g0 = abs(_gap(g0_h.qp_energy, 4) - _gap(out["lda"][0].qp_energy, 4))
    d_ev = abs(_gap(ev_h.qp_energy, 4) - _gap(out["lda"][1].qp_energy, 4))
    assert d_g0 < 0.05
    assert d_ev < 0.6 * d_g0 and d_ev < 0.02


# ---------------------------------------------------------------- k-point
def test_kgw_gamma_limit_and_fc(lda12, lda_runs, k1):
    """tests/test_gw.py:78, :139 and :203 at 1x1x1: k-GW (with and without
    the head/wing correction) and k-RPA against the reference's, k-GW
    against the port's Gamma GW (1e-6), the correction narrowing the gap
    by less than 1 Ha, and k-RPA against Gamma RPA (1e-8)."""
    ref_k, sys_k, res_k, pres_k, Lk, Lk_t = k1
    out_g = lda_runs["ac"]
    outs = []
    for fc in (False, True):
        out = krgw.kgw_ac(sys_k, pres_k, xc="lda,vwn", Lmo=Lk_t, fc=fc, device="cpu")
        ref = ref_krgw.kgw_ac(ref_k, res_k, xc="lda,vwn",
                              Lmo=[[jnp.asarray(x) for x in r] for r in Lk], fc=fc)
        _same_qp(out.qp_energy, ref.qp_energy, rgw.qp_bars(out))
        outs.append(out)
    assert np.abs(out_g.qp_energy - outs[0].qp_energy[0]).max() < 1e-6
    n = outs[0].nocc
    g0, g1 = (_gap(o.qp_energy[0], n) for o in outs)
    assert np.isfinite(outs[1].qp_energy).all()
    assert g1 < g0 and g0 - g1 < 1.0
    ec_k = krgw.rpa_ecorr_kpts(sys_k, pres_k, Lmo=Lk_t, device="cpu")
    ref_ec = ref_krgw.rpa_ecorr_kpts(ref_k, res_k,
                                     Lmo=[[jnp.asarray(x) for x in r] for r in Lk])
    assert abs(ec_k - ref_ec) < LOGDET
    assert abs(ec_k - lda_runs["rpa"]) < 1e-8


@pytest.mark.parametrize("budget", [None, 1 << 18])
def test_pi_kl_and_kl_contribution(k2, budget, monkeypatch):
    """The per-transfer polarizability and the Sigma contribution summed
    over frequency chunks against the reference's batched ones, every
    momentum transfer of the 2x1x1 mesh (1e-12 relative)."""
    if budget is not None:
        monkeypatch.setattr(rgw, "CHUNK_BYTES", budget)
    ref_k, sys_k, res_k, _, Lk, Lk_t = k2[:6]
    mo = np.asarray(res_k["mo_energy"])
    nk, nocc = 2, 4
    ef = 0.5 * (mo[:, nocc - 1].max() + mo[:, nocc].min())
    f, w, og = _grid()
    ktab = krgw._k_index_table(sys_k.kpts, sys_k.cell.a)
    for kL in range(nk):
        kidx, L_stack, km_of, e_i, e_a = krgw._transfer(Lk_t, mo, ktab, kL, nocc,
                                                        list(range(nk)), "cpu")
        ref_pi = _ref_once(("pi", kL), lambda: np.asarray(ref_krgw._pi_kl(
            jnp.asarray(L_stack.numpy()), jnp.asarray(mo[:, :nocc]),
            jnp.asarray(mo[kidx, nocc:]), jnp.asarray(f), nk)))
        nc = 7
        pi = np.concatenate([krgw._pi_kl(L_stack, e_i, e_a, f[w0:w0 + nc], nk).numpy()
                             for w0 in range(0, len(f), nc)])
        assert _rel(pi, ref_pi) < REL
        Lw = torch.stack([Lk_t[km_of[j]][j] for j in range(nk)])
        eye = np.eye(ref_pi.shape[1])
        eps_m1 = _ref_once(("eps", kL), lambda: np.linalg.solve(
            eye[None] - ref_pi, np.broadcast_to(eye, ref_pi.shape)) - eye[None])
        ref_sig = _ref_once(("sig", kL), lambda: np.asarray(ref_krgw._kl_contribution(
            jnp.asarray(eps_m1), jnp.asarray(Lw.numpy()), jnp.asarray(mo[km_of]),
            jnp.asarray(f), jnp.asarray(w), jnp.asarray(og), ef, nocc, nk)))
        sig = 0
        for w0 in range(0, len(f), nc):
            R = torch.linalg.cholesky(torch.eye(ref_pi.shape[1], dtype=torch.complex128)
                                      - torch.as_tensor(pi[w0:w0 + nc]))
            sig = sig + krgw._kl_contribution(R, Lw, mo[km_of], f[w0:w0 + nc],
                                              w[w0:w0 + nc], og, ef, nocc, nk).numpy()
        assert _rel(sig, ref_sig) < REL


def test_kgw_and_krpa_2x1x1(k2, k2_ac):
    """2x1x1 k-GW and k-RPA against the reference's; KUKS's k-RPA against
    KRKS's (tests/test_ugw.py:188, 1e-7)."""
    ref_k, sys_k, res_k, pres_k, Lk, Lk_t, res_u, pres_u = k2
    ref_L = [[jnp.asarray(x) for x in r] for r in Lk]
    out = k2_ac
    ref = ref_krgw.kgw_ac(ref_k, res_k, xc="lda,vwn", Lmo=ref_L)
    _same_qp(out.qp_energy, ref.qp_energy, rgw.qp_bars(out))
    ec = krgw.rpa_ecorr_kpts(sys_k, pres_k, Lmo=Lk_t, device="cpu")
    assert abs(ec - ref_krgw.rpa_ecorr_kpts(ref_k, res_k, Lmo=ref_L)) < LOGDET
    ec_u = ugw.kurpa_ecorr(sys_k, pres_u, device="cpu")
    assert ec_u < -1e-3 and abs(ec - ec_u) < 1e-7


def test_kgw_kptlist_and_orbs_subset(k2, k2_ac):
    """k-GW on a subset of bands and k-points: its Sigma is the full run's
    (1e-12), its levels the full run's and the reference's on the same
    subset (the AC bars)."""
    ref_k, sys_k, res_k, pres_k, Lk, Lk_t = k2[:6]
    full = k2_ac
    sub = krgw.kgw_ac(sys_k, pres_k, xc="lda,vwn", Lmo=Lk_t, orbs=[3, 4], kptlist=[1],
                      device="cpu")
    assert np.abs(sub.sigma_iw[0] - full.sigma_iw[1][[3, 4]]).max() < 1e-12
    _same_qp(sub.qp_energy[1, [3, 4]], full.qp_energy[1, [3, 4]], rgw.qp_bars(full)[1, [3, 4]])
    ref = ref_krgw.kgw_ac(ref_k, res_k, xc="lda,vwn", orbs=[3, 4], kptlist=[1],
                          Lmo=[[jnp.asarray(x) for x in r] for r in Lk])
    _same_qp(sub.qp_energy[1, [3, 4]], ref.qp_energy[1, [3, 4]],
             rgw.qp_bars(full)[1, [3, 4]])


def test_dielectric_constant_and_kugw(k2, k2_ac):
    """The macroscopic dielectric constant (the reference's heavy
    tests/test_gw.py:235 takes a 2x2x2 mesh; here 2x1x1, where it is 13.0)
    against the reference's on the same fit tensors (1e-10 relative), and
    k-point spin GW on the closed shell against the restricted k-GW
    (tests/test_ugw.py:113's bar, 1e-4)."""
    ref_k, sys_k, res_k, pres_k, Lk, Lk_t, res_u, pres_u = k2
    eps = krgw.dielectric_constant(sys_k, pres_k, (1, 0, 0), Lmo=Lk_t, device="cpu")
    ref = ref_krgw.dielectric_constant(ref_k, res_k, (1, 0, 0),
                                       Lmo=[[jnp.asarray(x) for x in r] for r in Lk])
    assert eps > 1.0 and abs(eps - ref) < 1e-10 * abs(ref)
    out_r = k2_ac
    out_u = ugw.kugw_ac(sys_k, pres_u, xc="lda,vwn", device="cpu")
    assert out_u.converged
    for s in range(2):
        assert np.abs(out_u.qp_energy[s] - out_r.qp_energy).max() < 1e-4


def test_kgw_gga_gamma_limit(lda12, k1):
    """tests/test_gw.py:254: k-GW on a PBE state at 1x1x1 against the
    reference's and against the port's Gamma GW (the reference's bars), on
    the 12^3 cell's Gamma and 1x1x1 systems."""
    ref_g, sys_g = lda12["ref_sys"], lda12["sys"]
    res_g, pres_g = _states(sys_g, scf_kernel, ("pbe",))["pbe"]
    ref_k, sys_k = k1[:2]
    res_k, pres_k = _states(sys_k, kscf_kernel, ("pbe",), device="cpu")["pbe"]
    L = np.asarray(ref_rgw.build_lmo(ref_g, res_g["mo_coeff"]))
    Lk = _ref_lmo_k(ref_k, res_k)
    out_g = rgw.gw_ac_gamma(sys_g, pres_g, xc="pbe", Lmo=lmo_from_numpy(L, "cpu"),
                            device="cpu")
    out_k = krgw.kgw_ac(sys_k, pres_k, xc="pbe", Lmo=lmo_from_numpy(Lk, "cpu"),
                        device="cpu")
    ref = ref_krgw.kgw_ac(ref_k, res_k, xc="pbe", Lmo=[[jnp.asarray(x) for x in r]
                                                       for r in Lk])
    _same_qp(out_k.qp_energy, ref.qp_energy, rgw.qp_bars(out_k))
    assert np.abs(out_k.v_mf - ref.v_mf).max() < 1e-10
    assert np.abs(out_g.sigma_x - out_k.sigma_x[0]).max() < 1e-7
    assert np.abs(out_g.v_mf - out_k.v_mf[0]).max() < 1e-6
    assert np.abs(out_g.qp_energy - out_k.qp_energy[0]).max() < 1e-5


# ---------------------------------------------------------------- CD
@pytest.mark.parametrize("budget", [None, 1 << 18])
def test_w_batched_z_chunks(lda12, budget, monkeypatch):
    """W at complex frequencies (imaginary axis through Cholesky, real
    axis through LU) against the reference's batched solve; column
    subsets; the spin-polarized form on a closed shell equals the
    restricted one (1e-12 relative)."""
    if budget is not None:
        monkeypatch.setattr(rgw, "CHUNK_BYTES", budget)
    res, _, L, Lt = lda12["lda"]
    mo = np.asarray(res["mo_energy"])
    f, _, _ = _grid(20)
    for i, z2 in enumerate((-f ** 2 + 0j,
                            np.array([(0.2 + 1e-3j) ** 2, (1.3 + 5e-3j) ** 2, -0.09 + 0j]))):
        ref = _ref_once(("w", i), lambda: np.asarray(ref_cd._w_batched_z(
            jnp.asarray(L), jnp.asarray(mo), 4, jnp.asarray(z2))))
        assert _rel(gw_cd._w_batched_z(Lt, mo, 4, z2).numpy(), ref) < REL
        sub = gw_cd._w_batched_z(Lt, mo, 4, z2, cols=[3, 4]).numpy()
        assert np.abs(sub - ref[:, :, [3, 4]]).max() < REL * np.abs(ref).max()
        ref_u = _ref_once(("uw", i), lambda: np.asarray(ref_cd._uw_batched_z(
            jnp.asarray(L), jnp.asarray(L), jnp.asarray(mo), jnp.asarray(mo), 4, 4,
            jnp.asarray(z2))[0]))
        wa, wb = gw_cd._uw_batched_z(Lt, Lt, mo, mo, 4, 4, z2)
        assert _rel(wa.numpy(), ref_u) < REL
        assert _rel(wb.numpy(), ref) < REL


def test_gw_cd_vs_exact(lda12, lda_runs):
    """tests/test_gw.py:271: the CD self-energy at real frequencies
    (including 2 Ha below the valence band) against the Lehmann sum
    (1e-7), and the CD QP energies against the reference's (1e-8) and the
    oracle (1e-4)."""
    res, pres, L, Lt = lda12["lda"]
    mo = np.asarray(res["mo_energy"])
    nocc = 4
    ef = 0.5 * (mo[nocc - 1] + mo[nocc])
    om, xpy, _, _ = gw_exact.drpa_diagonalize(mo, nocc, Lt)
    tdm = gw_exact._transition_densities(xpy, Lt, nocc, np.arange(8))
    f, w = rgw.scaled_legendre(200)
    Wiw = gw_cd._w_batched_z(Lt, mo, nocc, -f ** 2 + 0j).numpy()
    for p, x in [(0, mo[0]), (0, mo[0] - 2.0), (nocc - 1, mo[nocc - 1]), (nocc, mo[nocc])]:
        s_cd = gw_cd._sigma_cd_point(Wiw, w, mo, nocc, Lt, p, x, ef, 1e-4, f).real
        s_ex = gw_exact.exact_sigma(x, mo, nocc, om, tdm, p, eta=1e-6).real
        assert abs(s_cd - s_ex) < 1e-7
    out = gw_cd.gw_cd_gamma(lda12["sys"], pres, xc="lda,vwn", nw=200, Lmo=Lt, eta=1e-4,
                            device="cpu")
    ref = ref_cd.gw_cd_gamma(lda12["ref_sys"], res, xc="lda,vwn", nw=200,
                             Lmo=jnp.asarray(L), eta=1e-4, orbs=[0, 3, 4])
    qp_ex, conv = lda_runs["exact"]
    assert out.converged and conv
    _same_qp(out.qp_energy[[0, 3, 4]], ref.qp_energy[[0, 3, 4]])
    assert np.abs(out.qp_energy - qp_ex).max() < 1e-4


def test_kgw_cd_gamma_limit(lda12, k1):
    """tests/test_gw.py:323: 1x1x1 k-GW-CD against the reference's and the
    port's Gamma GW-CD (1e-6), a deep-core orbital included."""
    ref_k, sys_k, res_k, pres_k, Lk, Lk_t = k1
    res, pres, L, Lt = lda12["lda"]
    orbs = [0, 3, 4]
    out_g = gw_cd.gw_cd_gamma(lda12["sys"], pres, xc="lda,vwn", Lmo=Lt, orbs=orbs,
                              device="cpu")
    out_k = gw_cd.kgw_cd(sys_k, pres_k, xc="lda,vwn", Lmo=Lk_t, orbs=orbs, device="cpu")
    ref = ref_cd.kgw_cd(ref_k, res_k, xc="lda,vwn", orbs=orbs,
                        Lmo=[[jnp.asarray(x) for x in r] for r in Lk])
    assert out_k.converged
    _same_qp(out_k.qp_energy, ref.qp_energy)
    assert np.abs(out_g.qp_energy - out_k.qp_energy[0]).max() < 1e-6


# ---------------------------------------------------------------- RSH
@pytest.fixture(scope="module")
def hse():
    """Diamond 14^3: HSE06 and PBE0 (conv_tol 1e-11) and closed-shell UKS
    HSE06."""
    ref_sys = ref_build(ref_diamond(mesh=(14,) * 3))
    sys_ = _port_system(diamond_primitive(mesh=(14,) * 3), ref_sys)
    states = _states(sys_, scf_kernel, ("hse06", "pbe0"), conv_tol=1e-11)
    states["uhse06"] = _states(sys_, uhf_kernel, ("hse06",), conv_tol=1e-11)["hse06"]
    return ref_sys, sys_, states


def test_gw_hse06(hse):
    """tests/test_gw_rsh.py:44, :51 and :69: v_mf against the SCF's own Fock
    (5e-6) and the reference's (1e-12), GW@HSE06 against the reference's
    (GW@PBE0's path is test_gw_ac_vs_exact's with a hybrid v_mf), the
    GW@HSE06 and GW@PBE0 gaps within 0.05 Ha, and UGW@HSE06 on the closed
    shell against the restricted GW (1e-5)."""
    ref_sys, sys_, states = hse
    res, pres = states["hse06"]
    _, v_mf = rgw._mf_potentials(sys_, pres, "hse06")
    dm = pres["dm"]
    vj = fftdf.get_j(sys_.aoR, dm, sys_.coulG, sys_.mesh, sys_.weight)
    C = pres["mo_coeff"]
    want = pres["mo_energy"] - torch.einsum("ip,ij,jp->p", C, sys_.hcore + vj, C)
    assert np.abs(v_mf - want.numpy()).max() < 5e-6
    gaps = {}
    for xc in ("hse06", "pbe0"):
        r, pr = states[xc]
        L = np.asarray(ref_rgw.build_lmo(ref_sys, r["mo_coeff"]))
        out = rgw.gw_ac_gamma(sys_, pr, xc=xc,
                              Lmo=lmo_from_numpy(L, "cpu"), device="cpu")
        assert out.converged and np.isfinite(out.qp_energy).all()
        gaps[xc] = _gap(out.qp_energy, 4)
        if xc == "hse06":
            ref = ref_rgw.gw_ac_gamma(ref_sys, r, xc=xc, Lmo=jnp.asarray(L))
            _same_qp(out.qp_energy, ref.qp_energy, rgw.qp_bars(out))
            assert np.abs(out.v_mf - ref.v_mf).max() < 1e-12
            out_r = out
    assert gaps["hse06"] > 0 and abs(gaps["hse06"] - gaps["pbe0"]) < 0.05
    out_u = ugw.ugw_ac_gamma(sys_, states["uhse06"][1], xc="hse06", device="cpu")
    for s in range(2):
        assert np.abs(out_u.qp_energy[s] - out_r.qp_energy).max() < 1e-5


# ---------------------------------------------------------------- spin
@pytest.fixture(scope="module")
def uks12(lda12):
    """Closed-shell UKS LDA on the 12^3 cell."""
    return _states(lda12["sys"], uhf_kernel, ("lda,vwn",))["lda,vwn"]


def test_ugw_closed_shell(lda12, uks12):
    """tests/test_ugw.py:18, :54 and :157: UGW-AC, UGW-CD and the
    unrestricted RPA on a closed shell against the restricted results (the
    reference tests' oracles, at their bars; the restricted ones are held
    to the reference above, the spin ones on the open shell below)."""
    res_u, pres_u = uks12
    res, pres, L, Lt = lda12["lda"]
    ref_sys, sys_ = lda12["ref_sys"], lda12["sys"]
    out_r = rgw.gw_ac_gamma(sys_, pres, xc="lda,vwn", device="cpu")
    out_u = ugw.ugw_ac_gamma(sys_, pres_u, xc="lda,vwn", device="cpu")
    assert out_u.converged
    for s in range(2):
        assert np.abs(out_u.qp_energy[s] - out_r.qp_energy).max() < 1e-6
    orbs = [0, 3, 4]
    cd_r = gw_cd.gw_cd_gamma(sys_, pres, xc="lda,vwn", orbs=orbs, device="cpu")
    cd_u = gw_cd.ugw_cd_gamma(sys_, pres_u, xc="lda,vwn", orbs=orbs, device="cpu")
    assert cd_r.converged and cd_u.converged
    for s in range(2):
        assert np.abs(cd_u.qp_energy[s] - cd_r.qp_energy).max() < 1e-8
    ec_u = ugw.urpa_ecorr_gamma(sys_, pres_u, device="cpu")
    assert abs(ec_u - rgw.rpa_ecorr_gamma(sys_, pres, device="cpu")) < 1e-10


def test_ugw_open_shell(h3):
    """tests/test_ugw.py:30, :72 and :157 on the H3 radical: UGW@UHF (the
    exchange cancels, the channels differ, the SOMO moves), UGW-CD on the
    deepest level against UGW-AC (5e-2) and the reference's, and the
    unrestricted RPA against the spin-orbital plasmon formula (1e-10), each
    against the reference's."""
    ref_sys, sys_, states = h3
    res, pres = states[None]
    out = ugw.ugw_ac_gamma(sys_, pres, xc=None, device="cpu")
    ref = ref_ugw.ugw_ac_gamma(ref_sys, res, xc=None)
    qa, qb = out.qp_energy
    bars = rgw.qp_bars(out)
    for s in range(2):
        _same_qp(out.qp_energy[s], ref.qp_energy[s], bars[s])
    assert np.isfinite(qa).all() and np.isfinite(qb).all()
    assert abs(qa[1] - qb[1]) > 1e-3
    assert np.abs(np.asarray(out.sigma_x) - np.asarray(out.v_mf)).max() < 1e-12
    assert abs(qa[1] - np.asarray(res["mo_energy"][0])[1]) > 1e-4

    ec = ugw.urpa_ecorr_gamma(sys_, pres, device="cpu")
    La, Lb = ugw._spin_lmo(sys_, pres)
    ecp = ugw.urpa_ecorr_plasmon(pres, (2, 1), La, Lb)
    assert abs(ec - ref_ugw.urpa_ecorr_gamma(ref_sys, res)) < LOGDET
    assert ec < -1e-3 and abs(ec - ecp) < 1e-10

    res_l, pres_l = states["lda,vwn"]
    cd = gw_cd.ugw_cd_gamma(sys_, pres_l, xc="lda,vwn", orbs=[0], device="cpu")
    ref_cd_l = ref_cd.ugw_cd_gamma(ref_sys, res_l, xc="lda,vwn", orbs=[0])
    ac = ugw.ugw_ac_gamma(sys_, pres_l, xc="lda,vwn", orbs=[0], device="cpu")
    assert cd.converged
    for s in range(2):
        _same_qp(cd.qp_energy[s][0], ref_cd_l.qp_energy[s][0])
        assert abs(cd.qp_energy[s][0] - ac.qp_energy[s][0]) < 5e-2
    assert abs(cd.qp_energy[0][0] - cd.qp_energy[1][0]) > 1e-3
    assert abs(cd.qp_energy[0][0] - np.asarray(res_l["mo_energy"][0])[0]) > 1e-3


def test_entry_points_default_to_cuda(lda12, k1):
    """Without CUDA, the entry points raise unless given device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res, pres, L, Lt = lda12["lda"]
    sys_ = lda12["sys"]
    for fn in (rgw.gw_ac_gamma, rgw.rpa_ecorr_gamma, gw_exact.gw_exact_gamma,
               gw_cd.gw_cd_gamma, rgw.evgw_gamma):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(sys_, pres, Lmo=Lt)
    with pytest.raises(RuntimeError, match="CUDA"):
        krgw.kgw_ac(k1[1], k1[3], Lmo=k1[5])

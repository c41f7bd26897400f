"""Port linear response (tdscf/) == JAX reference.

The ground states are the port's SCFs on the CPU, handed to both packages
as the same numbers: the diamond primitive cell of tests/test_tdscf.py on
14^3 (HF with exxdiv None as there, LDA and PBE), the same cell on 10^3
with a 2x1x1 k-mesh (KRHF on the port's k-point ISDF factors, c=10, which
the reference takes as arrays; KRKS LDA and PBE on FFTDF), and a
0-dimensional H2 box for the length-gauge dipoles. All float64 on the CPU.
Bars: the response products on a seeded x 1e-12 relative, dense TDA and
TDDFT energies 1e-10 Ha, Davidson 1e-8 Ha, oscillator strengths 1e-8.

The reference's pointwise LDA kernels (a vmapped ``jax.hessian`` per
point, Gamma and k-point) and its spin functionals run under one
``jax.jit`` a module at XLA's backend optimization level 0; its
dense GGA triplet kernel takes one eager JVP per (j, b) pair (about 30 s
here), so the port's dense GGA triplet is held to the port's Davidson
and to the reference's matrix-free product instead.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu.df.isdf_k import ISDFK as RefISDFK  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_kbuild  # noqa: E402
from pyscf_isdf_tpu.tdscf import ktda as ref_ktda  # noqa: E402
from pyscf_isdf_tpu.ops import xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.tdscf import response as ref_response, rks as ref_rks  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell, lattice  # noqa: E402
from pyscf_isdf_tpu_torch.df.isdf import build_isdf  # noqa: E402
from pyscf_isdf_tpu_torch.df.isdf_k import build_isdf_k  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops.xc import XCSpec  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, scf_kernel,
)
from pyscf_isdf_tpu_torch.tdscf import ktda, response, rks  # noqa: E402

MV_TOL = 1e-12
E_TOL = 1e-10
DAV_TOL = 1e-8
OSC_TOL = 1e-8


def _host(v):
    if isinstance(v, (tuple, list)):
        return [_host(x) for x in v]
    return v.numpy() if torch.is_tensor(v) else v


def _ref_res(res):
    return {k: _host(v) for k, v in res.items()}


@pytest.fixture(scope="module")
def gamma():
    """Port and reference systems of the 14^3 diamond cell and the port's
    HF (exxdiv None), LDA and PBE ground states."""
    system = build_scf_system(diamond_primitive(mesh=(14,) * 3), device="cpu")
    states = {"hf": scf_kernel(system, xc=None, exxdiv=None, conv_tol=1e-10)}
    for xc in ("lda,vwn", "pbe"):
        states[xc] = scf_kernel(system, xc=xc, conv_tol=1e-10)
    return system, ref_build(ref_diamond(mesh=(14,) * 3)), states


@pytest.fixture(scope="module")
def kpoint():
    """Port and reference 2x1x1 k-systems of the 10^3 diamond cell, the
    port's k-point ISDF (as both packages' objects) and KRHF, KRKS LDA and
    KRKS PBE states."""
    cell = diamond_primitive(mesh=(10,) * 3)
    kpts = lattice.make_kpts(cell.a, [2, 1, 1])
    system = build_kscf_system(cell, kpts, device="cpu")
    isdfk = build_isdf_k(cell, system.aoR_k, kpts, c=10)
    ref_isdfk = RefISDFK(Ug=jnp.asarray(isdfk.Ug.numpy()), Wq=jnp.asarray(isdfk.Wq.numpy()),
                         qmap=np.asarray(isdfk.qmap), ip_idx=jnp.asarray(isdfk.ip_idx.numpy()))
    states = {"hf": kscf_kernel(system, xc=None, df="isdf", isdf_c=10, conv_tol=1e-10,
                                device="cpu")}
    for xc in ("lda,vwn", "pbe"):
        states[xc] = kscf_kernel(system, xc=xc, conv_tol=1e-10, device="cpu")
    return (system, ref_kbuild(ref_diamond(mesh=(10,) * 3), kpts), isdfk, ref_isdfk,
            states)


# the reference's pointwise LDA kernels (vmapped hessians, eager there),
# each under one jit shared by every test of the module
_O0 = {"xla_backend_optimization_level": 0}
_REF_FXC = jax.jit(ref_rks._fxc_lda, static_argnums=0, compiler_options=_O0)
_REF_FXC_K = jax.jit(ref_ktda._fxc_lda_channels, static_argnums=0, compiler_options=_O0)


_REF_SPIN_XC = jax.jit(ref_xc.XCSpec.exc_vxc_spin, static_argnums=0, compiler_options=_O0)


@pytest.fixture(autouse=True)
def ref_fxc_jitted(monkeypatch):
    monkeypatch.setattr(ref_rks, "_fxc_lda", _REF_FXC)
    monkeypatch.setattr(ref_ktda, "_fxc_lda_channels", _REF_FXC_K)
    # the reference's spin functionals (its k-point GGA response) run
    # eagerly otherwise: one jit a functional for the module
    plain = ref_xc.XCSpec.exc_vxc_spin

    def spin(self, *a):
        if any(isinstance(x, jax.core.Tracer) for x in a):
            return plain(self, *a)          # inside the reference's own trace
        return _REF_SPIN_XC(self, *a)
    monkeypatch.setattr(ref_xc.XCSpec, "exc_vxc_spin", spin)


def _xc(name):
    return None if name == "hf" else name


def test_fxc_lda_against_reference():
    """The pointwise LDA kernels (double autograd) against the reference's
    vmapped hessian, the 1e-12 floor included."""
    rho = np.array([0.0, 1e-14, 1e-12, 3e-6, 0.02, 0.7, 4.0])
    fs, ft = rks._fxc_lda(XCSpec("lda,vwn"), torch.as_tensor(rho))
    rs, rt = ref_rks._fxc_lda(ref_rks.XCSpec("lda,vwn"), jnp.asarray(rho))
    for a, b in ((fs, rs), (ft, rt)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() < 1e-12 * np.abs(b).max()


@pytest.mark.parametrize("name,singlet", [("hf", True), ("lda,vwn", True),
                                          ("lda,vwn", False), ("pbe", True),
                                          ("pbe", False)])
def test_tda_matvec(gamma, name, singlet):
    """A.x on a seeded x: orbital differences, the Coulomb response, FFTDF
    exchange and the XC kernel (LDA, and GGA by directional derivatives)."""
    system, ref_system, states = gamma
    res = states[name]
    mv, diag = response.make_tda_matvec(system, res, xc=_xc(name), singlet=singlet)
    ref_mv, ref_diag = ref_response.make_tda_matvec(ref_system, _ref_res(res), xc=_xc(name),
                                                    singlet=singlet)
    assert np.abs(diag - ref_diag).max() < 1e-14
    x = np.random.default_rng(3).random(diag.shape)
    got, want = mv(x).numpy(), np.asarray(ref_mv(jnp.asarray(x)))
    assert np.abs(got - want).max() < MV_TOL * np.abs(want).max()


def test_tda_matvec_isdf_exchange(gamma):
    """The ISDF exchange response on the port's factorization (given to the
    reference as its aoRg and W)."""
    system, ref_system, states = gamma
    isdf = build_isdf(system.aoR, system.coulG, system.mesh, system.weight, c=8)
    ref_isdf = SimpleNamespace(aoRg=jnp.asarray(isdf.aoRg.numpy()), W=jnp.asarray(isdf.W.numpy()))
    mv, diag = response.make_tda_matvec(system, states["hf"], isdf=isdf)
    ref_mv, _ = ref_response.make_tda_matvec(ref_system, _ref_res(states["hf"]), isdf=ref_isdf)
    x = np.random.default_rng(4).random(diag.shape)
    got, want = mv(x).numpy(), np.asarray(ref_mv(jnp.asarray(x)))
    assert np.abs(got - want).max() < MV_TOL * np.abs(want).max()


@pytest.mark.parametrize("name,singlet", [("hf", True), ("hf", False), ("lda,vwn", True),
                                          ("lda,vwn", False), ("pbe", True)])
def test_dense_tda_and_tddft(gamma, name, singlet):
    """tda_kernel and tddft_kernel energies on
    the dense Casida matrices, with TDDFT at or below TDA state by state."""
    system, ref_system, states = gamma
    res, ref_res = states[name], _ref_res(states[name])
    e, v = rks.tda_kernel(system, res, xc=_xc(name), nstates=4, singlet=singlet)
    e_ref, v_ref = ref_rks.tda_kernel(ref_system, ref_res, xc=_xc(name), nstates=4,
                                      singlet=singlet)
    assert np.abs(e - e_ref).max() < E_TOL
    td = rks.tddft_kernel(system, res, xc=_xc(name), nstates=4, singlet=singlet)
    td_ref = ref_rks.tddft_kernel(ref_system, ref_res, xc=_xc(name), nstates=4,
                                  singlet=singlet)
    assert np.abs(td - td_ref).max() < E_TOL
    assert np.all(td <= e + 1e-10)


def test_dense_gga_triplet_matches_davidson(gamma):
    """The dense PBE triplet (one directional derivative per (j, b) pair)
    against the port's matrix-free Davidson, whose product the reference
    holds (test_tda_matvec), and the lowest triplet below the singlet."""
    system, _, states = gamma
    e_t, _ = rks.tda_kernel(system, states["pbe"], xc="pbe", nstates=3, singlet=False)
    e_dav, _ = response.tda_davidson(system, states["pbe"], xc="pbe", nstates=3,
                                     singlet=False)
    assert np.abs(e_t - e_dav).max() < DAV_TOL
    e_s, _ = rks.tda_kernel(system, states["pbe"], xc="pbe", nstates=3)
    assert e_t[0] <= e_s[0] + 1e-10


@pytest.mark.parametrize("name", ["hf", "pbe"])
def test_tda_davidson(gamma, name):
    """tda_davidson against the reference's (the same start vectors,
    subspace limits and drop), and against the dense TDA."""
    system, ref_system, states = gamma
    e, _ = response.tda_davidson(system, states[name], xc=_xc(name), nstates=3)
    e_ref, _ = ref_response.tda_davidson(ref_system, _ref_res(states[name]), xc=_xc(name),
                                         nstates=3)
    assert np.abs(e - e_ref).max() < DAV_TOL
    e_dense, _ = rks.tda_kernel(system, states[name], xc=_xc(name), nstates=3)
    assert np.abs(e - e_dense).max() < DAV_TOL


def test_oscillator_strengths():
    """Length gauge on a 0-dimensional H2 box and velocity gauge there and
    on the periodic diamond cell, on the same states and vectors."""
    L = 12.0
    basis = [[0, (1.3, 1.0)], [0, (0.25, 1.0)]]

    def box(build):
        return build(np.eye(3) * L, [["H", (L / 2, L / 2, L / 2 - 0.7)],
                                     ["H", (L / 2, L / 2, L / 2 + 0.7)]],
                     basis=basis, mesh=[24] * 3, dimension=0)

    system = build_scf_system(box(build_cell), device="cpu")
    ref_system = ref_build(box(ref_build_cell))
    res = scf_kernel(system, xc=None, exxdiv=None, conv_tol=1e-11)
    e, v = rks.tda_kernel(system, res, nstates=3)
    for port, ref in ((rks.tda_oscillator_strengths, ref_rks.tda_oscillator_strengths),
                      (rks.tda_oscillator_strengths_velocity,
                       ref_rks.tda_oscillator_strengths_velocity)):
        f, mu = port(system, res, e, v)
        f_ref, mu_ref = ref(ref_system, _ref_res(res), e, v)
        assert np.abs(f - np.asarray(f_ref)).max() < OSC_TOL
        assert np.abs(mu - np.asarray(mu_ref)).max() < OSC_TOL
    with pytest.raises(NotImplementedError):
        rks.tda_oscillator_strengths(build_scf_system(diamond_primitive(mesh=(6,) * 3),
                                                      device="cpu"), res, e, v)


@pytest.mark.parametrize("name,singlet", [("hf", True), ("lda,vwn", True),
                                          ("lda,vwn", False), ("pbe", True),
                                          ("pbe", False)])
def test_ktda_matvec(kpoint, name, singlet):
    """The k-point A.x (and B.y) on seeded complex amplitudes: Coulomb,
    k-ISDF exchange, the LDA kernel and the GGA directional derivatives."""
    system, ref_system, isdfk, ref_isdfk, states = kpoint
    res = states[name]
    a, b, diag = ktda.make_ktddft_ops(system, res, xc=_xc(name), singlet=singlet,
                                      isdfk=isdfk)
    ra, rb, ref_diag = ref_ktda.make_ktddft_ops(ref_system, _ref_res(res), xc=_xc(name),
                                                singlet=singlet, isdfk=ref_isdfk)
    assert np.abs(diag - ref_diag).max() < 1e-14
    rng = np.random.default_rng(5)
    x = rng.random(diag.shape) + 1j * rng.random(diag.shape)
    for port, ref in ((a, ra), (b, rb)):
        got, want = port(x).numpy(), np.asarray(ref(jnp.asarray(x)))
        assert np.abs(got - want).max() < MV_TOL * np.abs(want).max()


@pytest.mark.parametrize("name,singlet", [("hf", True), ("lda,vwn", False)])
def test_ktddft_and_ktda_davidson(kpoint, name, singlet):
    """ktddft_kernel (the paired RPA problem) and ktda_davidson (the
    realified space) against the reference's; for the LDA triplet the
    lowest RPA root at or below the TDA one."""
    system, ref_system, isdfk, ref_isdfk, states = kpoint
    res, ref_res = states[name], _ref_res(states[name])
    kw = dict(xc=_xc(name), nstates=3, singlet=singlet)
    rpa = ktda.ktddft_kernel(system, res, isdfk=isdfk, **kw)
    rpa_ref = ref_ktda.ktddft_kernel(ref_system, ref_res, isdfk=ref_isdfk, **kw)
    assert np.abs(rpa - rpa_ref).max() < E_TOL
    e, _ = ktda.ktda_davidson(system, res, isdfk=isdfk, **kw)
    e_ref, _ = ref_ktda.ktda_davidson(ref_system, ref_res, isdfk=ref_isdfk, **kw)
    assert np.abs(e - e_ref).max() < DAV_TOL
    if name != "hf":
        assert rpa[0] <= e[0] + 1e-8

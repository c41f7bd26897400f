"""Port open-shell SCF (uhf_kernel, kuhf_kernel) and smeared SCF
(scf_kernel, kscf_kernel with sigma > 0) == JAX reference.

Gamma: the off-symmetry two-carbon cell of the other port tests on a 10^3
mesh with (n_alpha, n_beta) = (6, 2). k-points: the diamond primitive cell
on the same mesh with the shifted (1,1,2) k-mesh and (5, 3) per cell. Both
open shells converge in 8-26 cycles for every functional here. The smeared
SCFs (sigma = 0.05 Ha, Fermi-Dirac and Gaussian) run closed-shell on the
same two systems. All float64 on the CPU. Bars: energies (e_free and mu
too) 1e-8 Ha and <S^2> 1e-8 (converged to 1e-10), equal iteration counts.

Compiling the reference's spin XC costs 2-5 s a functional on one core
(eagerly, its exc_vxc_spin takes one vmap(grad) per argument: tens of
seconds). So the SCF cases hold the two packages' drivers (densities,
gradients, tau, the potential matrices, exchange, DIIS, fillings,
energies) with the reference's own functional for LDA (under one
jax.jit at XLA's backend optimization level 0; both cells have 1000 grid
points, so it compiles once), and with the port's pointwise functional
inside the reference's driver for PBE, PBE0, B3LYP, SCAN and HSE06
(PORT_XC), whose values tests/test_torch_xc.py holds to the reference's
at 1e-12 / 1e-10. The reference's k-point FFTDF exchange runs
eagerly pair by pair (seconds a cycle here), so the k-point cases with
exact exchange take the ISDF engine; the port's k-point FFTDF exchange
is the KRHF one held in test_torch_kscf.py. The reference's ISDF exchange
get_k_kpts jits a new closure, so it compiles again on every call; here
it runs as one jitted function of the same products, held to the
reference's own to 1e-12 on the first call. The reference's closed-shell
XC (the smeared cases) runs under one jax.jit too.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.df import isdf_k as ref_isdf_k  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf import scf_kernel as ref_scf  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_kbuild  # noqa: E402
from pyscf_isdf_tpu.scf.khf import kscf_kernel as ref_kscf  # noqa: E402
from pyscf_isdf_tpu.scf.kuhf import kuhf_kernel as ref_kuhf  # noqa: E402
from pyscf_isdf_tpu.scf.uhf import uhf_kernel as ref_uhf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops import xc  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, kuhf_kernel, scf_kernel,
    uhf_kernel,
)

MESH = (10, 10, 10)
A = [[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834], [1.7834, 1.7834, 0.0]]
ATOMS = [["C", (0.0, 0.0, 0.0)], ["C", (0.93, 0.87, 0.90)]]
NELEC, NELEC_K = (6, 2), (5, 3)
TOL = 1e-8
SIGMA = 0.05
# functionals whose pointwise values the reference's drivers take from the
# port (held to the reference's own in tests/test_torch_xc.py)
PORT_XC = {"pbe", "pbe0", "b3lyp", "scan", "hse06"}


def _cell(build):
    return build(A, ATOMS, "gth-szv", pseudo="gth-pade", mesh=MESH, unit="Angstrom")


def _port_spin_xc(name, method, args):
    """The port's pointwise spin functional on the reference's arrays."""
    out = getattr(xc.XCSpec(name), method)(*(torch.as_tensor(np.array(a)) for a in args))
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), out)


@partial(jax.jit, static_argnums=3)
def _isdf_k_exchange(Ug, Wq, dm, qmap):
    """The reference's get_k_kpts products (pyscf_isdf_tpu/df/isdf_k.py:
    393-403) for all band k-points, in its order of summation."""
    nk = Ug.shape[0]
    M = [Ug[k] @ dm[k] @ Ug[k].conj().T for k in range(nk)]
    out = []
    for k1 in range(nk):
        acc = jnp.zeros((Ug.shape[2], Ug.shape[2]), Ug.dtype)
        for k2 in range(nk):
            acc = acc + Ug[k1].conj().T @ (M[k2] * Wq[qmap[k2][k1]].conj()) @ Ug[k1]
        out.append(acc / nk)
    return jnp.stack(out)


@pytest.fixture(scope="module", autouse=True)
def _reference_compiled_once():
    spin = jax.jit(ref_xc.XCSpec.exc_vxc_spin, static_argnums=0,
                   compiler_options={"xla_backend_optimization_level": 0})
    # the reference's Gamma closed-shell XC runs inside its own jit already
    closed = jax.jit(ref_xc.XCSpec.exc_vxc, static_argnums=0)

    def exc_vxc_spin(self, *a):
        if self.name in PORT_XC:
            return _port_spin_xc(self.name, "exc_vxc_spin", a)
        return spin(self, *a)

    get_k_kpts = ref_isdf_k.get_k_kpts
    checked = []

    def k_kpts(isdfk, dm_k, k1_idx=None):
        assert k1_idx is None
        out = _isdf_k_exchange(isdfk.Ug, isdfk.Wq, jnp.asarray(dm_k, isdfk.Ug.dtype),
                               tuple(map(tuple, np.asarray(isdfk.qmap).tolist())))
        if not checked:
            ref = np.asarray(get_k_kpts(isdfk, dm_k))
            assert np.abs(np.asarray(out) - ref).max() <= 1e-12 * np.abs(ref).max()
            checked.append(True)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_xc.XCSpec, "exc_vxc_spin", exc_vxc_spin)
    mp.setattr(ref_xc.XCSpec, "exc_vxc", lambda self, *a: closed(self, *a))
    mp.setattr(ref_xc.XCSpec, "exc_vxc_mgga_spin",
               lambda self, *a: _port_spin_xc(self.name, "exc_vxc_mgga_spin", a))
    mp.setattr(ref_isdf_k, "get_k_kpts", k_kpts)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def gamma():
    return ref_build(_cell(ref_build_cell)), build_scf_system(_cell(build_cell),
                                                              device="cpu")


@pytest.fixture(scope="module")
def kpoint():
    rcell = ref_diamond(mesh=MESH)
    kpts = ref_lattice.make_kpts(rcell.a, [1, 1, 2], with_gamma_point=False)
    return (ref_kbuild(rcell, kpts),
            build_kscf_system(diamond_primitive(mesh=MESH), kpts, device="cpu"))


@pytest.mark.parametrize("xc,df", [(None, "fftdf"), ("lda", "fftdf"), ("pbe0", "fftdf"),
                                   ("b3lyp", "fftdf"), ("scan", "fftdf"),
                                   ("hse06", "isdf")])
def test_uhf_energy(gamma, xc, df):
    ref_sys, sys_ = gamma
    ref = ref_uhf(ref_sys, xc=xc, df=df, nelec=NELEC, conv_tol=1e-10)
    out = uhf_kernel(sys_, xc=xc, df=df, nelec=NELEC, conv_tol=1e-10)
    assert out["converged"] and ref["converged"]
    assert out["niter"] == ref["niter"] > 2
    assert abs(out["e_tot"] - ref["e_tot"]) < TOL
    assert abs(out["s_squared"] - ref["s_squared"]) < TOL


@pytest.mark.parametrize("xc,df", [(None, "isdf"), ("lda", "fftdf"), ("pbe", "fftdf"),
                                   ("pbe0", "isdf"), ("b3lyp", "isdf"),
                                   ("hse06", "isdf")])
def test_kuhf_energy(kpoint, xc, df):
    ref_sys, sys_ = kpoint
    ref = ref_kuhf(ref_sys, xc=xc, df=df, nelec=NELEC_K, conv_tol=1e-10)
    out = kuhf_kernel(sys_, xc=xc, df=df, nelec=NELEC_K, conv_tol=1e-10, device="cpu")
    assert out["converged"] and ref["converged"]
    assert out["niter"] == ref["niter"] > 2
    assert abs(out["e_tot"] - ref["e_tot"]) < TOL
    for o, r in zip(out["mo_occ"], ref["mo_occ"]):
        assert np.array_equal(np.asarray(o), np.asarray(r))


def test_hf_spelling_and_meta_gga(gamma, kpoint):
    """xc='hf' runs UHF / KUHF in the port; the reference raises for it (it
    spells them xc=None). KUKS takes no meta-GGA in either package."""
    ref_sys, sys_ = gamma
    e0 = ref_uhf(ref_sys, xc=None, nelec=NELEC, conv_tol=1e-10)["e_tot"]
    assert abs(uhf_kernel(sys_, xc="hf", nelec=NELEC, conv_tol=1e-10)["e_tot"] - e0) < TOL
    with pytest.raises(ValueError):
        ref_uhf(ref_sys, xc="hf", nelec=NELEC, max_cycle=1)
    ref_ksys, ksys = kpoint
    with pytest.raises(ValueError):
        ref_kuhf(ref_ksys, xc="scan", nelec=NELEC_K, max_cycle=1)
    with pytest.raises(ValueError, match="meta-GGA"):
        kuhf_kernel(ksys, xc="scan", nelec=NELEC_K, device="cpu")


def test_closed_shell_limits(gamma):
    """Equal spins reproduce the restricted SCF (<S^2> = 0); breaksym and an
    explicit start reach the same state."""
    _, sys_ = gamma
    r = scf_kernel(sys_, xc="pbe", conv_tol=1e-10)
    u = uhf_kernel(sys_, xc="pbe", conv_tol=1e-10)
    assert abs(u["e_tot"] - r["e_tot"]) < TOL and abs(u["s_squared"]) < TOL
    b = uhf_kernel(sys_, xc="pbe", conv_tol=1e-10, breaksym=True)
    assert abs(b["e_tot"] - r["e_tot"]) < TOL
    d = uhf_kernel(sys_, xc="pbe", conv_tol=1e-10, dm0=u["dm"])
    assert d["niter"] <= 2 and abs(d["e_tot"] - u["e_tot"]) < TOL


def test_unported_options_raise(gamma, kpoint):
    """The double-float solves stay unported; aegdf needs a system built
    with ae=True and an unknown XC grid is refused, as in the reference."""
    _, sys_ = gamma
    with pytest.raises(NotImplementedError):
        uhf_kernel(sys_, xc="pbe0", df="isdf", isdf_precision="dd")
    with pytest.raises(ValueError, match="ae=True"):
        uhf_kernel(sys_, xc="pbe0", df="aegdf")
    with pytest.raises(ValueError, match="xc_grids"):
        uhf_kernel(sys_, xc="pbe0", xc_grids="lebedev")
    _, ksys = kpoint
    with pytest.raises(NotImplementedError):
        kuhf_kernel(ksys, xc="pbe0", device="cpu", df="isdf", isdf_precision="dd")
    with pytest.raises(ValueError, match="xc_grids"):
        kuhf_kernel(ksys, xc="pbe0", device="cpu", xc_grids="lebedev")


def _same(out, ref):
    assert out["converged"] and ref["converged"]
    assert out["niter"] == ref["niter"]
    for key in ("e_tot", "e_free", "mu"):
        assert abs(out[key] - ref[key]) < 1e-8, key
    assert out["e_free"] < out["e_tot"] or out["entropy"] < 1e-12


@pytest.mark.parametrize("xc,method", [("lda,vwn", "fermi"), (None, "gauss")])
def test_smeared_scf(gamma, xc, method):
    """Gamma; HF takes the full exchange build (occupied-MO exchange is
    off while smeared)."""
    ref_sys, sys_ = gamma
    kw = dict(xc=xc, sigma=SIGMA, smearing_method=method, conv_tol=1e-10)
    out = scf_kernel(sys_, **kw)
    _same(out, ref_scf(ref_sys, **kw))
    assert abs(float(out["mo_occ"].sum()) - sys_.nelec) < 1e-10


@pytest.mark.parametrize("method", ["fermi", "gauss"])
def test_smeared_kscf(kpoint, method):
    ref_sys, sys_ = kpoint
    kw = dict(xc="lda,vwn", sigma=SIGMA, smearing_method=method, conv_tol=1e-10)
    out = kscf_kernel(sys_, device="cpu", **kw)
    _same(out, ref_kscf(ref_sys, **kw))
    assert abs(sum(o.sum() for o in out["mo_occ"]) - sys_.nelec_tot) < 1e-10

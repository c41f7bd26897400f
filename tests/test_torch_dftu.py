"""Port DFT+U (scf/dftu.py, kscf_kernel(hubbard=)) and constrained DFT
(scf/cdft.py) == JAX reference.

DFT+U on the diamond primitive cell (8^3 mesh, shifted (2,1,1) k-mesh) as
in tests/test_dftu.py; cDFT on tests/test_cdft.py's H2 cell on a 12^3
mesh. All float64 on the CPU. Bars: E_U 1e-12 and V_U 1e-12 on the same
density, SCF energies 1e-8 Ha with equal iteration counts, the
constrained population 1e-6 and the multiplier 1e-6 as the reference's
secant tolerance leaves them (both runs take the same secant steps).

The reference's closed-shell XC runs under one jax.jit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.scf import hf as ref_hf, khf as ref_khf  # noqa: E402
from pyscf_isdf_tpu.scf import cdft as ref_cdft  # noqa: E402
from pyscf_isdf_tpu.scf.dftu import HubbardU as RefHubbardU  # noqa: E402
from pyscf_isdf_tpu.scf.khf import kscf_kernel as ref_kscf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell, symm  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, cdft_kernel, kscf_kernel, scf_kernel,
)
from pyscf_isdf_tpu_torch.scf.cdft import lowdin_population_op, orbital_shift  # noqa: E402
from pyscf_isdf_tpu_torch.scf.dftu import HubbardU  # noqa: E402

MESH = (8, 8, 8)
TOL = 1e-8


def _ref_system(rcell, sys_):
    """The reference's SCFSystem on the port's setup arrays (held to the
    reference's own build in tests/test_torch_host.py, 1e-12)."""
    return ref_hf.SCFSystem(
        cell=rcell, S=sys_.S.numpy(), hcore=sys_.hcore.numpy(), X=sys_.X.numpy(),
        aoR=jnp.asarray(sys_.aoR.numpy()), coulG=sys_.coulG.numpy(),
        madelung=sys_.madelung, e_nuc=sys_.e_nuc, mesh=sys_.mesh, weight=sys_.weight,
        nelec=sys_.nelec, Gv=sys_.Gv.numpy())


def _ref_ksystem(rcell, sys_):
    """The reference's KSCFSystem on the port's setup arrays (held to the
    reference's own build in tests/test_torch_kscf.py, 1e-12): a second
    host build costs more than every comparison here."""
    return ref_khf.KSCFSystem(
        cell=rcell, kpts=sys_.kpts, S=sys_.S.numpy(), hcore=sys_.hcore.numpy(),
        X=np.stack([x.numpy() for x in sys_.X]), aoR_k=jnp.asarray(sys_.aoR_k.numpy()),
        coulG=sys_.coulG.numpy(), coulG_pairs=sys_.coulG_pairs.numpy(),
        expmikr=sys_.expmikr.numpy(), madelung=sys_.madelung, e_nuc=sys_.e_nuc,
        mesh=sys_.mesh, weight=sys_.weight, nelec_tot=sys_.nelec_tot)


@pytest.fixture(scope="module", autouse=True)
def _reference_compiled_once():
    closed = jax.jit(ref_xc.XCSpec.exc_vxc, static_argnums=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_xc.XCSpec, "exc_vxc", lambda self, *a: closed(self, *a))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def kpoint():
    rcell = ref_diamond(mesh=MESH)
    kpts = ref_lattice.make_kpts(rcell.a, [2, 1, 1], with_gamma_point=False)
    sys_ = build_kscf_system(diamond_primitive(mesh=MESH), kpts, device="cpu")
    return _ref_ksystem(rcell, sys_), sys_


def test_hubbard_terms(kpoint):
    """Projectors, E_U and V_U on one density, by atom symbol and index,
    on the k-point overlaps and on a Gamma overlap."""
    ref_sys, sys_ = kpoint
    dm = kscf_kernel(sys_, xc="lda,vwn", conv_tol=1e-8, device="cpu")["dm"]
    for specs in ([("C", 1, 0.3)], [(0, 0, 0.2), (1, 1, 0.1)]):
        e_u, v_u = HubbardU(sys_.cell, sys_.S, specs).energy_and_potential(dm)
        e0, v0 = RefHubbardU(ref_sys.cell, ref_sys.S, specs).energy_and_potential(dm.numpy())
        assert abs(e_u - e0) < 1e-12
        assert np.abs(v_u.numpy() - v0).max() < 1e-12
    g = HubbardU(sys_.cell, sys_.S[0], [("C", 1, 0.3)]).energy_and_potential(dm[0])
    g0 = RefHubbardU(ref_sys.cell, ref_sys.S[0], [("C", 1, 0.3)]).energy_and_potential(
        dm[0].numpy())
    assert abs(g[0] - g0[0]) < 1e-12 and np.abs(g[1].numpy() - g0[1]).max() < 1e-12
    with pytest.raises(ValueError, match="no l=2 shell"):
        HubbardU(sys_.cell, sys_.S, [("C", 2, 0.1)])


def test_kscf_hubbard(kpoint):
    """kscf_kernel(hubbard=) against the reference at U = 0.1 Ha (1e-8 Ha,
    equal counts); in the port: U = 0 is the plain SCF, the energy rises
    with U, and the Hellmann-Feynman slope at dU = 1e-4 is E_U(U=1) at the
    U=0 density (1e-3 relative, tests/test_dftu.py's bar)."""
    ref_sys, sys_ = kpoint
    kw = dict(xc="lda,vwn", conv_tol=1e-10)
    out = kscf_kernel(sys_, hubbard=[("C", 1, 0.1)], device="cpu", **kw)
    ref = ref_kscf(ref_sys, hubbard=[("C", 1, 0.1)], **kw)
    assert out["converged"] and ref["converged"]
    assert out["niter"] == ref["niter"] > 2
    assert abs(out["e_tot"] - ref["e_tot"]) < TOL
    plain = kscf_kernel(sys_, device="cpu", **kw)
    zero = kscf_kernel(sys_, hubbard=[("C", 1, 0.0)], device="cpu", **kw)
    assert abs(zero["e_tot"] - plain["e_tot"]) < 1e-10
    assert 0.0 < out["e_tot"] - plain["e_tot"] < 0.5
    e1 = HubbardU(sys_.cell, sys_.S, [("C", 1, 1.0)]).energy_and_potential(plain["dm"])[0]
    tight = dict(xc="lda,vwn", conv_tol=1e-11)
    slope = (kscf_kernel(sys_, hubbard=[("C", 1, 1e-4)], device="cpu", **tight)["e_tot"]
             - kscf_kernel(sys_, device="cpu", **tight)["e_tot"]) / 1e-4
    assert slope == pytest.approx(e1, rel=1e-3)


def test_hubbard_with_ibz_raises(kpoint):
    _, sys_ = kpoint
    info = symm.IBZInfo(kpts=sys_.kpts, ibz_idx=np.arange(2), weights=np.ones(2),
                        bz2ibz=np.arange(2), op_idx=np.zeros(2, dtype=np.int64),
                        tr=np.zeros(2, dtype=bool), ops=())
    with pytest.raises(ValueError, match="hubbard"):
        kscf_kernel(sys_, xc="lda,vwn", hubbard=[("C", 1, 0.1)], ibz=info, device="cpu")


def _h2(build):
    return build(6.0 * np.eye(3), [["H", (2.3, 3.0, 3.0)], ["H", (3.7, 3.0, 3.0)]],
                 basis="gth-szv", pseudo="gth-pade", mesh=[12] * 3)


@pytest.fixture(scope="module")
def h2():
    sys_ = build_scf_system(_h2(build_cell), device="cpu")
    return _ref_system(_h2(ref_build_cell), sys_), sys_


def test_constraint_operators(h2):
    ref_sys, sys_ = h2
    c = np.array([0.6, -0.2])
    assert np.abs(orbital_shift(sys_.S, c, 2.0).numpy()
                  - ref_cdft.orbital_shift(ref_sys.S, c, 2.0)).max() < 1e-12
    assert np.abs(lowdin_population_op(sys_.S, [0]).numpy()
                  - ref_cdft.lowdin_population_op(ref_sys.S, [0])).max() < 1e-12


def test_cdft_kernel(h2):
    """The charge constraint against the reference's: the same secant
    steps, energy 1e-8 Ha, population at the target; above the
    unconstrained energy with lam > 0."""
    ref_sys, sys_ = h2
    res0 = scf_kernel(sys_, xc="lda,vwn", conv_tol=1e-11)
    n0 = float(torch.einsum("ij,ji->", lowdin_population_op(sys_.S, [0]), res0["dm"]))
    out = cdft_kernel(sys_, "lda,vwn", [0], n0 - 0.3, conv_tol=1e-11, device="cpu")
    ref = ref_cdft.cdft_kernel(ref_sys, "lda,vwn", [0], n0 - 0.3, conv_tol=1e-11)
    assert abs(out["e_tot"] - ref["e_tot"]) < TOL
    assert abs(out["lam"] - ref["lam"]) < 1e-6
    assert abs(out["population"] - (n0 - 0.3)) < 1e-6
    assert out["lam"] > 0 and out["e_tot"] > res0["e_tot"] and out["n_scf"] >= 3

"""Port k-point setup, FFTDF J/K and SCF == JAX reference.

Both packages build the same diamond primitive cell on a 9^3 mesh with a
shifted (1,1,2) k-mesh: k = +-b3/4, neither zero nor its own inverse, so
a flipped sign in a Bloch phase shows. The port runs on the CPU in
float64. Bars: 1e-12 for the host setup (the same closed forms summed in
another order), 1e-10 for J/K at a random Hermitian density (FFTs in
another order), 1e-8 Ha for SCF energies converged to 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.df import fftdf_k as ref_fftdf_k  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import coulomb as ref_coulomb, pp as ref_pp  # noqa: E402
from pyscf_isdf_tpu.ops import xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.ops.ft_ao import overlap_and_kinetic as ref_st  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf.khf import kscf_kernel as ref_kscf  # noqa: E402

from pyscf_isdf_tpu_torch import kpts_helper  # noqa: E402
from pyscf_isdf_tpu_torch.convert import kscf_system_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.df import fftdf_k  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops import coulomb, pp  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ft_ao import overlap_and_kinetic  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_kscf_system, kscf_kernel  # noqa: E402

MESH = (9, 9, 9)
NKS = [1, 1, 2]


@pytest.fixture(scope="module", autouse=True)
def _reference_xc_compiled_once():
    """The reference's XC as one XLA program. Its exc_vxc runs eagerly,
    so autodiff of PBE compiles each primitive on its own (about 4 s on
    one core, the larger part of this file's time); under jax.jit the
    same float64 function compiles once (about 1 s)."""
    jitted = jax.jit(ref_xc.XCSpec.exc_vxc, static_argnums=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_xc.XCSpec, "exc_vxc",
               lambda self, rho, sigma=None: jitted(self, rho, sigma))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def systems():
    rcell = ref_diamond(mesh=MESH)
    kpts = ref_lattice.make_kpts(rcell.a, NKS, with_gamma_point=False)
    cell = diamond_primitive(mesh=MESH)
    return (rcell, ref_build(rcell, kpts), cell,
            build_kscf_system(cell, kpts, device="cpu"), kpts)


@pytest.fixture(scope="module")
def ref_krhf(systems):
    """The reference's KRHF energy (xc=None; its xc='hf' raises)."""
    return ref_kscf(systems[1], xc=None, conv_tol=1e-10)["e_tot"]


def test_host_setup_per_k(systems):
    rcell, ref, cell, port, kpts = systems
    for ik, k in enumerate(kpts):
        S0, T0 = ref_st(rcell, kpt=k)
        S, T = overlap_and_kinetic(cell, kpt=k, device="cpu")
        assert np.abs(S.numpy() - S0).max() < 1e-12
        assert np.abs(T.numpy() - T0).max() < 1e-12
        v0 = ref_pp.get_vppnl(rcell, kpt=k)
        assert np.abs(pp.get_vppnl(cell, kpt=k, device="cpu").numpy() - v0).max() < 1e-12
        # the reference's aoR_k is eval_ao_numpy(kpt=k)
        assert np.abs(port.aoR_k[ik].numpy() - np.asarray(ref.aoR_k[ik])).max() < 1e-12
    assert np.abs(port.S.numpy() - ref.S).max() < 1e-12
    assert np.abs(port.hcore.numpy() - ref.hcore).max() < 1e-12


@pytest.mark.parametrize("exxdiv,omega", [(None, None), ("ewald", None),
                                          (None, 0.11), (None, -0.11)])
def test_coulomb_kernels(systems, exxdiv, omega):
    """Kernels at one k-point transfer; with omega the long-range (> 0)
    and short-range (< 0) ones, the per-pair tables and the long-range
    Madelung constant."""
    rcell, ref, cell, port, kpts = systems
    q = kpts[1] - kpts[0]
    out = coulomb.get_coulG(cell, k=q, exxdiv=exxdiv, kpts=kpts, omega=omega)
    assert np.abs(out - ref_coulomb.get_coulG(rcell, k=q, exxdiv=exxdiv,
                                              kpts=kpts, omega=omega)).max() < 1e-12
    if omega is not None:
        cp = fftdf_k.make_k_kernels(cell, kpts, omega=omega)[0]
        cp0 = ref_fftdf_k.make_k_kernels(rcell, kpts, omega=omega)[0]
        assert np.abs(cp - cp0).max() < 1e-12
        assert abs(coulomb.madelung_omega(cell, kpts, omega)
                   - ref_coulomb.madelung_omega(rcell, kpts, omega)) < 1e-12
    assert abs(coulomb.madelung(cell, kpts) - ref_coulomb.madelung(rcell, kpts)) < 1e-12
    assert np.abs(port.coulG_pairs.numpy() - ref.coulG_pairs).max() < 1e-12
    assert np.abs(port.expmikr.numpy() - ref.expmikr).max() < 1e-12
    # 'vcut_sph' at a k-point transfer: the radius from the k-mesh's size
    cut = coulomb.get_coulG(cell, k=q, exxdiv="vcut_sph", kpts=kpts)
    assert np.abs(cut - ref_coulomb.get_coulG(rcell, k=q, exxdiv="vcut_sph",
                                              kpts=kpts)).max() < 1e-12


def test_kconserv():
    from pyscf_isdf_tpu.kpts_helper import get_kconserv as ref_kconserv

    cell = diamond_primitive(mesh=MESH)
    kpts = ref_lattice.make_kpts(cell.a, [2, 2, 1], with_gamma_point=False)
    assert np.array_equal(kpts_helper.get_kconserv(cell.a, kpts),
                          ref_kconserv(cell.a, kpts))


def test_fftdf_k_jk(systems):
    """J, K and occupied-MO K at a random Hermitian density."""
    _, ref, _, port, _ = systems
    nk, nao = ref.S.shape[:2]
    rng = np.random.default_rng(5)
    C = rng.standard_normal((nk, nao, 3)) + 1j * rng.standard_normal((nk, nao, 3))
    dm = C @ C.conj().transpose(0, 2, 1)
    w = ref.weight / nk
    vj0 = np.asarray(ref_fftdf_k.get_j_kpts(ref.aoR_k, dm, ref.coulG, ref.mesh,
                                            ref.weight))
    vk0 = np.asarray(ref_fftdf_k.get_k_kpts(ref.aoR_k, dm, ref.coulG_pairs,
                                            ref.expmikr, ref.mesh, w))
    dmt = torch.as_tensor(dm)
    vj = fftdf_k.get_j_kpts(port.aoR_k, dmt, port.coulG, port.mesh, port.weight)
    vk = fftdf_k.get_k_kpts(port.aoR_k, dmt, port.coulG_pairs, port.expmikr,
                            port.mesh, w)
    vk_occ = fftdf_k.get_k_kpts_occ(port.aoR_k, port.aoR_k @ torch.as_tensor(C),
                                    port.coulG_pairs, port.expmikr, port.mesh, w)
    for out, ref_out in ((vj, vj0), (vk, vk0), (vk_occ, vk0)):
        assert np.abs(out.numpy() - ref_out).max() < 1e-10 * np.abs(ref_out).max()


@pytest.mark.parametrize("xc,df", [("hf", "fftdf"), ("pbe0", "isdf_q"),
                                   ("lda,vwn", "isdf"), ("hse06", "isdf_q")])
def test_kscf_energy(systems, request, xc, df):
    """The reference spells KRHF xc=None: its kscf_kernel raises for
    xc='hf' (ROADMAP queue 3); the port takes either."""
    _, ref, _, port, _ = systems
    if xc == "hf":
        e0 = request.getfixturevalue("ref_krhf")
    else:
        res0 = ref_kscf(ref, xc=xc, df=df, isdf_c=8, conv_tol=1e-10)
        assert res0["converged"]
        e0 = res0["e_tot"]
    out = kscf_kernel(port, xc=xc, df=df, isdf_c=8, conv_tol=1e-10, device="cpu")
    assert out["converged"]
    assert out["niter"] > 2
    assert abs(out["e_tot"] - e0) < 1e-8


def test_kscf_on_reference_system(systems, ref_krhf):
    """The reference's k-system carried across by kscf_system_from_numpy,
    and the reference's KRHF under the port's xc='hf' spelling."""
    _, ref, cell, _, kpts = systems
    port = kscf_system_from_numpy(
        cell, kpts, ref.S, ref.hcore, ref.X, np.asarray(ref.aoR_k), ref.coulG,
        ref.coulG_pairs, ref.expmikr, ref.madelung, ref.e_nuc, device="cpu")
    assert abs(kscf_kernel(port, xc="hf", conv_tol=1e-10, device="cpu")["e_tot"]
               - ref_krhf) < 1e-8
    with pytest.raises(ValueError, match="pure HF"):
        ref_kscf(ref, xc="hf", conv_tol=1e-10)


def test_ragged_orthogonalizers(systems):
    """Per-k orthogonalizers of different rank: the eigensolve goes k by
    k, equals the batched one where the ranks agree, and the SCF in the
    smaller space converges at or above the full-space energy."""
    import dataclasses

    from pyscf_isdf_tpu_torch.scf.khf import _eig_all

    _, _, _, port, _ = systems
    e_b, c_b = _eig_all(port.hcore, port.X)
    e_l, c_l = _eig_all(port.hcore, port.X[:1] + (port.X[1][:, :-1],))
    e_0, _ = _eig_all(port.hcore[:1], port.X[:1])
    assert (e_l[0] - e_b[0]).abs().max() < 1e-12 and (e_0[0] - e_b[0]).abs().max() < 1e-12
    assert len(e_l[1]) == len(e_b[1]) - 1
    ragged = dataclasses.replace(port, X=port.X[:1] + (port.X[1][:, :-1],))
    full = kscf_kernel(port, xc="lda,vwn", conv_tol=1e-10, device="cpu")
    out = kscf_kernel(ragged, xc="lda,vwn", conv_tol=1e-10, device="cpu")
    assert out["converged"] and out["e_tot"] > full["e_tot"] - 1e-10


def test_unported_options_raise(systems):
    """The double-float solves stay unported; aegdf needs a system built
    with ae=True, and an unknown XC grid or engine is refused."""
    _, _, cell, port, kpts = systems
    with pytest.raises(NotImplementedError):
        kscf_kernel(port, device="cpu", xc="pbe0", isdf_precision="dd", df="isdf_q")
    with pytest.raises(ValueError, match="ae=True"):
        kscf_kernel(port, device="cpu", xc=None, df="aegdf")
    with pytest.raises(ValueError, match="xc_grids"):
        kscf_kernel(port, device="cpu", xc="pbe0", xc_grids="lebedev")
    with pytest.raises(ValueError, match="unknown df"):
        kscf_kernel(port, device="cpu", xc="pbe0", df="rsdf")

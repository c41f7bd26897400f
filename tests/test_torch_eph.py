"""Port electron-phonon coupling (eph/) and get_vppnl(pp_coords=) == JAX
reference.

The reference's eph tests (tests/test_eph.py) are slow (diamond primitive
12^3 and 14^3, twelve displaced SCFs with forces each). Here the cell is
an H2 molecule in a 6 bohr box on a 10^3 mesh (two atoms, the same twelve
displacements). The pieces are held on one state: the nonlocal projectors
placed at other centres (1e-12), the potential and frozen grids of
``_v_and_frozen`` for the LDA, GGA, global-hybrid and range-separated
branches and ``_frozen_matrix`` in a displaced basis (1e-10), then one
displaced step's SCF (equal iteration counts, 1e-10 Ha) and force (1e-9)
against the reference's. ``eph_kernel`` is held against the reference's
``eph_kernel`` on the same systems and SCF states (the port's, on the
reference's arrays; :func:`same_states` says why): vmat and g at 1e-7
relative to their largest entry, the frequencies at 1e-6 relative, with
equal SCF iteration counts. All float64 on the CPU.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu.eph import eph_fd as ref_eph  # noqa: E402
from pyscf_isdf_tpu.grad.rhf import rhf_gradient as ref_rhf_gradient  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import pp as ref_pp  # noqa: E402
from pyscf_isdf_tpu.ops.xc import XCSpec as RefXCSpec  # noqa: E402
from pyscf_isdf_tpu.scf.hf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf.hf import scf_kernel as ref_scf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.convert import system_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.eph import eph_fd, eph_kernel  # noqa: E402
from pyscf_isdf_tpu_torch.grad.rhf import rhf_gradient  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops import pp  # noqa: E402
from pyscf_isdf_tpu_torch.ops.xc import XCSpec  # noqa: E402
from pyscf_isdf_tpu_torch.scf import scf_kernel  # noqa: E402

L = 6.0
DISP = 2e-3


def _h2(build):
    return build(np.eye(3) * L, [["H", (L / 2 - 0.7, L / 2, L / 2)],
                                 ["H", (L / 2 + 0.7, L / 2 + 0.05, L / 2)]],
                 "gth-szv", pseudo="gth-pade", mesh=[10] * 3)


def _np(res):
    return {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in res.items()}


def _port_on(ref_sys, cell):
    return system_from_numpy(cell, ref_sys.S, ref_sys.hcore, ref_sys.X,
                             np.asarray(ref_sys.aoR), ref_sys.coulG, ref_sys.madelung,
                             ref_sys.e_nuc, device="cpu")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("kpt", [None, (0.1, -0.2, 0.3)])
def test_get_vppnl_pp_coords(kpt):
    """Projectors pinned at other centres than the AOs, against the
    reference (1e-12); with pp_coords=None the matrix is bitwise the one of
    pp_coords=cell.coords."""
    cell = diamond_primitive(mesh=(10,) * 3)
    ref_cell = ref_diamond(mesh=(10,) * 3)
    shift = np.array([[0.05, -0.02, 0.01], [0.0, 0.03, -0.04]])
    moved = replace(cell, coords=np.asarray(cell.coords) + shift)
    ref_moved = replace(ref_cell, coords=np.asarray(ref_cell.coords) + shift)
    out = pp.get_vppnl(moved, kpt=kpt, device="cpu", pp_coords=cell.coords).numpy()
    ref = np.asarray(ref_pp.get_vppnl(ref_moved, kpt=kpt, pp_coords=ref_cell.coords))
    if kpt is None:
        ref = ref.real
    assert np.abs(out - ref).max() < 1e-12
    assert np.abs(out - pp.get_vppnl(moved, kpt=kpt, device="cpu").numpy()).max() > 1e-4
    assert torch.equal(pp.get_vppnl(cell, kpt=kpt, device="cpu"),
                       pp.get_vppnl(cell, kpt=kpt, device="cpu", pp_coords=cell.coords))


@pytest.fixture(scope="module")
def h2():
    """The reference's H2 system and the port's on its arrays."""
    ref_sys = ref_build(_h2(ref_build_cell))
    return ref_sys, _port_on(ref_sys, _h2(build_cell))


@pytest.mark.parametrize("xc", ["lda,vwn", "pbe", "pbe0", "hse06"])
def test_v_and_frozen_and_frozen_matrix(h2, xc):
    """The central potential and its frozen grids, and the frozen potential
    in a displaced basis, on one state (the port's SCF), against the
    reference's (1e-10)."""
    ref_sys, sys_ = h2
    res = scf_kernel(sys_, xc=xc, conv_tol=1e-12)
    V, frozen, family = eph_fd._v_and_frozen(sys_.cell, sys_, res, XCSpec(xc))
    rV, rfrozen, rfamily = ref_eph._v_and_frozen(ref_sys.cell, ref_sys, _np(res),
                                                 RefXCSpec(xc))
    assert family == rfamily
    assert np.abs(V.numpy() - rV).max() < 1e-10
    for key in ("vlocR", "vHR", "vrho", "vsigma", "grho", "mo_w_grid", "coulG_lr"):
        if key in rfrozen:
            assert np.abs(_t(frozen[key]) - _t(rfrozen[key])).max() \
                < 1e-10 * max(1.0, np.abs(_t(rfrozen[key])).max()), key
    c0 = np.asarray(sys_.cell.coords)
    c = c0.copy()
    c[1, 0] += DISP / 2
    ref_d = ref_build(replace(ref_sys.cell, coords=c))
    sys_d = _port_on(ref_d, replace(sys_.cell, coords=c))
    B = eph_fd._frozen_matrix(sys_d.cell, sys_d, frozen, family, c0)
    rB = ref_eph._frozen_matrix(ref_d.cell, ref_d, rfrozen, rfamily, c0)
    assert np.abs(B.numpy() - rB).max() < 1e-10


def test_displaced_step(h2):
    """One displaced step: the SCF from the central density (equal
    iterations, 1e-10 Ha), V - B (1e-10) and the force (1e-9), each
    package on its own SCF."""
    ref_sys, sys_ = h2
    res0 = scf_kernel(sys_, xc="lda,vwn", conv_tol=1e-12)
    _, frozen, family = eph_fd._v_and_frozen(sys_.cell, sys_, res0, XCSpec("lda,vwn"))
    _, rfrozen, _ = ref_eph._v_and_frozen(ref_sys.cell, ref_sys, _np(res0),
                                          RefXCSpec("lda,vwn"))
    c0 = np.asarray(sys_.cell.coords)
    c = c0.copy()
    c[0, 2] -= DISP / 2
    ref_d = ref_build(replace(ref_sys.cell, coords=c))
    sys_d = _port_on(ref_d, replace(sys_.cell, coords=c))
    res = scf_kernel(sys_d, xc="lda,vwn", conv_tol=1e-12, dm0=res0["dm"])
    rres = ref_scf(ref_d, xc="lda,vwn", conv_tol=1e-12, dm0=res0["dm"].numpy())
    assert res["niter"] == rres["niter"]
    assert abs(res["e_tot"] - rres["e_tot"]) < 1e-10
    VB = (eph_fd._v_and_frozen(sys_d.cell, sys_d, res, XCSpec("lda,vwn"))[0]
          - eph_fd._frozen_matrix(sys_d.cell, sys_d, frozen, family, c0)).numpy()
    rVB = ref_eph._v_and_frozen(ref_d.cell, ref_d, _np(res), RefXCSpec("lda,vwn"))[0] \
        - ref_eph._frozen_matrix(ref_d.cell, ref_d, rfrozen, family, c0)
    assert np.abs(VB - rVB).max() < 1e-10
    g = _t(rhf_gradient(sys_d, res, xc="lda,vwn", device="cpu"))
    # the reference's autodiff under one jax.jit at XLA's backend
    # optimization level 0 (tests/test_torch_grad.py's arrangement)
    vg = jax.value_and_grad
    jax.value_and_grad = lambda f, *a, **k: jax.jit(
        vg(f, *a, **k), compiler_options={"xla_backend_optimization_level": 0})
    try:
        g_ref = np.asarray(ref_rhf_gradient(ref_d, _np(res), xc="lda,vwn"))
    finally:
        jax.value_and_grad = vg
    assert np.abs(g - g_ref).max() < 1e-9


@pytest.fixture
def same_states(monkeypatch):
    """Both eph_kernels on the same systems and SCF states: the port's
    displaced systems carried from the reference's arrays (``convert``),
    and the reference's SCFs and forces the port's on those arrays. Two
    independent SCFs with equal iteration counts agree to about 1e-9 in V
    (energies to 1e-10 Ha, :func:`test_displaced_step`), which the 2e-3
    finite difference turns into 3.5e-6 of vmat; on one state the two
    packages' finite differences, frozen-potential corrections and mode
    projections are compared; each force is computed once for both.
    Records the SCF iteration counts the reference's kernel was given."""
    niter = []

    def ref_of(cell):
        return ref_build(replace(_h2(ref_build_cell), coords=np.asarray(cell.coords)))

    def port_build(cell, device=None):
        return _port_on(ref_of(cell), cell)

    def port_of(ref_sys):
        return _port_on(ref_sys, replace(_h2(build_cell),
                                         coords=np.asarray(ref_sys.cell.coords)))

    def ref_scf_on_port(ref_sys, xc=None, conv_tol=1e-10, dm0=None):
        dm0 = None if dm0 is None else torch.as_tensor(np.asarray(dm0))
        res = scf_kernel(port_of(ref_sys), xc=xc, conv_tol=conv_tol, dm0=dm0)
        niter.append(int(res["niter"]))
        return _np(res)

    forces = {}

    def grad(system, res, xc=None, device=None):
        """The port's force, computed once for a geometry and density (the
        two kernels reach the same states)."""
        key = (np.asarray(system.cell.coords).tobytes(), _t(res["dm"]).tobytes(), xc)
        if key not in forces:
            forces[key] = _t(rhf_gradient(system, res, xc=xc, device="cpu"))
        return forces[key]

    def ref_grad(ref_sys, res, xc=None):
        res = {k: (torch.as_tensor(np.asarray(v)) if k in ("dm", "mo_coeff", "mo_energy")
                   else v) for k, v in res.items()}
        return grad(port_of(ref_sys), res, xc=xc)

    monkeypatch.setattr(eph_fd, "build_scf_system", port_build)
    monkeypatch.setattr(eph_fd, "rhf_gradient", grad)
    monkeypatch.setattr(ref_eph, "scf_kernel", ref_scf_on_port)
    monkeypatch.setattr(ref_eph, "rhf_gradient", ref_grad)
    return niter


def test_eph_kernel(same_states):
    """eph_kernel (LDA, disp 2e-3) against the reference's: vmat, g and the
    Hessian at 1e-7 relative, the frequencies at 1e-6 relative, equal SCF
    iteration counts; the couplings hermitian in the MO basis."""
    out = eph_kernel(_h2(build_cell), xc="lda,vwn", disp=DISP, device="cpu")
    ref = ref_eph.eph_kernel(_h2(ref_build_cell), xc="lda,vwn", disp=DISP)
    assert out.niter == same_states
    assert _rel(out.vmat, ref.vmat) < 1e-7
    assert _rel(out.hessian, ref.hessian) < 1e-7
    assert _rel(out.omega, ref.omega) < 1e-6
    assert out.g.shape == ref.g.shape
    # the modes are fixed up to sign: the couplings' squares
    assert _rel(out.g ** 2, ref.g ** 2) < 1e-7
    assert np.abs(out.g - out.g.transpose(0, 2, 1)).max() < 1e-6


def test_eph_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        eph_kernel(_h2(build_cell))

"""Port host setup (S, T, hcore, coulG, Ewald, Madelung) == JAX reference.

Both packages build the same cell from the same inputs; the port runs on
the CPU in float64. Tolerance 1e-12: the same closed forms evaluated in a
different summation order differ at the 1e-14 level.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401

from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import coulomb as ref_coulomb  # noqa: E402
from pyscf_isdf_tpu.ops.ft_ao import overlap_and_kinetic as ref_st  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402

from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops import coulomb  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ft_ao import overlap_and_kinetic  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system  # noqa: E402

MESH = (12, 12, 12)
TOL = 1e-12


@pytest.fixture(scope="module")
def systems():
    ref = ref_build(ref_diamond(mesh=MESH))
    port = build_scf_system(diamond_primitive(mesh=MESH), device="cpu")
    return ref, port


@pytest.mark.parametrize("basis", ["gth-szv", "gth-dzvp"])
def test_overlap_kinetic(basis):
    S0, T0 = ref_st(ref_diamond(mesh=MESH, basis=basis))
    S, T = overlap_and_kinetic(diamond_primitive(mesh=MESH, basis=basis),
                               device="cpu")
    assert np.abs(S.numpy() - S0).max() < TOL
    assert np.abs(T.numpy() - T0).max() < TOL


def test_hcore_and_coulomb_constants(systems):
    ref, port = systems
    assert np.abs(port.S.numpy() - ref.S).max() < TOL
    assert np.abs(port.hcore.numpy() - ref.hcore).max() < TOL
    assert np.abs(port.coulG.numpy() - ref.coulG).max() < TOL
    assert abs(port.e_nuc - ref.e_nuc) < TOL
    assert abs(port.madelung - ref.madelung) < TOL


@pytest.mark.parametrize("exxdiv,omega", [(None, None), ("ewald", None),
                                          ("vcut_sph", None), (None, 0.11),
                                          (None, -0.11), ("ewald", 0.11)])
def test_coulG_exxdiv(exxdiv, omega):
    """Gamma kernels; with omega the long-range (> 0) and short-range (< 0)
    ones, and the long-range Madelung constant."""
    ref = ref_coulomb.get_coulG(ref_diamond(mesh=MESH), exxdiv=exxdiv, omega=omega)
    out = coulomb.get_coulG(diamond_primitive(mesh=MESH), exxdiv=exxdiv, omega=omega)
    assert np.abs(out - ref).max() < TOL
    if omega is not None:
        assert abs(coulomb.madelung_omega(diamond_primitive(mesh=MESH), None, omega)
                   - ref_coulomb.madelung_omega(ref_diamond(mesh=MESH), None, omega)) < TOL


def test_ewald_madelung_dzvp_cell():
    assert abs(coulomb.ewald(diamond_primitive(mesh=MESH, basis="gth-dzvp"))
               - ref_coulomb.ewald(ref_diamond(mesh=MESH, basis="gth-dzvp"))) < TOL


K_MODULES = ("kpts_helper", "k2gamma", "convert", "scf.khf", "scf.occupations",
             "df.fftdf_k", "df.isdf_k", "df.isdf_q", "df.isdf_sym",
             "scf.jit_diis", "scf.jit_driver", "ops.xc_mgga", "scf.uhf",
             "scf.kuhf", "symm", "scf.khf_ksymm", "df.fft_ao2mo", "mp.mp2", "mp.thc",
             "mp.kmp2", "scf.rohf", "scf.krohf", "scf.kghf", "scf.dftu", "scf.cdft",
             "scf.bands", "scf.analysis", "mp.kmp2_stagger", "ops.becke", "ops.pme",
             "ops.md_int", "ops.md_int_k", "df.gdf", "df.aftdf", "df.aegdf",
             "scf.x2c", "basis.nwchem", "grad", "grad.rhf", "grad.uhf", "grad.khf",
             "grad.kuhf", "grad.stress", "grad.kstress", "grad.optimize", "tdscf",
             "tdscf.rks", "tdscf.response", "tdscf.ktda", "gw", "gw.rgw",
             "gw.gw_exact", "gw.krgw", "gw.ugw", "gw.gw_cd", "eph", "eph.eph_fd",
             "cc", "cc.gccsd", "cc.kccsd_blocked", "cc.krccsd", "cc.kccsd", "cc.fci",
             "cc.cisd", "cc.eom", "cc.density", "cc.adc", "parallel",
             "parallel.mesh", "parallel.distributed_fft", "parallel.isdf_sharded",
             "parallel.scf_step", "parallel.isdf_k_sharded", "parallel.gw_sharded",
             "frontend", "tools", "utils.config", "utils.logger", "utils.chkfile",
             "utils.misc", "utils.profiling")


def test_port_imports_no_jax():
    """Importing every port module, the k-point ones, the graph drivers, the
    meta-GGAs, the open-shell drivers, the IBZ SCF, MP2, the remaining
    mean-field drivers and bands, and the Becke grids, PME, the
    all-electron integrals, GDF, AFTDF, aegdf and X2C, the forces, stress
    and linear-response packages (grad, tdscf), GW, RPA and the
    electron-phonon coupling (gw, eph), coupled cluster (cc), the
    multi-rank layer (parallel), the object API (frontend) and the tools and
    utils named, leaves jax and
    the JAX package out of sys.modules (a subprocess: this test process has
    imported jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pyscf_isdf_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for m in {K_MODULES!r}:\n"
        "    assert 'pyscf_isdf_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'pyscf_isdf_tpu' or m.startswith('pyscf_isdf_tpu.')]\n"
        "assert not bad, bad\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_point_without_cuda_raises(monkeypatch):
    """No device given and no CUDA: the entry point refuses instead of
    silently running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_scf_system(diamond_primitive(mesh=MESH))


def test_k_entry_points_default_to_cuda(monkeypatch):
    """build_kscf_system, kscf_kernel and kuhf_kernel take device=None as the
    GPU: they refuse without CUDA and run with device='cpu'."""
    import inspect

    from pyscf_isdf_tpu_torch.scf import build_kscf_system, kscf_kernel, kuhf_kernel

    for fn in (build_kscf_system, kscf_kernel, kuhf_kernel):
        assert inspect.signature(fn).parameters["device"].default is None
    cell = diamond_primitive(mesh=(7, 7, 7))
    kpts = np.zeros((1, 3))
    system = build_kscf_system(cell, kpts, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_kscf_system(cell, kpts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kscf_kernel(system, xc="lda,vwn")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kuhf_kernel(system, xc="lda,vwn")
    # a system built on another device is refused, not copied across
    with pytest.raises(ValueError, match="lives on cpu"):
        kscf_kernel(system, xc="lda,vwn", device="cuda")
    with pytest.raises(ValueError, match="lives on cpu"):
        kuhf_kernel(system, xc="lda,vwn", device="cuda")
    assert kscf_kernel(system, xc="lda,vwn", device="cpu")["converged"]


def test_slice8_entry_points_default_to_cuda(monkeypatch):
    """rohf_kernel, krohf_kernel, kghf_kernel, get_bands, cdft_kernel and
    kmp2_stagger_energy take device=None as the GPU: they refuse without
    CUDA, refuse a system that lives elsewhere, and run with device='cpu'."""
    import inspect

    from pyscf_isdf_tpu_torch import lattice
    from pyscf_isdf_tpu_torch.mp import kmp2_stagger_energy
    from pyscf_isdf_tpu_torch.scf import (
        build_kscf_system, cdft_kernel, get_bands, kghf_kernel, krohf_kernel, rohf_kernel,
    )

    gamma_fns = (rohf_kernel, get_bands, cdft_kernel)
    k_fns = (krohf_kernel, kghf_kernel, kmp2_stagger_energy)
    for fn in gamma_fns + k_fns:
        assert inspect.signature(fn).parameters["device"].default is None
    cell = diamond_primitive(mesh=(7, 7, 7))
    gsys = build_scf_system(cell, device="cpu")
    ksys = build_kscf_system(cell, lattice.make_kpts(cell.a, [2, 1, 1]), device="cpu")
    args = {rohf_kernel: (), get_bands: ({"dm": gsys.S}, np.zeros(3)),
            cdft_kernel: ("lda,vwn", [0], 1.0), krohf_kernel: (), kghf_kernel: (),
            kmp2_stagger_energy: ({},)}
    for fn in gamma_fns + k_fns:
        system = gsys if fn in gamma_fns else ksys
        with pytest.raises(ValueError, match="lives on cpu"):
            fn(system, *args[fn], device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in gamma_fns + k_fns:
        system = gsys if fn in gamma_fns else ksys
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(system, *args[fn])
    assert rohf_kernel(gsys, nelec=(5, 3), device="cpu")["converged"]
    assert kghf_kernel(ksys, device="cpu", max_cycle=3)["niter"] == 3


def test_object_api_and_parallel_default_to_cuda(monkeypatch):
    """The frontend constructors and the process-group entry points
    (init_group, launch, grid_mesh) take device=None as the GPU and refuse
    without CUDA; the process-group entry points pick nccl for CUDA and gloo
    for the CPU, refuse a CUDA group without CUDA, and never switch backend
    by themselves (nccl asked for where it cannot run raises)."""
    import inspect
    import tempfile

    import pyscf_isdf_tpu_torch as pt
    from pyscf_isdf_tpu_torch import lattice
    from pyscf_isdf_tpu_torch.parallel import grid_mesh, init_group, launch
    from pyscf_isdf_tpu_torch.parallel.mesh import default_backend

    cell = diamond_primitive(mesh=(7, 7, 7))
    kpts = lattice.make_kpts(cell.a, [2, 1, 1])
    gamma = (pt.RHF, pt.RKS, pt.UHF, pt.UKS, pt.ROHF)
    kcls = (pt.KRHF, pt.KRKS, pt.KUHF, pt.KUKS, pt.KROHF, pt.KGHF, pt.KRKSpU)
    for cls in gamma + kcls:
        assert inspect.signature(cls).parameters["device"].default is None
    mf = pt.RKS(cell, device="cpu")
    assert mf.device.type == "cpu" and mf.system.aoR.device.type == "cpu"
    assert default_backend("cuda") == "nccl" and default_backend("cpu") == "gloo"
    with pytest.raises(RuntimeError, match="no process group"):
        grid_mesh()
    with tempfile.TemporaryDirectory() as tmp:
        with pytest.raises(ValueError, match="nccl takes CUDA tensors"):
            init_group(os.path.join(tmp, "store"), 0, 1, "cpu", backend="nccl")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in gamma:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cell)
    for cls in kcls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cell, kpts)
    with tempfile.TemporaryDirectory() as tmp:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_group(os.path.join(tmp, "store"), 0, 1, "cuda")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_group(os.path.join(tmp, "store"), 0, 1)
    # launch and grid_mesh take device=None as the GPU too
    for fn in (launch, init_group, grid_mesh):
        assert inspect.signature(fn).parameters["device"].default is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch(default_backend, 1)
    with tempfile.TemporaryDirectory() as tmp:
        with init_group(os.path.join(tmp, "store"), 0, 1, "cpu", "gloo") as grp:
            assert grp.device.type == "cpu" and grp.backend == "gloo"
            assert grid_mesh("cpu").device.type == "cpu"
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                grid_mesh()

"""Port SCF == JAX reference SCF, end to end.

Each package builds the same off-symmetry diamond primitive cell and runs
the same SCF; the port runs on the CPU in float64 (its kernels through
their plain versions). Energies agree to 1e-8 Ha: the SCF converges to
1e-10 and the two engines differ only by rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf import scf_kernel as ref_scf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.convert import system_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system, scf_kernel  # noqa: E402

MESH = (12, 12, 12)
A = [[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834], [1.7834, 1.7834, 0.0]]
ATOMS = [["C", (0.0, 0.0, 0.0)], ["C", (0.93, 0.87, 0.90)]]
TOL = 1e-8


def _cell(build):
    return build(A, ATOMS, "gth-szv", pseudo="gth-pade", mesh=MESH,
                 unit="Angstrom")


@pytest.fixture(scope="module")
def systems():
    return (ref_build(_cell(ref_build_cell)),
            build_scf_system(_cell(build_cell), device="cpu"))


@pytest.fixture(scope="module")
def ref_scf_run(systems):
    """The reference's SCF per (xc, df), run once for the module."""
    runs = {}

    def run(xc, df):
        if (xc, df) not in runs:
            runs[xc, df] = ref_scf(systems[0], xc=xc, df=df, conv_tol=1e-10)
        return runs[xc, df]
    return run


@pytest.mark.parametrize("xc,df", [(None, "isdf"), ("pbe0", "isdf-robust"),
                                   ("lda,vwn", "fftdf"), ("pbe0", "fftdf"),
                                   ("hse06", "isdf-robust"), ("scan", "fftdf")])
def test_scf_energy(systems, ref_scf_run, xc, df):
    ref_sys, port_sys = systems
    ref = ref_scf_run(xc, df)
    out = scf_kernel(port_sys, xc=xc, df=df, conv_tol=1e-10)
    assert out["converged"] and ref["converged"]
    assert out["niter"] > 2
    assert abs(out["e_tot"] - ref["e_tot"]) < TOL


def test_scf_on_reference_system(systems, ref_scf_run):
    """The reference's system carried across by convert.system_from_numpy."""
    ref_sys, _ = systems
    port_sys = system_from_numpy(
        _cell(build_cell), ref_sys.S, ref_sys.hcore, ref_sys.X,
        np.asarray(ref_sys.aoR), ref_sys.coulG, ref_sys.madelung,
        ref_sys.e_nuc, device="cpu")
    ref = ref_scf_run("pbe0", "isdf-robust")
    out = scf_kernel(port_sys, xc="pbe0", df="isdf-robust", conv_tol=1e-10)
    assert abs(out["e_tot"] - ref["e_tot"]) < TOL


def test_unported_options_raise(systems):
    """The double-float solves stay unported; the options the slices
    ported refuse misuse as the reference does (aegdf on a system built
    without ae=True, an unknown XC grid)."""
    _, port_sys = systems
    with pytest.raises(NotImplementedError):
        scf_kernel(port_sys, xc="pbe0", df="isdf", isdf_precision="dd")
    with pytest.raises(ValueError, match="ae=True"):
        scf_kernel(port_sys, xc=None, df="aegdf")
    with pytest.raises(ValueError, match="xc_grids"):
        scf_kernel(port_sys, xc="hse06", xc_grids="lebedev")


@pytest.mark.parametrize("name", ["graphene", "diamond_cubic"])
def test_model_cells_match_reference(name):
    """The port's graphene (BASELINE config 2) and cubic diamond cells are
    the reference's: lattice, coordinates, species and AO count."""
    from pyscf_isdf_tpu import models as ref_models
    from pyscf_isdf_tpu_torch import models

    mesh = (15, 15, 48) if name == "graphene" else (12, 12, 12)
    cell, ref = getattr(models, name)(mesh=mesh), getattr(ref_models, name)(mesh=mesh)
    assert np.abs(cell.a - ref.a).max() < 1e-14
    assert np.abs(cell.coords - ref.coords).max() < 1e-14
    assert tuple(cell.symbols) == tuple(ref.symbols) and cell.nao == ref.nao
    assert cell.nao == (8 if name == "graphene" else 32)


def test_graphene_pbe0_isdf_vs_fftdf():
    """BASELINE config 2 (tests/test_graphene.py): on the reference's mesh
    the ISDF exchange (c=8) reproduces the FFTDF one inside the converged
    PBE0 SCF to 1e-7 Ha."""
    from pyscf_isdf_tpu_torch.models import graphene

    system = build_scf_system(graphene(mesh=(15, 15, 48)), device="cpu")
    ref = scf_kernel(system, xc="pbe0", conv_tol=1e-9)
    out = scf_kernel(system, xc="pbe0", df="isdf", isdf_c=8, conv_tol=1e-9)
    assert ref["converged"] and out["converged"]
    assert abs(out["e_tot"] - ref["e_tot"]) < 1e-7

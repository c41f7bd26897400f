"""Port graph SCF drivers == JAX one-program drivers and the host loops.

On the CPU the drivers run their cycle eagerly, through the same cycle
functions the GPU captures into CUDA graphs, so these tests hold the
arithmetic the card replays. Against the reference's one-program drivers
(one Gamma and one k-point compile, on 10^3 / 9^3 cells, plus the small
fixed-count mixing driver): equal iteration counts and 1e-8 Ha. The other
functionals are held as port driver against port host loop (1e-8 Ha:
both converge to conv_tol=1e-10 from different starts), with no JAX
compile; so are the fixed-count mixing driver's 'hf' and meta-GGA runs,
which the reference's driver refuses (ROADMAP queue 3, fault (d)): after
100 cycles of 0.3 mixing both are within 1e-9 Ha of the host loop
converged to 1e-11.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf.jit_diis import run_kscf_jit_diis as ref_kdrv  # noqa: E402
from pyscf_isdf_tpu.scf.jit_diis import run_scf_jit_diis as ref_drv  # noqa: E402
from pyscf_isdf_tpu.scf.jit_driver import run_scf_jit as ref_mix  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_kbuild  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, scf_kernel,
)
from pyscf_isdf_tpu_torch.scf.jit_diis import (  # noqa: E402
    make_kscf_jit_diis, run_kscf_jit_diis, run_scf_jit_diis,
)
from pyscf_isdf_tpu_torch.scf.jit_driver import make_jit_scf, run_scf_jit  # noqa: E402

A = [[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834], [1.7834, 1.7834, 0.0]]
ATOMS = [["C", (0.0, 0.0, 0.0)], ["C", (0.93, 0.87, 0.90)]]
TOL = 1e-8


def _cell(build):
    return build(A, ATOMS, "gth-szv", pseudo="gth-pade", mesh=(10, 10, 10),
                 unit="Angstrom")


@pytest.fixture(scope="module")
def gamma():
    return ref_build(_cell(ref_build_cell)), build_scf_system(_cell(build_cell),
                                                              device="cpu")


@pytest.fixture(scope="module")
def kpoint():
    """Diamond primitive 9^3 on the shifted (1,1,2) k-mesh."""
    rcell = ref_diamond(mesh=(9, 9, 9))
    kpts = ref_lattice.make_kpts(rcell.a, [1, 1, 2], with_gamma_point=False)
    return (ref_kbuild(rcell, kpts),
            build_kscf_system(diamond_primitive(mesh=(9, 9, 9)), kpts, device="cpu"))


def test_gamma_driver_matches_reference(gamma):
    """HSE06 with ISDF exchange: the full-range and long-range
    factorizations from one fit, the two Madelung shifts, the GGA
    quadrature and the CDIIS history inside the loop."""
    ref_sys, sys_ = gamma
    e0, _, n0, conv0 = ref_drv(ref_sys, xc="hse06", df="isdf", isdf_c=10)
    e, dm, n, conv = run_scf_jit_diis(sys_, xc="hse06", df="isdf", isdf_c=10)
    assert conv and conv0
    assert n == n0
    assert abs(e - e0) < TOL


def test_k_driver_matches_reference(kpoint):
    """KRHF through the shared-xi k-point ISDF: complex CDIIS, the k-point
    Madelung shift, batched eigensolves and the exact-count fill across
    k (the k-point RSH and meta-GGA branches are held against the port's
    host loop below, which is held against the reference in
    test_torch_kscf.py)."""
    ref_sys, sys_ = kpoint
    e0, _, n0, conv0 = ref_kdrv(ref_sys, xc=None, df="isdf", isdf_c=10)
    e, dm, n, conv = run_kscf_jit_diis(sys_, xc=None, df="isdf", isdf_c=10)
    assert conv and conv0
    assert n == n0
    assert abs(e - e0) < TOL


def test_mixing_driver_matches_reference(gamma):
    """Fixed-count simple mixing, RHF with its ISDF exchange."""
    ref_sys, sys_ = gamma
    e0, dm0 = ref_mix(ref_sys, xc=None, n_iter=6)
    e, dm = run_scf_jit(sys_, xc=None, n_iter=6)
    assert abs(e - e0) < TOL
    assert np.abs(dm.numpy() - np.asarray(dm0)).max() < 1e-8
    with pytest.raises(ValueError, match="range-separated"):
        make_jit_scf(sys_, xc="hse06")


@pytest.mark.parametrize("xc", ["hf", "scan"])
def test_mixing_driver_matches_host_loop(gamma, xc):
    """run_scf_jit with full exact exchange and with a meta-GGA (their ISDF
    exchange and the tau quadrature) against scf_kernel on the same ISDF
    engine."""
    _, sys_ = gamma
    e, _ = run_scf_jit(sys_, xc=xc, n_iter=100)
    ref = scf_kernel(sys_, xc=xc, df="isdf", isdf_c=8, conv_tol=1e-11)
    assert ref["converged"]
    assert abs(e - ref["e_tot"]) < TOL


@pytest.mark.parametrize("xc,df", [("scan", "isdf"), ("r2scan", "fftdf"),
                                   ("b3lyp", "isdf"), (None, "fftdf")])
def test_gamma_driver_matches_host_loop(gamma, xc, df):
    _, sys_ = gamma
    e, _, n, conv = run_scf_jit_diis(sys_, xc=xc, df=df)
    ref = scf_kernel(sys_, xc=xc, df=df, isdf_c=10, conv_tol=1e-10)
    assert conv and ref["converged"]
    assert abs(e - ref["e_tot"]) < TOL


@pytest.mark.parametrize("xc,df", [("hse06", "isdf"), ("tpss", "fftdf"),
                                   ("pbe0", "fftdf")])
def test_k_driver_matches_host_loop(kpoint, xc, df):
    _, sys_ = kpoint
    e, _, n, conv = run_kscf_jit_diis(sys_, xc=xc, df=df)
    ref = kscf_kernel(sys_, xc=xc, df=df, isdf_c=10, conv_tol=1e-10, device="cpu")
    assert conv and ref["converged"]
    assert abs(e - ref["e_tot"]) < TOL


def test_driver_counts_and_limits(gamma, kpoint):
    """max_cycle stops the loop unconverged; the stats count the cycles; the
    k driver refuses a rank-deficient overlap and both refuse an unknown
    engine."""
    import dataclasses

    from pyscf_isdf_tpu_torch.scf.jit_diis import make_jit_scf_diis

    _, sys_ = gamma
    run = make_jit_scf_diis(sys_, xc="lda,vwn", df="fftdf", max_cycle=3)
    nao = sys_.aoR.shape[1]
    _, _, n, conv = run(2.0 / nao * torch.eye(nao, dtype=torch.float64))
    assert (n, conv, run.stats["cycles"]) == (3, False, 3)
    _, ksys = kpoint
    ragged = dataclasses.replace(ksys, X=ksys.X[:1] + (ksys.X[1][:, :-1],))
    with pytest.raises(ValueError, match="full-rank"):
        make_kscf_jit_diis(ragged, xc="lda,vwn", df="fftdf")
    with pytest.raises(ValueError, match="unknown df engine"):
        make_jit_scf_diis(sys_, df="isdf-robust")

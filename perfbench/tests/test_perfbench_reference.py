"""The program against the plain reference on the test-size cell, through
the benchmark's own traffic code, on the CPU with the plain kernels."""
import time

import numpy as np
import pytest
import torch

from perfbench import geometry, harness, registry
from perfbench.reference import scf as reference


@pytest.mark.parametrize("cell", ["prim9.scf", "prim9.geom"])
def test_cell_is_correct_on_the_cpu(tiny, cell):
    bench, base = tiny
    r = harness.run_cell(bench, registry.find_workload(bench, cell), 2**31 + 7, 0.5,
                         False, "cpu", time.perf_counter(), base=base)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["e_gap_ha"]["value"] < 1e-8
    assert r["checks"]["pivot_gap"]["value"] < 1e-10
    assert list(r)[-1] == "checks"
    unit = {"prim9.scf": "scf_solve_ms", "prim9.geom": "geom_step_s"}[cell]
    assert set(r["metrics"]) == {unit, "setup_s"}


@pytest.mark.parametrize("cell", ["prim9.scf", "prim9.geom"])
def test_traced_run_reports_its_layer_metrics(tiny, cell):
    bench, base = tiny
    r = harness.run_cell(bench, registry.find_workload(bench, cell), 11, 0.5,
                         True, "cpu", time.perf_counter(), base=base)
    assert r["correct"], r["checks"]
    assert "window_s" in r["device"] and "breakdown" in r
    if cell == "prim9.scf":
        assert r["metrics"]["scf_iters.solve"]["value"] >= 2
        # no device on the CPU: the device-trace metrics read nothing
        assert "k_device_ms.solve" not in r["metrics"]
        assert "robust_k_roofline" not in r["metrics"]
    else:
        assert r["metrics"]["isdf_select_s.geom"]["value"] > 0
        assert r["metrics"]["system_build_s.geom"]["value"] > 0


def test_fixed_mix_shifts_by_whole_grid_steps():
    """Under every seed a fixed mix solves one snapshot, moved by whole grid
    steps: the same work and energy on a cyclically shifted grid."""
    from perfbench.generator import Generator

    cfg = registry.load_config("diamond-prim9-szv-pbe0", base=_data())
    mix = registry.load_traffic("scf")
    a = np.asarray(geometry.snapshot(cfg, 1, 0)["a"])
    got = []
    for seed in (2**31 + 21, 2**33 + 4):
        g = geometry.unit_geometry(cfg, mix, seed, 0)
        got.append(g["coords"] @ np.linalg.inv(a))
        gen = Generator(cfg, mix, seed, "cpu")
        gen.setup()
        got.append(gen.unit(1))
    steps = (got[2] - got[0]) * np.asarray(cfg["mesh"])
    assert np.abs(steps - np.round(steps)).max() < 1e-9
    assert np.abs(np.round(steps) % np.asarray(cfg["mesh"])).max() > 0
    one, two = got[1], got[3]
    assert one["niter"] == two["niter"]
    assert abs(one["e_tot"] - two["e_tot"]) < 1e-10
    assert not torch.equal(one["pivots"], two["pivots"])


def test_reference_system_matches_the_program():
    """Set-up pieces of the test cell, reference against program."""
    from pyscf_isdf_tpu_torch import build_cell
    from pyscf_isdf_tpu_torch.scf import hf

    cfg = registry.load_config("diamond-prim9-szv-pbe0", base=_data())
    g = geometry.snapshot(cfg, 5, 3)
    cell = build_cell(g["a"], [[s, tuple(c)] for s, c in zip(g["symbols"], g["coords"])],
                      cfg["basis"], pseudo=cfg["pseudo"], mesh=tuple(cfg["mesh"]),
                      unit="Bohr")
    prog = hf.build_scf_system(cell, device="cpu")
    ref = reference.build_system(g, cfg, "cpu")
    for key, tol in (("aoR", 1e-12), ("S", 1e-13), ("hcore", 1e-12), ("coulG", 0),
                     ("Gv", 0)):
        assert float((getattr(prog, key) - ref[key]).abs().max()) <= tol, key
    assert abs(prog.madelung - ref["madelung"]) < 1e-12
    assert abs(prog.e_nuc - ref["e_nuc"]) < 1e-10


def test_pivot_judge_reads_a_wrong_pivot():
    torch.manual_seed(0)
    aoR = torch.randn(200, 6, dtype=torch.float64)
    from pyscf_isdf_tpu_torch.ops.interp_points import pivoted_cholesky_points

    good = pivoted_cholesky_points(aoR, 12)[0]
    _, gap = reference.judge_pivots(aoR, good, 12)
    assert gap < 1e-12
    bad = good.clone()
    bad[5] = int(torch.argmin((aoR * aoR).sum(1)))
    _, gap = reference.judge_pivots(aoR, bad, 12)
    assert gap > 0.1
    assert reference.judge_pivots(aoR, good[:11], 12) == (None, 1.0)
    assert reference.judge_pivots(aoR, torch.cat([good[:11], good[:1]]), 12) == (None, 1.0)


def _data():
    import os

    from conftest import DATA

    return os.path.join(DATA)

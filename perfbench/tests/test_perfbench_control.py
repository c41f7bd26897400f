"""The control: the program's own float32 path, the next precision below
the configuration's float64, put in the program's place, must come out
not correct. On the CPU at the test size here; on the card at the cells'
own sizes by ``perfbench/calibrate.py`` (the ``card`` test)."""
import json
import os
import subprocess
import sys
import time

import pytest

from perfbench import harness, registry
from conftest import ROOT


@pytest.mark.parametrize("cell", ["prim9.scf", "prim9.geom"])
def test_float32_control_is_not_correct(tiny, cell):
    bench, base = tiny
    r = harness.run_cell(bench, registry.find_workload(bench, cell), 2**31 + 3, 0.3,
                         False, "cpu", time.perf_counter(), base=base, dtype="float32")
    assert not r["correct"], r["checks"]
    assert r["checks"]["e_gap_ha"]["value"] > r["checks"]["e_gap_ha"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["szv333.scf", "dzvp333.scf", "szv333.geom"])
def test_float32_control_fails_at_the_cell_size(card, cell):
    seeds = "2147483911,2147483912,2147483913"
    out = subprocess.run([sys.executable, "perfbench/calibrate.py", "--workload", cell,
                          "--control-seeds", seeds, "--seconds", "1"],
                         capture_output=True, text=True, timeout=1800, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert all(not x["correct"] for x in lines if x.get("side") == "control")
    limits = registry.load_limits(cell)["limits"]
    upper = lines[-1]["upper"]
    assert any(upper[k] > limits[k] for k in limits)

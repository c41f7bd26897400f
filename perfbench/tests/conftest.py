"""Tests of the benchmark's harness (run as ``python -m pytest
perfbench/tests`` from the root). Tests marked ``card`` need an NVIDIA
card; the ``card`` fixture decides, at run time, and skips without one."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = "diamond-prim9-szv-pbe0"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: runs on the card only")


def make_tiny(tmp_path):
    """(bench, base): a copy of the benchmark's folders under ``tmp_path``
    with the test-size configuration and two cells on it, ``prim9.scf``
    and ``prim9.geom``, that report the benchmark's own metrics."""
    here = os.path.join(ROOT, "perfbench")
    base = tmp_path / "perfbench"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(here, d), base / d)
    shutil.copy(os.path.join(DATA, "configs", TINY + ".json"), base / "configs")
    shutil.copytree(os.path.join(DATA, "limits"), base / "limits")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = [
        dict(name="prim9.scf", config=TINY, traffic="scf", chips=1, why="test"),
        dict(name="prim9.geom", config=TINY, traffic="geom", chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["prim9." + w.split(".")[1] for w in m["workloads"]]
    return bench, str(base)


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)

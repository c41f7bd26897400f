"""``run.py`` fails, and prints no result, without a card and in a
checkout that lacks the program."""
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "szv333.scf",
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=cwd, env=env)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_unknown_workload_fails():
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    out = _run(ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"

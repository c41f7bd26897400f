"""Configurations, mixes, metrics and limits are found by name."""
import json
import os
import shutil

import pytest

from perfbench import registry
from conftest import ROOT


def _bench():
    return registry.load_benchmark(ROOT)


def test_every_cell_resolves():
    bench = _bench()
    names = {c["name"] for c in bench["configs"]}
    for cell in bench["workloads"]:
        assert cell["config"] in names
        cfg = registry.load_config(cell["config"])
        mix = registry.load_traffic(cell["traffic"])
        assert registry.load_limits(cell["name"])["limits"]
        assert mix["per_unit_metric"] in {m["name"] for m in bench["end_to_end"]}
        assert cfg["dtype"] == "float64"
        for m in registry.reported(bench, cell["name"], "per_layer"):
            assert callable(registry.load_metric(m["name"]))
        e2e = [m["name"] for m in registry.reported(bench, cell["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_a_new_config_mix_and_metric_are_found(tmp_path):
    """A later change adds files and entries; nothing is edited."""
    here = os.path.join(ROOT, "perfbench")
    for d in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(here, d), tmp_path / d)
    cfg = registry.load_config("diamond333-szv-pbe0", str(tmp_path))
    cfg["xc"] = "lda,vwn"
    (tmp_path / "configs" / "new-config.json").write_text(json.dumps(cfg))
    mix = registry.load_traffic("scf", str(tmp_path))
    mix["start"] = "previous"
    (tmp_path / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "new_metric.solve.py").write_text(
        "def read(run):\n    return 42.0 if run.records else None\n")
    (tmp_path / "limits" / "new.cell.json").write_text(json.dumps({"limits": {"e_gap_ha": 1}}))
    assert registry.load_config("new-config", str(tmp_path))["xc"] == "lda,vwn"
    assert registry.load_traffic("new-mix", str(tmp_path))["start"] == "previous"
    read = registry.load_metric("new_metric.solve", str(tmp_path))
    assert read(type("Run", (), {"records": [1]})) == 42.0
    assert registry.load_limits("new.cell", str(tmp_path))["limits"] == {"e_gap_ha": 1}
    bench = _bench()
    bench["workloads"].append(dict(name="new.cell", config="new-config",
                                   traffic="new-mix", chips=1, why="t"))
    bench["per_layer"].append(dict(name="new_metric.solve", unit="x", better="lower",
                                   source="program_counter", layer="SCF driver",
                                   moves="scf_solve_ms"))
    bench["end_to_end"][0]["workloads"].append("new.cell")
    got = [m["name"] for m in registry.reported(bench, "new.cell", "per_layer")]
    assert got == ["new_metric.solve"]
    # a metric without a workloads key follows the end-to-end metric it moves
    assert "new_metric.solve" in [m["name"] for m in
                                  registry.reported(bench, "szv333.scf", "per_layer")]
    assert "new_metric.solve" not in [m["name"] for m in
                                      registry.reported(bench, "szv333.geom", "per_layer")]


def test_unknown_names_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        registry.load_config("no-such-config")
    with pytest.raises(ValueError):
        registry.load_traffic("../configs/diamond333-szv-pbe0")
    with pytest.raises(KeyError):
        registry.find_workload(_bench(), "no.such.cell")


def test_what_nothing_runs_is_refused_in_setup(tiny):
    """A configuration or mix key that the generator's paths do not run, or
    a reference that does not solve what the configuration states, stops
    the run before its window."""
    from perfbench import check, harness
    from perfbench.generator import check_inputs

    cfg = registry.load_config("diamond333-szv-pbe0")
    mix = registry.load_traffic("scf")
    check_inputs(cfg, mix)
    assert check.reference_for(cfg).SOLVES["isdf_selection"] == "greedy"
    for key, value in (("isdf_selection", "cvt"), ("isdf_fit", "plain"), ("kpts", [3, 3, 3])):
        with pytest.raises(ValueError):
            check_inputs(dict(cfg, **{key: value}), mix)
    with pytest.raises(ValueError):
        check_inputs(cfg, dict(mix, clients=4))
    with pytest.raises(ValueError):
        check.reference_for(dict(cfg, xc="lda,vwn"))
    with pytest.raises(FileNotFoundError):
        check.reference_for(dict(cfg, reference="no-such-reference"))

    bench, base = tiny
    path = os.path.join(base, "configs", "diamond-prim9-szv-pbe0.json")
    with open(path) as f:
        tiny_cfg = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(tiny_cfg, isdf_selection="cvt"), f)
    with pytest.raises(ValueError, match="isdf_selection"):
        harness.run_cell(bench, registry.find_workload(bench, "prim9.geom"), 1, 0.1,
                         False, "cpu", 0.0, base=base)

"""Finds what a cell names, by name, under the benchmark's folders.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, a per-layer metric's reader
``metrics/<name>.py`` (a module with ``read(run) -> float | None``), and
the limits of a cell's comparison ``limits/<cell>.json``, and the plain
reference that a configuration names ``reference/<name>.py``. A later
change adds a configuration, a mix, a metric, a reference or a cell as
new files and entries of ``BENCHMARK.json``; nothing here is edited for
it.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _path(base, kind, name, ext):
    if not name or "/" in name or name.startswith("."):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(base, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {name!r} under {kind}/: {path} is missing")
    return path


def _json(base, kind, name):
    with open(_path(base, kind, name, ".json")) as f:
        return json.load(f)


def load_config(name, base=HERE):
    return _json(base, "configs", name)


def load_traffic(name, base=HERE):
    return _json(base, "traffic", name)


def load_limits(name, base=HERE):
    return _json(base, "limits", name)


def load_metric(name, base=HERE):
    """The ``read`` function of a per-layer metric's reader."""
    path = _path(base, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_reference(name):
    """The module of the plain reference ``reference/<name>.py`` (a
    package beside this file: references import their shared pieces)."""
    _path(HERE, "reference", name, ".py")
    return importlib.import_module(f"{__package__}.reference.{name}")


def load_benchmark(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_workload(bench, name):
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[c['name'] for c in bench['workloads']]})")


def reported(bench, cell_name, kind):
    """The metrics of ``kind`` ('end_to_end' or 'per_layer') that a cell
    reports: those whose ``workloads`` list it, and those without the key
    (an end-to-end metric then holds for every cell, a per-layer one for
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out

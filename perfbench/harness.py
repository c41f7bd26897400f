"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line."""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from . import check, registry, trace
from .generator import Generator

FORBIDDEN = ("jax", "jaxlib", "flax", "pyscf_isdf_tpu")
SCALE = {"ms": 1e3, "s": 1.0}


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def power_limit(device):
    """The name and power limit of the card in use, as nvidia-smi reads
    them (the line whose UUID is the device's), or None."""
    uuid = str(getattr(torch.cuda.get_device_properties(device), "uuid", ""))
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=uuid,name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    for line in out.stdout.splitlines() if out.returncode == 0 else ():
        card, _, rest = line.partition(",")
        if uuid and card.strip().removeprefix("GPU-") == uuid.removeprefix("GPU-"):
            return rest.strip()
    return None


def _profile(gen, units, k):
    """Run ``units`` units from ``k`` under the profiler; returns (records,
    profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if gen.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    gen.tracing = True
    records = []
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for i in range(units):
                records.append(dict(gen.unit(k + i), traced=True))
            gen.sync()
    gen.tracing = False
    return records, prof


def _summarize(prof):
    """The trace summary of a finished profiler (its Chrome trace goes
    through a temporary file)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace.summarize(trace.load(path))
    finally:
        os.unlink(path)


def run_cell(bench, cell, seed, seconds, traced, device, t0, base=registry.HERE,
             dtype=None, marks=()):
    """Run one cell once; returns the result dict (the keys of the result
    line, ``checks`` last). ``marks`` are (name, seconds since ``t0``) of
    the caller's set-up steps; with the generator's they go to standard
    error as the parts of ``setup_s``."""
    from pyscf_isdf_tpu_torch.utils.timing import StageTimer

    config = registry.load_config(cell["config"], base)
    mix = registry.load_traffic(cell["traffic"], base)
    limits = registry.load_limits(cell["name"], base)
    e2e = registry.reported(bench, cell["name"], "end_to_end")
    layer = registry.reported(bench, cell["name"], "per_layer") if traced else []
    readers = {m["name"]: registry.load_metric(m["name"], base) for m in layer}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    reference = check.reference_for(config)
    gen = Generator(config, mix, seed, dev, dtype)
    marks = list(marks) + [("harness", time.perf_counter() - t0)]
    parts = gen.setup()
    gen.sync()
    start = time.perf_counter()
    setup_s = start - t0
    last, text = 0.0, []
    for name, t in marks:
        text.append(f"{name} {t - last:.3f}")
        last = t
    text += [f"{name} {t:.3f}" for name, t in parts.items()]
    print(f"setup_s {setup_s:.3f} = " + " + ".join(text), file=sys.stderr, flush=True)

    records, prof, k = [], None, 1
    if traced:
        records, prof = _profile(gen, mix["traced_units"], k)
        k += len(records)
    plain = 0      # a traced run also runs at least one untraced unit
    while not plain or time.perf_counter() - start < seconds:
        timer = StageTimer(dev) if traced and mix["stage_timer"] else None
        rec = gen.unit(k, timer)
        if timer is not None:
            rec["stages"] = {n: sum(v) for n, v in timer.seconds.items()}
        records.append(rec)
        k += 1
        plain += 1
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    shapes = dict(gen.shapes)
    gen.release()
    summary = _summarize(prof) if prof is not None else None
    del prof

    attempted = len(records)
    converged = sum(r["converged"] for r in records)
    metrics = {}
    if not traced:
        for m in e2e:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == mix["per_unit_metric"]:
                value = SCALE[m["unit"]] * window_s / max(converged, 1)
            else:
                raise ValueError(f"{m['name']}: not a metric of traffic {cell['traffic']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    card = power_limit(dev) if traced and cuda else None
    run = SimpleNamespace(records=records, trace=summary, shapes=shapes, card=card,
                          window_s=window_s)
    for m in layer:
        value = readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers = check.judge(config, mix, records, seed, dev, reference)
    correct, checks = check.verdict(numbers, limits)
    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if card:
        device_info["name_and_power_limit"] = card
    result = {"correct": bool(correct and converged == attempted),
              "attempted": attempted, "failed": attempted - converged,
              "metrics": metrics, "device": device_info}
    if traced and summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result

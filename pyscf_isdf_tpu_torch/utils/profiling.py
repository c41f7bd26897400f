"""Device tracing hooks over ``torch.profiler``.

``trace(logdir)`` records the enclosed region (CPU and, where there is a
card, CUDA activity) and writes a Chrome trace into ``logdir``;
``annotate(name)`` names a phase in that trace (a ``record_function``
range, and an NVTX range on a CUDA build with a card).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed region; writes ``logdir/trace_<ns>.json`` on exit.

    Yields the profiler, whose ``key_averages()`` sums time by operation."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range that appears in profiler traces."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()

"""Reading a ``torch.profiler`` Chrome trace: the device's busy time and
idle share over the traced window, the device time under each of the
benchmark's own ranges, and the breakdown of device operations and idle
gaps.

The traced window is the CPU range named ``perfbench.window``; the work in
it ends in a synchronize, so every device operation it started lies in it.
A range's device time is the sum of the device operations whose launch
(the runtime call with the same correlation id) lies inside the range on
its thread, which holds whatever launched them: a torch operator, cuBLAS,
cuFFT or a kernel launched through ctypes.
"""
from __future__ import annotations

import bisect
import json

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
RANGE_PREFIX = "perfbench."
NAME_CHARS = 120       # kernel names are C++ templates: keep their heads
TOP = 10               # entries of each breakdown list, the most a result line takes
WALK = 4000            # host events looked back from a gap for the op that spans it


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_and_gaps(intervals, lo, hi):
    """(busy length, idle gaps) of the union of ``intervals`` clipped to
    [lo, hi]."""
    busy, gaps, t = 0.0, [], lo
    for s, e in merge((max(s, lo), min(e, hi)) for s, e in intervals
                      if e > lo and s < hi):
        if s > t:
            gaps.append((t, s))
        busy += e - s
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return busy, gaps


def idle_pct(summary):
    """Share of a summary's window in which no operation ran on the device,
    in percent, or None when the trace shows no device time."""
    if not summary or summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def range_seconds(summary, name):
    """Device seconds of each traced occurrence of the benchmark's range
    ``name``, or None when one of them shows no device time."""
    times = (summary or {}).get("ranges", {}).get(name)
    return times if times and all(t > 0 for t in times) else None


def load(path):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


class _Host:
    """The nested host events of one thread, for 'what was the host doing
    at time t'."""

    def __init__(self, events, tid, pid):
        evs = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"], e["cat"])
                     for e in events if e.get("tid") == tid and e.get("pid") == pid)
        self.starts = [x[0] for x in evs]
        self.evs = evs
        self.ranges = [x for x in evs if x[3] == "user_annotation"
                       and x[2].startswith(RANGE_PREFIX) and x[2] != WINDOW]

    def doing(self, t):
        rng = "host"
        for s, e, name, _ in self.ranges:
            if s <= t <= e:
                rng = name          # ranges nest; the last to start is innermost
        i = bisect.bisect_right(self.starts, t) - 1
        op = "python"
        for j in range(i, max(-1, i - WALK), -1):
            s, e, name, cat = self.evs[j]
            if e >= t and cat != "user_annotation":
                op = name
                break
        return f"{rng}/{op}"


def summarize(events):
    """Numbers of the traced window of a Chrome trace's event list.

    Returns a dict with ``window_s``, ``busy_s``, ``ranges`` (name -> list
    of device seconds, one per occurrence of the benchmark's range),
    ``device_ops`` and ``idle_gaps`` (the largest [name, seconds],
    device operations by summed time and idle time by what the host was
    doing, ``TOP`` of each), or None when the trace has no traced window."""
    windows = [e for e in _complete(events, ("user_annotation",)) if e["name"] == WINDOW]
    if not windows:
        return None
    w = windows[0]
    lo, hi, tid, pid = w["ts"], w["ts"] + w["dur"], w["tid"], w["pid"]
    dev = [e for e in _complete(events, DEVICE_CATS)
           if e["ts"] + e.get("dur", 0) > lo and e["ts"] < hi]
    busy, gaps = busy_and_gaps([(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev], lo, hi)

    by_corr = {}
    for e in dev:
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            by_corr[corr] = by_corr.get(corr, 0.0) + e.get("dur", 0)
    host_events = _complete(events, HOST_CATS)
    launches = sorted((e["ts"], e.get("args", {}).get("correlation"))
                      for e in host_events if e.get("cat") in LAUNCH_CATS
                      and e.get("tid") == tid and e.get("pid") == pid)
    starts = [t for t, _ in launches]
    ranges = {}
    for e in host_events:
        if (e["cat"] == "user_annotation" and e["name"].startswith(RANGE_PREFIX)
                and e["name"] != WINDOW and e.get("tid") == tid and lo <= e["ts"] <= hi):
            i0 = bisect.bisect_left(starts, e["ts"])
            i1 = bisect.bisect_right(starts, e["ts"] + e["dur"])
            us = sum(by_corr.get(c, 0.0) for _, c in launches[i0:i1])
            ranges.setdefault(e["name"], []).append(us * 1e-6)

    ops = {}
    for e in dev:
        name = e["name"][:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (min(hi, e["ts"] + e.get("dur", 0))
                                          - max(lo, e["ts"]))
    host = _Host(host_events, tid, pid)
    idle = {}
    for g0, g1 in gaps:
        name = host.doing(0.5 * (g0 + g1))
        idle[name] = idle.get(name, 0.0) + (g1 - g0)

    def ranked(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(window_s=(hi - lo) * 1e-6, busy_s=busy * 1e-6, ranges=ranges,
                device_ops=ranked(ops), idle_gaps=ranked(idle))

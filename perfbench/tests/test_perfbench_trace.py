"""The idle share, a range's device time and the breakdown on a
synthetic Chrome trace."""
import pytest

from perfbench import trace


def _ev(cat, name, ts, dur, tid=1, pid=1, corr=None):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid, pid=pid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def timeline():
    """Window [0, 100) us on thread 1; a get_k range [10, 30) launches two
    kernels (correlations 1, 2) that run [20, 50) and [45, 60); a later
    kernel (3), launched outside the range, runs [80, 90)."""
    return [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _ev("user_annotation", "perfbench.solve", 5, 90),
        _ev("user_annotation", "perfbench.get_k", 10, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=2),
        _ev("cpu_op", "aten::item", 60, 15),
        _ev("cuda_runtime", "cudaLaunchKernel", 76, 1, corr=3),
        _ev("kernel", "k2", 20, 30, tid=7, pid=0, corr=1),
        _ev("kernel", "gemm", 45, 15, tid=7, pid=0, corr=2),
        _ev("kernel", "gemm", 80, 10, tid=7, pid=0, corr=3),
        _ev("kernel", "outside", 150, 10, tid=7, pid=0, corr=4),
    ]


def test_busy_and_idle_share():
    s = trace.summarize(timeline())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(50e-6)        # [20, 60) and [80, 90)
    assert trace.idle_pct(s) == pytest.approx(50.0)
    assert trace.idle_pct(None) is None
    assert trace.idle_pct(dict(s, busy_s=0.0)) is None


def test_range_device_time_by_correlation():
    s = trace.summarize(timeline())
    assert s["ranges"]["perfbench.get_k"] == [pytest.approx(45e-6)]
    assert s["ranges"]["perfbench.solve"] == [pytest.approx(55e-6)]
    assert trace.range_seconds(s, "perfbench.get_k") == [pytest.approx(45e-6)]
    assert trace.range_seconds(s, "perfbench.build_isdf") is None
    assert trace.range_seconds(dict(s, ranges={"perfbench.get_k": [1e-5, 0.0]}),
                               "perfbench.get_k") is None


def test_breakdown():
    s = trace.summarize(timeline())
    assert s["device_ops"][0] == ["k2", pytest.approx(30e-6)]
    assert s["device_ops"][1] == ["gemm", pytest.approx(25e-6)]
    idle = dict((k, v) for k, v in s["idle_gaps"])
    # [0, 20): the host in get_k's launches, then [60, 80): in aten::item
    assert idle["perfbench.get_k/python"] == pytest.approx(20e-6)
    assert idle["perfbench.solve/aten::item"] == pytest.approx(20e-6)
    assert sum(idle.values()) == pytest.approx(50e-6)


def test_no_window_reads_nothing():
    assert trace.summarize([_ev("kernel", "k", 0, 1)]) is None


def test_merge_overlaps():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]

"""Device milliseconds of one robust-K call: the device operations
launched inside the benchmark's ``perfbench.get_k`` range around
``df/isdf.get_k_robust``, median over the traced calls."""
import statistics

from perfbench.trace import range_seconds


def read(run):
    times = range_seconds(run.trace, "perfbench.get_k")
    return 1e3 * statistics.median(times) if times else None

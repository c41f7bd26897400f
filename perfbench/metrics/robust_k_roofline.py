"""Share of the robust-K exchange's roofline: the least time its work
needs on the card (``perfbench/roofline.py``, counted from the shapes)
over the median device time of a traced call."""
import statistics

from perfbench.roofline import least_seconds, robust_k_work
from perfbench.trace import range_seconds


def read(run):
    times = range_seconds(run.trace, "perfbench.get_k")
    if not times or not run.shapes:
        return None
    s = run.shapes
    least, _ = least_seconds(*robust_k_work(s["ng"], s["nao"], s["nip"]))
    return 100.0 * least / statistics.median(times)

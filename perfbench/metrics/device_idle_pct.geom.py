"""Share of the traced geometry step in which no operation ran on the
card: 100 (1 - busy / window), the union of device intervals from the
profiler's timeline."""
from perfbench.trace import idle_pct


def read(run):
    return idle_pct(run.trace)

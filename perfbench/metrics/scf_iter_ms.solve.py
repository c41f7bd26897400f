"""Milliseconds per SCF iteration: the host-clock seconds of the window's
untraced solves over their iterations."""


def read(run):
    plain = [r for r in run.records if not r.get("traced")]
    iters = sum(r["niter"] for r in plain)
    if not iters:
        return None
    return 1e3 * sum(r["seconds"] for r in plain) / iters

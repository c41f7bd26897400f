"""SCF iterations per solve: the ``niter`` of ``scf_kernel``'s result,
averaged over the window's solves."""


def read(run):
    if not run.records:
        return None
    return sum(r["niter"] for r in run.records) / len(run.records)

"""Seconds of the greedy interpolation-point selection a step: the
program's StageTimer stage ``isdf_select`` (it synchronises the device),
averaged over the untraced steps of a traced run."""

STAGE = "isdf_select"


def read(run):
    got = [r["stages"][STAGE] for r in run.records if STAGE in r.get("stages", {})]
    return sum(got) / len(got) if got else None

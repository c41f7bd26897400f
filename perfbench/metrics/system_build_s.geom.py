"""Seconds of the system set-up a step: the program's StageTimer stages of
``build_scf_system`` (AO plan and collocation, S/T, PP, Coulomb kernel),
averaged over the untraced steps of a traced run."""

STAGES = ("ao_plan", "aoR", "S/T", "pp", "coulomb")


def read(run):
    got = [sum(r["stages"].get(s, 0.0) for s in STAGES)
           for r in run.records if "ao_plan" in r.get("stages", {})]
    return sum(got) / len(got) if got else None

"""Readings that a cell's limits are set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds <s> [--out chiprun_out/cal.jsonl]

For every seed it runs the cell as a benchmark run does, with a short
window, and prints the numbers compared with the reference (the lower
readings: sound runs of the program). For every control seed it runs the
program's own float32 path in its place, the next precision below the
configuration's float64, and prints the same numbers (the upper readings).
The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness, registry

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    bench = registry.load_benchmark(ROOT)
    cell = registry.find_workload(bench, args.workload)
    out = open(args.out, "a") if args.out else None
    readings = {"program": {}, "control": {}}
    runs = [("program", int(s), None) for s in args.seeds.split(",") if s]
    runs += [("control", int(s), "float32") for s in args.control_seeds.split(",") if s]
    for side, seed, dtype in runs:
        t = time.perf_counter()
        r = harness.run_cell(bench, cell, seed, args.seconds, False, "cuda",
                             time.perf_counter(), dtype=dtype)
        line = dict(workload=args.workload, side=side, seed=seed, correct=r["correct"],
                    attempted=r["attempted"], failed=r["failed"],
                    checks={k: v["value"] for k, v in r["checks"].items()},
                    metrics={k: v["value"] for k, v in r["metrics"].items()},
                    peak=r["device"]["memory_peak_bytes"],
                    seconds=time.perf_counter() - t)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for k, v in line["checks"].items():
            readings[side].setdefault(k, []).append(v)
    summary = {"workload": args.workload,
               "lower": {k: max(v) for k, v in readings["program"].items()},
               "upper": {k: min(v) for k, v in readings["control"].items()}}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()


if __name__ == "__main__":
    main()

"""Run one cell of the benchmark once on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic mix,
per-layer metrics and limits are found by name (``BENCHMARK.json``,
``perfbench/{configs,traffic,metrics,limits}/``). The last line of
standard output is the result as one JSON object; the numbers compared
with the reference close standard error and the result line. Without a
card, with fewer cards than the cell asks for, or with JAX or the JAX
package loaded once the window has closed, it prints no result and exits
with a code other than 0.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = "4"     # one process, few threads: steadier host timings
# Python's bytecode of every module the run imports (torch's included) is
# kept at a fixed place in the checkout and written even where the
# environment asks for none: compiling torch's sources anew took 6-8 s of
# every run's set-up. The first run of a checkout writes it.
PYCACHE = os.path.join(ROOT, ".perfbench_cache", "pycache")
sys.pycache_prefix = PYCACHE
sys.dont_write_bytecode = False

for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = THREADS


def fail(code, msg):
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from perfbench import registry

    bench = registry.load_benchmark(ROOT)
    cell = registry.find_workload(bench, args.workload)
    import torch

    marks = [("torch_import", time.perf_counter() - T0)]
    torch.set_num_threads(int(THREADS))
    if not torch.cuda.is_available():
        fail(3, "no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        fail(3, f"{args.workload} needs {cell['chips']} cards, "
                f"{torch.cuda.device_count()} present")
    torch.empty(1, device="cuda")
    marks.append(("cuda_context", time.perf_counter() - T0))
    try:
        import pyscf_isdf_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(4, f"the program is not in this checkout: {exc}")
    from perfbench import harness

    marks.append(("program_import", time.perf_counter() - T0))
    result = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", T0, marks=marks)
    bad = harness.forbidden_modules()
    if bad:
        fail(5, f"JAX or the JAX package was loaded: {bad}")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Host time of kernel K1's planning stage at the main path's cell.

    python3 tools/k1_plan_time.py [--root DIR] [--reps N]

Needs one CUDA card. Times ``cuda_ao.make_ao_evaluator(diamond 3x3x3 at
48^3, device='cuda')`` -- host planning and staging of the inputs on the
card, the work of ``chip_smoke.py``'s 'ao_plan' stage -- ``reps`` times
after one warm-up call, with ``pyscf_isdf_tpu_torch`` imported from DIR
(default: this checkout), and prints each time and the median. Run it on
two checkouts in turns (A B B A) to compare their planners.
"""
import argparse
import os
import statistics
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_plan_time: needs a CUDA card")
    from pyscf_isdf_tpu_torch.models import diamond_supercell
    from pyscf_isdf_tpu_torch.ops import cuda_ao

    cell = diamond_supercell((3, 3, 3), mesh=(48, 48, 48))
    cuda_ao.make_ao_evaluator(cell, device="cuda")
    times = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cuda_ao.make_ao_evaluator(cell, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"make_ao_evaluator from {cuda_ao.__file__}: median "
          f"{statistics.median(times):.4f} s over {len(times)} "
          f"({', '.join(f'{t:.4f}' for t in times)}) on "
          f"{torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()

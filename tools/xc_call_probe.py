#!/usr/bin/env python3
"""Per-call XC seconds of the Gamma host loop at the main width.

    python3 tools/xc_call_probe.py [ROOT]

Runs scf_kernel on diamond 3x3x3 gth-szv 48^3 with robust-fit ISDF c=16
(chip_smoke.py's phases 5 and 8a) four times in one process: HSE06, PBE0,
then HSE06 twice while the PBE0 run's factorization (3 GB) is still held,
and prints the StageTimer's 'XC' seconds of every iteration. ROOT (default:
this checkout) is the directory holding the package to time, so a second
checkout (say a parent commit unpacked under scratch_chip/) can be timed
the same way in the same call. Needs a CUDA card.
"""
import os
import statistics
import subprocess
import sys

root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                       else os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, root)

import torch  # noqa: E402

from pyscf_isdf_tpu_torch.models import diamond_supercell  # noqa: E402
from pyscf_isdf_tpu_torch.ops import cuda_lib  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system, scf_kernel  # noqa: E402
from pyscf_isdf_tpu_torch.utils.timing import StageTimer  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("xc_call_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"{root}: torch {torch.__version__}, {smi}", flush=True)
    cuda_lib.load()
    system = build_scf_system(diamond_supercell((3, 3, 3), mesh=(48, 48, 48)),
                              device="cuda")
    held = None
    for run, xc in enumerate(("hse06", "pbe0", "hse06", "hse06")):
        timer = StageTimer("cuda")
        res = scf_kernel(system, xc=xc, df="isdf-robust", isdf_c=16, conv_tol=1e-8,
                         timer=timer)
        print(f"run {run} {xc}: {res['niter']} iterations, XC ms per call "
              + " ".join(f"{1e3 * x:.1f}" for x in timer.seconds["XC"])
              + f"; cycle median {1e3 * statistics.median(timer.seconds['cycle']):.1f} ms"
              + ("; a 3 GB factorization held" if held is not None else ""), flush=True)
        if run == 1:
            held = res["isdf"]
        del res


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the float64 robust-K kernel (K2) at forced block configurations.

    python3 tools/k2_configs.py

Needs one CUDA card and ``nvcc``; run from the root of a checkout. For
each shape it holds the kernel, launched with a given cluster size and
stage count, against the plain torch version (relative error, and whether
two launches agree bitwise), and at the full-size shapes prints its
CUDA-event time beside the one-call library formulation's. The port's
planner (``ops/cuda_robust_k.block_f64``) takes the smallest cluster whose
blocks fit; this script is how that choice was measured.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import cuda_time_ms  # noqa: E402
from pyscf_isdf_tpu_torch.ops import cuda_lib  # noqa: E402
from pyscf_isdf_tpu_torch.ops import cuda_robust_k as rk  # noqa: E402

# (ng, nao, n_ip) and the (cluster size, stages) to try
CASES = [((110592, 216, 3456), [(1, 3), (2, 3)]),
         ((4099, 37, 333), [(1, 3), (2, 3), (3, 2)]),
         ((777, 11, 70), [(1, 3), (2, 2)]),
         ((1000, 300, 90), [(2, 3), (3, 3)]),
         ((110592, 702, 5616), [(3, 2), (4, 3), (4, 2), (6, 3), (8, 3)])]


def cdiv(a, b):
    return -(-a // b)


def launch(lib, aoR, B, Vxi, cs, stages):
    (ng, nao), nip = aoR.shape, B.shape[0]
    width = cdiv(cdiv(cdiv(nao, 8) * 8, cs), 8) * 8   # as block_f64 sets it
    slots = lib.robust_k_cross_f64_slots(stages, width, cs)
    nsplit, gps = rk.split_g(ng, cdiv(nip, rk.TP64) * cs, slots)
    part = torch.empty((nsplit, nip, nao), dtype=torch.float64, device="cuda")
    out = torch.empty((nip, nao), dtype=torch.float64, device="cuda")
    rc = lib.robust_k_cross_f64(
        ng, nao, nip, nsplit, gps, stages, width, cs, aoR.data_ptr(),
        B.data_ptr(), Vxi.data_ptr(), part.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "robust_k_cross_f64")
    return out, slots, nsplit


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2_configs: needs a CUDA card")
    lib = cuda_lib.load()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (ng, nao, nip), configs in CASES:
        aoR = torch.randn(ng, nao, generator=gen, device="cuda", dtype=torch.float64)
        B = torch.randn(nip, nao, generator=gen, device="cuda", dtype=torch.float64)
        Vxi = torch.randn(nip, ng, generator=gen, device="cuda", dtype=torch.float64)
        ref = rk.robust_k_cross_plain(aoR, B, Vxi)
        big = ng > 100000
        for cs, stages in configs:
            out, slots, nsplit = launch(lib, aoR, B, Vxi, cs, stages)
            again = launch(lib, aoR, B, Vxi, cs, stages)[0]
            torch.cuda.synchronize()
            rel = float((out - ref).abs().max() / ref.abs().max())
            line = (f"ng={ng} nao={nao} n_ip={nip} cs={cs} stages={stages} "
                    f"slots={slots} nsplit={nsplit}: relative error {rel:.3e}, "
                    f"bitwise equal {torch.equal(out, again)}")
            if big:
                ms = cuda_time_ms(lambda: launch(lib, aoR, B, Vxi, cs, stages))
                line += (f", {ms:.3f} ms "
                         f"({4.0 * ng * nao * nip / ms / 1e9:.1f} TFLOP/s)")
            print(line, flush=True)
        if big:
            ms = cuda_time_ms(lambda: (Vxi.T * (aoR @ B.T)).T @ aoR)
            print(f"ng={ng} nao={nao} n_ip={nip} library: {ms:.3f} ms", flush=True)
        del aoR, B, Vxi, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

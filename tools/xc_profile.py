"""Time the port's XC functionals on one CUDA card at the main path's
width (110592 grid points, float64) and profile HSE06's.

    python3 tools/xc_profile.py

Prints the mean wall time of five ``exc_vxc``/``exc_vxc_mgga`` calls per
functional after two warm-up calls (device synchronised), then
``torch.profiler`` tables of one HSE06 call: host time, kernel launches
and device time by operator.
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pyscf_isdf_tpu_torch.ops.xc import XCSpec  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("xc_profile: needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    n = 110592
    kw = dict(device="cuda", dtype=torch.float64, generator=g)
    rho = torch.rand(n, **kw) + 1e-3
    sigma = torch.rand(n, **kw) * rho ** (8 / 3)
    tau = sigma / (8 * rho) + torch.rand(n, **kw) * rho ** (5 / 3)
    print(torch.cuda.get_device_name(0), flush=True)
    for name in ["pbe0", "hse06", "b3lyp", "scan", "r2scan", "tpss"]:
        spec = XCSpec(name)
        if spec.family == "gga":
            def f():
                return spec.exc_vxc(rho, sigma)
        else:
            def f():
                return spec.exc_vxc_mgga(rho, sigma, tau)
        for _ in range(2):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            f()
        torch.cuda.synchronize()
        print(f"{name} {(time.perf_counter() - t0) / 5 * 1e3:.2f} ms", flush=True)
    spec = XCSpec("hse06")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        spec.exc_vxc(rho, sigma)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=10))


if __name__ == "__main__":
    main()

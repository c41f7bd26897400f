"""Profile the PBE0 forces of ``chip_smoke.py`` 13a on one CUDA card.

    python3 tools/grad_profile.py

Runs the main path's SCF (phase 5), moves atom 0 of its diamond 3x3x3
cell by +0.05 bohr along x, converges a PBE0 FFTDF SCF there from phase
5's density, then times ``rhf_gradient(xc='pbe0')`` once as a warm-up and
once under ``torch.profiler``: it prints the stage seconds (setup, energy
forward, backward and in it the AO-derivative pass), the device time by
operator, and the host time by operator and by the autograd nodes of the
backward. Then it times the backward's two ways of pulling the aoR
cotangent back onto the atoms, on the cotangent of that gradient, with
CUDA events (median of 5 after a warm-up): ``_ao_vjp_positions`` (the
AO-derivative pass in blocks of ``VJP_BLOCK`` points) and
``_ao_vjp_images`` (the image-resolved terms) at ``VJP_BLOCK`` and at
1024 points a block, with the largest difference of their forces.
"""
import dataclasses
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from pyscf_isdf_tpu_torch.grad import rhf_gradient  # noqa: E402
from pyscf_isdf_tpu_torch.ops import ao_eval, cuda_lib  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system, scf_kernel  # noqa: E402
from pyscf_isdf_tpu_torch.utils.timing import StageTimer  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("grad_profile: needs a CUDA card")
    print(torch.cuda.get_device_name(0), flush=True)
    cuda_lib.load()
    main_path = cs.phase_main(torch)
    cell0 = main_path["system"].cell
    coords = np.array(cell0.coords)
    coords[0, 0] += 0.05
    system = build_scf_system(dataclasses.replace(cell0, coords=coords), device="cuda")
    res = scf_kernel(system, xc="pbe0", df="fftdf", dm0=main_path["res"]["dm"],
                     conv_tol=1e-11)
    rhf_gradient(system, res, xc="pbe0", device="cuda")
    torch.cuda.synchronize()
    timer = StageTimer("cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rhf_gradient(system, res, xc="pbe0", device="cuda", timer=timer)
        torch.cuda.synchronize()
    print("stage seconds:", {k: round(sum(v), 3) for k, v in timer.seconds.items()})
    ka = prof.key_averages()
    print(ka.table(sort_by="cuda_time_total", row_limit=25, max_name_column_width=60))
    print(ka.table(sort_by="cpu_time_total", row_limit=40, max_name_column_width=60))
    print(f"device time {sum(e.self_device_time_total for e in ka) / 1e3:.1f} ms in all")
    compare_vjps(system, res)


def compare_vjps(system, res):
    """Time the two pullbacks of the gradient's aoR cotangent onto the atoms."""
    seen = {}
    positions_vjp = ao_eval._ao_vjp_positions

    def keep(packed, coords, images, centers, gout, **kw):
        seen.update(args=(packed, coords, images, centers), gout=gout)
        return positions_vjp(packed, coords, images, centers, gout, **kw)

    ao_eval._ao_vjp_positions = keep
    try:
        rhf_gradient(system, res, xc="pbe0", device="cuda")
    finally:
        ao_eval._ao_vjp_positions = positions_vjp
    if not seen:
        print("vjp comparison: the gradient did not take the positions-only pullback")
        return
    packed, coords, images, centers = seen["args"]
    gout = seen["gout"]
    ways = {
        f"_ao_vjp_positions, block {ao_eval.VJP_BLOCK}":
            lambda: positions_vjp(packed, coords, images, centers, gout),
        f"_ao_vjp_images, block {ao_eval.VJP_BLOCK}":
            lambda: ao_eval._ao_vjp_images(packed, coords, images, centers, None, gout,
                                           block=ao_eval.VJP_BLOCK)[0],
        "_ao_vjp_images, block 1024":
            lambda: ao_eval._ao_vjp_images(packed, coords, images, centers, None, gout,
                                           block=1024)[0],
    }
    ref = None
    for name, fn in ways.items():
        fn()
        times = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            a.record()
            g = fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        ref = g if ref is None else ref
        print(f"vjp {name}: {np.median(times):.1f} ms (median of 5; "
              f"{', '.join(f'{t:.1f}' for t in times)}), {peak:.2f} GB above its inputs, "
              f"max|g - first| {float((g - ref).abs().max()):.3e}", flush=True)


if __name__ == "__main__":
    main()

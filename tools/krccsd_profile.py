#!/usr/bin/env python3
"""Where the time of one closed-shell KRCCSD iteration goes, on the card.

    python3 tools/krccsd_profile.py [--basis gth-dzvp] [--nk 2,2,2] [--out FILE]

Builds the diamond primitive k-system (default mesh, Gamma-centred k-mesh)
and its KRHF (FFTDF, 'ewald') as ``chip_smoke.py`` 15a does, times
``fft_ao2mo.ao2mo_7d`` at the default pair chunk and at
``cc.kccsd_blocked.AO2MO_CHUNK`` (and their largest difference), then runs
one warm amplitude update (cc/krccsd.make_rupdate) and profiles a second
one with ``torch.profiler``: the device time by kernel, the update's wall
and device time and the device's idle share, and the bytes the index
gathers write. Needs the card.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--basis", default="gth-dzvp")
    ap.add_argument("--nk", default="2,2,2")
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyscf_isdf_tpu_torch import lattice
    from pyscf_isdf_tpu_torch.cc.kccsd_blocked import (AO2MO_CHUNK, _scf_arrays,
                                                       blocked_denominators)
    from pyscf_isdf_tpu_torch.cc.krccsd import (SK, _PAB, _abij, _t2_from_mixed,
                                                build_spatial_eris, make_rupdate)
    from pyscf_isdf_tpu_torch.df import fft_ao2mo
    from pyscf_isdf_tpu_torch.models import diamond_primitive
    from pyscf_isdf_tpu_torch.scf import build_kscf_system, kscf_kernel

    if not torch.cuda.is_available():
        raise SystemExit("krccsd_profile: needs a CUDA card")
    dev = "cuda"
    lines = []

    def say(msg):
        print(msg, flush=True)
        lines.append(msg)

    cell = diamond_primitive(basis=args.basis)
    kpts = lattice.make_kpts(cell.a, [int(x) for x in args.nk.split(",")])
    ksys = build_kscf_system(cell, kpts, device=dev)
    kres = kscf_kernel(ksys, xc=None, exxdiv="ewald", conv_tol=1e-10, device=dev)
    say(f"{torch.cuda.get_device_name(0)}; diamond {args.basis}, mesh {tuple(cell.mesh)}, "
        f"nk {len(kpts)}; KRHF {kres['e_tot']:.10f} in {kres['niter']} iterations")

    mo_c, _, _ = _scf_arrays(kres, dev)
    outs = {}
    for chunk in (16, AO2MO_CHUNK):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[chunk] = fft_ao2mo.ao2mo_7d(ksys, mo_c, chunk=chunk, device=dev)
        torch.cuda.synchronize()
        say(f"ao2mo_7d chunk {chunk}: {time.perf_counter() - t0:.3f} s")
    diff = float((outs[16] - outs[AO2MO_CHUNK]).abs().max())
    say(f"ao2mo_7d chunk 16 against {AO2MO_CHUNK}: max |diff| {diff:.3e} "
        f"(largest entry {float(outs[16].abs().max()):.3e})")
    del outs

    ka, B, eo, ev, no, nv = build_spatial_eris(ksys, kres, device=dev)
    nk = ka.nk
    D1, D2 = blocked_denominators(ka, eo, ev, dev)
    dt = B["oovv"].c[_PAB].dtype
    fov = SK({(0, 0): torch.zeros((nk, no, nv), dtype=dt, device=dev)})
    abij = _abij(B, ka)
    t2 = _t2_from_mixed(abij.c[_PAB] / D2, ka)
    t1 = SK({(0, 0): torch.zeros((nk, no, nv), dtype=dt, device=dev)})
    update = make_rupdate(ka)
    t1, t2n = update(t1, t2, fov, B, D1, D2, abij)        # warm
    t2 = _t2_from_mixed(t2n.c[_PAB], ka)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        update(t1, t2, fov, B, D1, D2, abij)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kernels alone (an operator's row repeats its kernels' time)
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    say(f"one update: wall {1e3 * wall:.1f} ms, device {dev_us / 1e3:.1f} ms, idle share "
        f"{max(0.0, 1 - dev_us / 1e6 / wall):.3f}")
    say(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20,
                                  max_name_column_width=60))
    gather = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.key in ("aten::index", "aten::copy_"))
    gemm = sum(e.self_device_time_total for e in prof.key_averages()
               if e.key == "aten::bmm")
    say(f"index gathers and copies {gather / 1e3:.1f} ms, batched GEMMs {gemm / 1e3:.1f} ms "
        f"of {dev_us / 1e3:.1f} ms on the device")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time variants of the AO collocation kernel (K1) against the shipped one.

    python3 tools/k1_variants.py

Needs one CUDA card and ``nvcc``; run from the root of a checkout. Each
variant is the shipped ``pyscf_isdf_tpu_torch/csrc/ao_collocate.cu`` with
a few lines replaced. All are built in parallel into
``pyscf_isdf_tpu_torch/_build/k1_variants/``, held against the plain torch
version (float64, 1e-12 absolute) and timed with CUDA events on the
brick plans of diamond 3x3x3 at 48^3, gth-szv (the main path) and
gth-dzvp, in turns: shipped, each variant, shipped again. ptxas' register
and spill lines of the float64 instantiations these cells use are printed
beside the times. This is how the kernel's choices were measured.
"""
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import cuda_time_ms  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_supercell  # noqa: E402
from pyscf_isdf_tpu_torch.ops import cuda_ao, cuda_lib  # noqa: E402

SRC = os.path.join(ROOT, "pyscf_isdf_tpu_torch", "csrc", "ao_collocate.cu")
OUT = os.path.join(ROOT, "pyscf_isdf_tpu_torch", "_build", "k1_variants")

# name -> [(shipped text, replacement)]
VARIANTS = {
    "shipped": [],
    # every primitive of the planner's prefix at every point: no
    # per-point cut, so no divergence inside a warp
    "no_point_cut": [("        if (arg < cut) break;\n", "")],
    # 256 or 512 threads a CTA, two points a thread or one
    "threads256": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
    "threads512": [("constexpr int kThreads = 128;", "constexpr int kThreads = 512;")],
}


def build_all():
    os.makedirs(OUT, exist_ok=True)
    text = open(SRC).read()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"variant {name}: shipped text not found:\n{old}")
            src = src.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        lib = os.path.join(OUT, f"{name}.so")
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", lib, cu]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs, logs = {}, {}
    for name, (lib, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{logs[name]}")
        fn = ctypes.CDLL(lib).ao_collocate_f64
        fn.argtypes = list(cuda_lib._SIGNATURES["ao_collocate_f64"])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs, logs


def ptxas_lines(log, keys):
    """Registers and spills of the float64 instantiations (L, K) in keys."""
    out, key = [], None
    for line in log.splitlines():
        m = re.search(r"ao_collocate_kernelIdLi(\d)ELi(\d)E", line)
        if m and "Compiling entry function" in line:
            key = (int(m.group(1)), int(m.group(2)))
        elif key in keys and re.search(r"spill|Used \d+ registers", line):
            out.append(f"L={key[0]} K={key[1]}: {line.strip()}")
    return out


def launch(fn, l, counts, nprim, cuts, centers, exps, coeffs, coordsT, dest,
           imgs, ng):
    """One launch of a variant, as cuda_ao.collocate launches the shipped one."""
    ns, nb = counts.shape
    P, K, imax = exps.shape[1], coeffs.shape[2], imgs.shape[3]
    out = torch.empty((ns * K * (2 * l + 1), ng), dtype=torch.float64, device="cuda")
    rc = fn(l, K, P, ns, nb, coordsT.shape[1] // nb, imax, ng, counts.data_ptr(),
            nprim.data_ptr(), cuts.data_ptr(), centers.data_ptr(), exps.data_ptr(),
            coeffs.data_ptr(), coordsT.data_ptr(), dest.data_ptr(),
            imgs.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "ao_collocate_f64 variant")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: needs a CUDA card")
    libs, logs = build_all()
    order = ["shipped"] + [n for n in VARIANTS if n != "shipped"] + ["shipped"]
    for basis in ("gth-szv", "gth-dzvp"):
        cell = diamond_supercell((3, 3, 3), mesh=(48, 48, 48), basis=basis)
        ev = cuda_ao.make_ao_evaluator(cell, device="cuda")
        refs = [cuda_ao.collocate_plain(*args) for args in ev.staged]
        keys = {(p.l, p.K) for p in ev.plans}
        print(f"== diamond 3x3x3 {basis} 48^3, bricks (nao {cell.nao})", flush=True)
        for name in order:
            fn = libs[name]
            err = max(float((launch(fn, *args) - ref).abs().max())
                      for args, ref in zip(ev.staged, refs))
            ms = cuda_time_ms(lambda: [launch(fn, *a) for a in ev.staged], reps=9)
            print(f"{name:14s} {ms:8.4f} ms  max|variant-plain| {err:.3e}", flush=True)
            if err >= 1e-12:
                raise SystemExit(f"variant {name} disagrees with the plain version")
        for name in VARIANTS:
            for line in ptxas_lines(logs[name], keys):
                print(f"ptxas {name}: {line}")
        del ev, refs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

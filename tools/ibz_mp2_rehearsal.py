#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's phases 10c and 10d at their full k size.

    python3 tools/ibz_mp2_rehearsal.py [--c C] [--threads N]
    python3 tools/ibz_mp2_rehearsal.py --mesh-scan

Default: the diamond primitive cell (gth-szv, 16^3) on the Gamma-centred
3x3x3 k-mesh (nk 27), float64 on the CPU: KRHF (fftdf), KMP2, KUMP2 of a
closed-shell KUHF, the IBZ KRHF and kmp2_ksymm, THC-KMP2 on
build_isdf_k(c=C, keep_xi=True), then the IBZ against the full-zone
KRKS (LDA and PBE0/isdf at c=C, median seconds an iteration) and a
Fermi-smeared IBZ KRKS LDA against the full zone. The default c is 6,
not chip_smoke's 10: the per-q kernels of c=10 hold 9.3 GB.

--mesh-scan: |E_IBZ - E_full| of KRKS LDA on the 2x2x2 k-mesh at meshes
14^3 to 24^3, the mesh's symmetry-breaking collocation error that the
reduction cannot remove.
"""
import argparse
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from pyscf_isdf_tpu_torch import lattice  # noqa: E402
from pyscf_isdf_tpu_torch.df import isdf_k  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.mp.kmp2 import kmp2_energy, kmp2_ksymm_energy, kump2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.mp.thc import thc_kmp2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, kscf_ibz_kernel, kscf_kernel, kuhf_kernel,
)
from pyscf_isdf_tpu_torch.utils.timing import StageTimer  # noqa: E402

CPU = dict(device="cpu")


def system(mesh, nks):
    cell = diamond_primitive(mesh=(mesh,) * 3)
    return build_kscf_system(cell, lattice.make_kpts(cell.a, nks), **CPU)


def mesh_scan():
    for mesh in (14, 16, 18, 20, 22, 24):
        s = system(mesh, [2, 2, 2])
        a = kscf_ibz_kernel(s, xc="lda", conv_tol=1e-10, **CPU)
        b = kscf_kernel(s, xc="lda", conv_tol=1e-10, **CPU)
        print(f"mesh {mesh}^3 2x2x2 LDA: E_IBZ - E_full {a['e_tot'] - b['e_tot']:.3e} Ha, "
              f"max |dm_IBZ - dm_full| {float((a['dm_full'] - b['dm']).abs().max()):.3e}",
              flush=True)


def rehearsal(c):
    s = system(16, [3, 3, 3])
    t0 = time.perf_counter()

    def stamp(*a):
        print(*a, f"({time.perf_counter() - t0:.1f} s)", flush=True)

    r = kscf_kernel(s, xc=None, conv_tol=1e-10, **CPU)
    stamp(f"KRHF E/cell {r['e_tot']:.10f}, {r['niter']} iterations")
    e = kmp2_energy(s, r, **CPU)
    stamp(f"KMP2 {e:.12f}")
    ru = kuhf_kernel(s, xc=None, conv_tol=1e-10, **CPU)
    stamp(f"KUMP2 - KMP2 {kump2_energy(s, ru, **CPU) - e:.3e}")
    ri = kscf_ibz_kernel(s, xc=None, conv_tol=1e-10, **CPU)
    stamp(f"IBZ KRHF - KRHF {ri['e_tot'] - r['e_tot']:.3e} Ha ({ri['niter']} iterations); "
          f"kmp2_ksymm - KMP2 {kmp2_ksymm_energy(s, ri, **CPU) - e:.3e}")
    fac = isdf_k.build_isdf_k(s.cell, s.aoR_k, s.kpts, c=c, keep_xi=True)
    stamp(f"build_isdf_k c={c:g}: n_ip {fac.n_ip}")
    stamp(f"THC-KMP2 - KMP2 {thc_kmp2_energy(s, r, fac, **CPU) - e:.3e}")
    del fac
    for xc, kw in (("lda", {}), ("pbe0", dict(df="isdf", isdf_c=c))):
        ti, tf = StageTimer(), StageTimer()
        a = kscf_ibz_kernel(s, xc=xc, conv_tol=1e-10, timer=ti, **CPU, **kw)
        b = kscf_kernel(s, xc=xc, conv_tol=1e-10, timer=tf, **CPU, **kw)
        stamp(f"{xc}: nk_ibz {a['ibz'].nk_ibz}, iterations {a['niter']} / {b['niter']}, "
              f"E_IBZ - E_full {a['e_tot'] - b['e_tot']:.3e} Ha, median s an iteration "
              f"{statistics.median(ti.seconds['cycle']):.4f} / "
              f"{statistics.median(tf.seconds['cycle']):.4f}")
    a = kscf_ibz_kernel(s, xc="lda", sigma=0.01, **CPU)
    b = kscf_kernel(s, xc="lda", sigma=0.01, **CPU)
    stamp(f"smeared LDA: d e_free {a['e_free'] - b['e_free']:.3e} Ha, d mu "
          f"{a['mu'] - b['mu']:.3e}, entropy {a['entropy']:.6e} / {b['entropy']:.6e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--c", type=float, default=6.0)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--mesh-scan", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    mesh_scan() if args.mesh_scan else rehearsal(args.c)

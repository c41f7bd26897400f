#!/usr/bin/env python3
"""CPU rehearsal of chip_smoke.py's phase 11, through its own functions.

    python3 tools/slice8_rehearsal.py k [--mesh M] [--nk N] [--threads T]
    python3 tools/slice8_rehearsal.py roks [--mesh M] [--threads T]

``k``: 11b-11e and 11g at their full size on the CPU (float64): the
diamond primitive cell (gth-szv, 16^3, or M^3) on the Gamma-centred 3x3x3
(NxNxN) k-mesh, with the KRKS LDA, KRHF and KRKS PBE0/isdf c=10
references those sub-phases take from phases 7, 10c and 10d, then
KROKS, KGHF (the closed shell and isdf against fftdf from one
non-collinear start), DFT+U, the bands at the SCF k-points and along
L-Gamma-X-Gamma, and the staggered KMP2 with the H2 goldens.

``roks``: 11a and 11f on the main path's supercell (diamond 3x3x3
gth-szv, nao 216) at a reduced mesh (default 36^3 for the card's 48^3):
the ROKS and UKS PBE0 triplet on plain ISDF c=16 and the charge-
constrained LDA, to see how the methods converge on this state before
the card runs it at full width.

Every time printed here is a CPU time: it sizes a prediction and is never
a device number.
"""
import argparse
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pyscf_isdf_tpu_torch import lattice  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive, diamond_supercell  # noqa: E402
from pyscf_isdf_tpu_torch.mp.kmp2 import kmp2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_kscf_system, build_scf_system, kscf_kernel  # noqa: E402
from pyscf_isdf_tpu_torch.utils.timing import StageTimer  # noqa: E402

DEV = "cpu"


def kpart(mesh, nk):
    cell = diamond_primitive(mesh=(mesh,) * 3)
    ksys = build_kscf_system(cell, lattice.make_kpts(cell.a, [nk] * 3), device=DEV)
    t0 = time.perf_counter()
    krks = kscf_kernel(ksys, xc="lda,vwn", conv_tol=1e-10, device=DEV)
    krhf = kscf_kernel(ksys, xc=None, conv_tol=1e-10, device=DEV)
    timer = StageTimer(DEV)
    pbe0 = kscf_kernel(ksys, xc="pbe0", df="isdf", isdf_c=10, conv_tol=1e-10, device=DEV,
                       timer=timer)
    e_kmp2 = kmp2_energy(ksys, krhf, device=DEV)
    cs.log(f"references: KRKS LDA {krks['e_tot']:.10f} ({krks['niter']}), KRHF "
           f"{krhf['e_tot']:.10f} ({krhf['niter']}), KRKS PBE0/isdf {pbe0['e_tot']:.10f} "
           f"({pbe0['niter']}), KMP2 {e_kmp2:.12f}; {time.perf_counter() - t0:.1f} s")
    for name, fn in (
            ("11b", lambda: cs.phase_krohf(torch, ksys, krks["e_tot"], pbe0["e_tot"],
                                           cs.median_ms(timer)["cycle"], dev=DEV)),
            ("11c", lambda: cs.phase_kghf(torch, ksys, krhf["e_tot"], dev=DEV)),
            ("11d", lambda: cs.phase_dftu(torch, ksys, krks["e_tot"], dev=DEV)),
            ("11e", lambda: cs.phase_bands(torch, ksys, krks, krhf, dev=DEV)),
            ("11g", lambda: cs.phase_stagger(torch, ksys, krhf, e_kmp2, dev=DEV))):
        t0 = time.perf_counter()
        fn()
        cs.log(f"{name}: {time.perf_counter() - t0:.1f} s on the CPU")


def roks_part(mesh):
    cell = diamond_supercell((3, 3, 3), mesh=(mesh,) * 3)
    system = build_scf_system(cell, device=DEV)
    t0 = time.perf_counter()
    res = _pbe0_density(system)
    cs.log(f"RKS PBE0 (isdf c=16) at {mesh}^3: {res['e_tot']:.10f} ({res['niter']} iterations, "
           f"{time.perf_counter() - t0:.1f} s)")
    main = dict(system=system, res=res)
    for name, fn in (("11a", lambda: cs.phase_roks_main(torch, main, {}, dev=DEV)),
                     ("11f", lambda: cs.phase_cdft(torch, main, dev=DEV))):
        t0 = time.perf_counter()
        fn()
        cs.log(f"{name}: {time.perf_counter() - t0:.1f} s on the CPU")


def _pbe0_density(system):
    """Phase 5's PBE0 density stands in for 11f's Mulliken charges: here
    the plain-ISDF c=16 one."""
    from pyscf_isdf_tpu_torch.scf import scf_kernel

    return scf_kernel(system, xc="pbe0", df="isdf", isdf_c=16, conv_tol=1e-8)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("part", choices=("k", "roks"))
    ap.add_argument("--mesh", type=int, help="grid points an axis (k: 16, roks: 36)")
    ap.add_argument("--nk", type=int, default=cs.CERT_NREP[0], help="k-points an axis (k)")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    torch.set_default_dtype(torch.float64)
    if args.part == "k":
        kpart(args.mesh or cs.CERT_MESH[0], args.nk)
    else:
        roks_part(args.mesh or 36)


if __name__ == "__main__":
    main()

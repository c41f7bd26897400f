#!/usr/bin/env python3
"""How far a k-point KRHF/KCCSD of the diamond primitive cell (gth-szv,
12^3) parts from the Gamma RHF/CCSD of the matching supercell, per cell.

    python3 tools/cc_supercell_gap.py [--nk 2,1,1] [--package port|reference]
                                      [--with-t] [--threads N]

Runs on the CPU in float64, either package: ``port`` (default) is
pyscf_isdf_tpu_torch, ``reference`` the JAX package (it imports JAX). The
k side is the closed-shell KRCCSD (cc/krccsd.py), or with ``--with-t`` the
composite KCCSD(T) (cc/kccsd.py); the supercell side Gamma CCSD(T)
(cc/gccsd.ccsd). It prints the SCF, e_corr and E(T) gaps a cell. On this
mesh the two representations of one crystal part by more than the H2-chain
bars of tests/test_kccsd.py:44-46 in both packages alike;
``chip_smoke.py`` phase 15 holds the card's gaps to the reference's.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run_port(nkm, with_t):
    from pyscf_isdf_tpu_torch import lattice
    from pyscf_isdf_tpu_torch.cc.gccsd import ccsd
    from pyscf_isdf_tpu_torch.cc.kccsd import kccsd
    from pyscf_isdf_tpu_torch.cc.krccsd import krccsd
    from pyscf_isdf_tpu_torch.models import diamond_primitive, diamond_supercell
    from pyscf_isdf_tpu_torch.scf import (build_kscf_system, build_scf_system,
                                          kscf_kernel, scf_kernel)

    cell = diamond_primitive(mesh=(12,) * 3)
    ksys = build_kscf_system(cell, lattice.make_kpts(cell.a, nkm), device="cpu")
    kres = kscf_kernel(ksys, xc=None, exxdiv="ewald", conv_tol=1e-11, device="cpu")
    ssys = build_scf_system(diamond_supercell(nrep=tuple(nkm),
                                              mesh=tuple(12 * n for n in nkm)),
                            device="cpu")
    sres = scf_kernel(ssys, xc=None, exxdiv="ewald", conv_tol=1e-11)
    if with_t:
        kout = kccsd(ksys, kres, with_t=True, conv_tol=1e-10, device="cpu")
    else:
        kout = krccsd(ksys, kres, conv_tol=1e-10, device="cpu")
    sout = ccsd(ssys, sres, with_t=with_t, conv_tol=1e-10, device="cpu")
    return kres, sres, kout, sout


def run_reference(nkm, with_t):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_enable_x64", True)
    from pyscf_isdf_tpu import lattice
    from pyscf_isdf_tpu.cc import ccsd
    from pyscf_isdf_tpu.cc.kccsd import kccsd
    from pyscf_isdf_tpu.cc.krccsd import krccsd
    from pyscf_isdf_tpu.models import diamond_primitive, diamond_supercell
    from pyscf_isdf_tpu.scf import build_scf_system, scf_kernel
    from pyscf_isdf_tpu.scf.khf import build_kscf_system, kscf_kernel

    cell = diamond_primitive(mesh=(12,) * 3)
    ksys = build_kscf_system(cell, lattice.make_kpts(cell.a, nkm))
    kres = kscf_kernel(ksys, xc=None, exxdiv="ewald", conv_tol=1e-11)
    ssys = build_scf_system(diamond_supercell(nrep=tuple(nkm),
                                              mesh=tuple(12 * n for n in nkm)))
    sres = scf_kernel(ssys, xc=None, exxdiv="ewald", conv_tol=1e-11)
    if with_t:
        kout = kccsd(ksys, kres, with_t=True, conv_tol=1e-10)
    else:
        kout = krccsd(ksys, kres, conv_tol=1e-10)
    sout = ccsd(ssys, sres, with_t=with_t, conv_tol=1e-10)
    return kres, sres, kout, sout


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nk", default="2,1,1")
    ap.add_argument("--package", choices=("port", "reference"), default="port")
    ap.add_argument("--with-t", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    os.environ["OMP_NUM_THREADS"] = str(args.threads)
    nkm = [int(x) for x in args.nk.split(",")]
    nk = int(np.prod(nkm))
    t0 = time.perf_counter()
    run = run_port if args.package == "port" else run_reference
    kres, sres, kout, sout = run(nkm, args.with_t)
    print(f"{args.package}, k-mesh {nkm}: KRHF {kres['e_tot']:.12f}, supercell RHF "
          f"{sres['e_tot'] / nk:.12f} a cell, gap {kres['e_tot'] - sres['e_tot'] / nk:.6e}")
    print(f"e_corr k {kout['e_corr']:.12f}, supercell {sout['e_corr'] / nk:.12f} a cell, "
          f"gap {kout['e_corr'] - sout['e_corr'] / nk:.6e}")
    if args.with_t:
        print(f"E(T) k {kout['e_t']:.12e}, supercell {sout['e_t'] / nk:.12e} a cell, "
              f"gap {kout['e_t'] - sout['e_t'] / nk:.6e}")
    print(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()

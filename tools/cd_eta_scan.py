"""Contour-deformation Sigma against the Lehmann sum as eta shrinks.

    python3 tools/cd_eta_scan.py [cpu|cuda]

On the diamond primitive cell (gth-szv, 12^3, LDA; the reference test's
``lda12``), evaluates ``gw_cd._sigma_cd_point`` (nw 200) for the HOMO and
LUMO columns at their KS energies and 12 and 30 mHa away from them, at eta
1e-4, 1e-5 and 1e-6, and prints |CD - Lehmann sum (eta 1e-6)|. The CD
kernel's denominator carries eta^2, so away from a level the difference
falls a hundredfold a decade of eta.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pyscf_isdf_tpu_torch.device import to_host  # noqa: E402
from pyscf_isdf_tpu_torch.gw import gw_cd, gw_exact, rgw  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system, scf_kernel  # noqa: E402


def main(dev):
    system = build_scf_system(diamond_primitive(mesh=(12,) * 3), device=dev)
    res = scf_kernel(system, xc="lda,vwn")
    Lmo = rgw.build_lmo(system, res["mo_coeff"])
    mo = to_host(res["mo_energy"])
    nocc = system.nelec // 2
    ef = 0.5 * (mo[nocc - 1] + mo[nocc])
    om, xpy, _, _ = gw_exact.drpa_diagonalize(mo, nocc, Lmo)
    pts = (nocc - 1, nocc)
    tdm = gw_exact._transition_densities(xpy, Lmo, nocc, list(pts))
    f, w = rgw.scaled_legendre(200)
    Wiw = to_host(gw_cd._w_batched_z(Lmo, mo, nocc, -f ** 2 + 0j, cols=pts))
    for col, p in enumerate(pts):
        for d in (0.0, 0.012, 0.03):
            x = mo[p] + d if p >= nocc else mo[p] - d
            ex = gw_exact.exact_sigma(x, mo, nocc, om, tdm, col, eta=1e-6).real
            errs = [abs(gw_cd._sigma_cd_point(Wiw, w, mo, nocc, Lmo, p, x, ef, eta, f,
                                              col=col).real - ex)
                    for eta in (1e-4, 1e-5, 1e-6)]
            print(f"orbital {p}, {d * 1e3:.0f} mHa from its level: |CD - Lehmann| at eta "
                  f"1e-4, 1e-5, 1e-6: " + ", ".join(f"{e:.3e}" for e in errs), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cpu")

"""How far rounding alone moves the k-point ISDF point selection.

    python3 tools/isdf_k_ties.py [--device cpu|cuda]

On the diamond primitive cell at 10^3 with a 2x1x1 k-mesh (the KRHF of
``chip_smoke.py`` 13d), builds ``build_isdf_k(c=10)`` twice: once as it
is, once with the AO columns of the k-stacked periodic parts permuted
before the greedy pivoted Cholesky. The permutation leaves the pair Gram
|U U^H|^2 unchanged in exact arithmetic and changes only the order of its
sums, as two devices do. It prints the first pivot where the two
selections part with the residual diagonals of the two candidates there
(a tie when they agree to rounding), how many points the two sets share,
and the KRHF energies (``df='isdf'``) on each selection.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from pyscf_isdf_tpu_torch import lattice  # noqa: E402
from pyscf_isdf_tpu_torch.df import isdf_k  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_kscf_system, kscf_kernel  # noqa: E402


def residual_diagonals(U, idx):
    """The greedy pivoted Cholesky's residual diagonal before each pivot of
    ``idx``: (n, ng)."""
    d = (U.abs() ** 2).sum(1) ** 2
    L = torch.zeros((len(idx), U.shape[0]), dtype=d.dtype, device=U.device)
    out = []
    for i, p in enumerate(idx):
        out.append(d.clone())
        zrow = (U @ U[p].conj()).abs() ** 2
        L[i] = (zrow - L[:i].T @ L[:i, p]) / torch.sqrt(torch.clamp(d[p], min=1e-300))
        d = torch.clamp(d - L[i] * L[i], min=0.0)
        d[p] = 0.0
    return torch.stack(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    dev = ap.parse_args().device
    cell = diamond_primitive(mesh=(10, 10, 10))
    kpts = lattice.make_kpts(cell.a, [2, 1, 1])
    system = build_kscf_system(cell, kpts, device=dev)
    _, U = isdf_k.periodic_parts(cell, system.aoR_k, kpts)
    n_ip = int(10 * cell.nao * len(kpts))
    perm = torch.as_tensor(np.random.default_rng(0).permutation(U.shape[1]), device=U.device)
    idx = [isdf_k.select_ips(V, n_ip).tolist() for V in (U, U[:, perm])]
    part = next((i for i in range(n_ip) if idx[0][i] != idx[1][i]), None)
    print(f"n_ip {n_ip}: the two selections share {len(set(idx[0]) & set(idx[1]))} points")
    if part is not None:
        d = residual_diagonals(U, idx[0][:part + 1])[part]
        p, q = idx[0][part], idx[1][part]
        print(f"first parting at pivot {part}: residual diagonals {float(d[p]):.17e} "
              f"(taken as it is) and {float(d[q]):.17e} (taken permuted), relative "
              f"gap {abs(float(d[p] - d[q])) / float(d[p]):.3e}")

    select = isdf_k.select_ips
    energies = []
    for permuted in (False, True):
        isdf_k.select_ips = (lambda V, n, *a, **k: select(V[:, perm], n, *a, **k)) \
            if permuted else select
        try:
            res = kscf_kernel(system, xc=None, df="isdf", isdf_c=10, conv_tol=1e-10,
                              device=dev)
        finally:
            isdf_k.select_ips = select
        energies.append(res["e_tot"])
        print(f"KRHF on the {'permuted' if permuted else 'plain'} selection: "
              f"{res['e_tot']:.12f} Ha in {res['niter']} iterations")
    print(f"|difference| {abs(energies[0] - energies[1]):.3e} Ha")


if __name__ == "__main__":
    main()

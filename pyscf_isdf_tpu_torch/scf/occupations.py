"""Occupation numbers across k-points (integer filling).

Smearing is not ported yet: the k-point SCF raises ``NotImplementedError``
for ``sigma > 0``.
"""
from __future__ import annotations

import numpy as np


def exact_count_occ(mo_e_k, n_fill, scale=1.0):
    """Integer occupations filling EXACTLY n_fill orbitals globally.

    Reference semantics: pyscf/pbc/scf/khf.py:178-214 get_occ sorts the
    k-stacked spectrum and occupies the lowest slots; a threshold test
    ``e <= fermi + eps`` overfills when the level at the Fermi energy is
    degenerate, so this fills by a global stable argsort instead.

    Args:
        mo_e_k: per-k (nmo_k,) energy arrays (sizes may differ).
        n_fill: number of orbitals to occupy across all k.
        scale: occupation per filled orbital (2.0 closed-shell).

    Returns a list of per-k numpy occupation arrays.
    """
    es = [np.asarray(e) for e in mo_e_k]
    flat = np.hstack(es)
    occ_flat = np.zeros(flat.size)
    occ_flat[np.argsort(flat, kind="stable")[:n_fill]] = scale
    out, i0 = [], 0
    for e in es:
        out.append(occ_flat[i0:i0 + e.size])
        i0 += e.size
    return out

"""k-point bookkeeping: momentum conservation tables.

Reference: pyscf/pbc/lib/kpts_helper.py:260-283.
"""
from __future__ import annotations

import numpy as np


def get_kconserv(a: np.ndarray, kpts: np.ndarray) -> np.ndarray:
    """kconserv[k,l,m] = n with (k_k - k_l + k_m - k_n) . a = 2 pi Z."""
    kpts = np.reshape(kpts, (-1, 3))
    nk = kpts.shape[0]
    aw = np.asarray(a, dtype=np.float64) / (2 * np.pi)
    kconserv = np.zeros((nk, nk, nk), dtype=int)
    kvKLM = kpts[:, None, None, :] - kpts[:, None, :] + kpts
    for n, kn in enumerate(kpts):
        s = np.einsum("wx,klmx->wklm", aw, kvKLM - kn)
        mask = np.abs(s - np.rint(s)).sum(axis=0) < 1e-9
        kconserv[mask] = n
    return kconserv

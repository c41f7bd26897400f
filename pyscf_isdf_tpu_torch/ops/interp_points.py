"""Interpolation-point (IP) selection for ISDF (torch).

Greedy pivoted Cholesky on the Hadamard-squared AO Gram matrix
Z[g,g'] = (sum_mu ao_mu(g) ao_mu(g'))^2, run matrix-free (only the
diagonal and one row per step are formed). This is algebraically
equivalent to column-pivoted QR on the pair matrix (the QRCP step of the
ISDF papers, arXiv:1711.01531). Each step stays on the device: the pivot
is a 0-dim tensor, so the loop never waits on the host.

The CVT and atomic selections of the reference are not ported yet.
Both functions return grid indices (n_ip,) and the final residual
diagonal.
"""
from __future__ import annotations

import torch


def pivoted_cholesky_points(aoR, n_ip: int):
    """Greedy pivoted Cholesky of Z = (aoR aoR^T)^{o2}, matrix-free.

    Args:
        aoR: (ngrids, nao) AO values (real, Gamma point).
        n_ip: number of interpolation points to select.

    Returns:
        (ip_idx (n_ip,) int64 grid indices, resid_diag (ngrids,)).
    """
    ng = aoR.shape[0]
    d = (aoR * aoR).sum(1) ** 2                   # Z diagonal
    L = torch.zeros((n_ip, ng), dtype=aoR.dtype, device=aoR.device)
    idx = torch.zeros(n_ip, dtype=torch.int64, device=aoR.device)
    for i in range(n_ip):
        p = torch.argmax(d)
        zrow = (aoR @ aoR[p]) ** 2                # row p of Z
        lrow = (zrow - L[:i].T @ L[:i, p]) / torch.sqrt(torch.clamp(d[p], min=1e-300))
        L[i] = lrow
        d = torch.clamp(d - lrow * lrow, min=0.0)
        d[p] = 0.0                                # never re-pick
        idx[i] = p
    return idx, d


def pivoted_cholesky_points_blocked(aoR, n_ip: int, blk: int = 32):
    """Block-greedy pivoted Cholesky: ``blk`` pivots per outer step.

    Each outer step takes the ``4 blk`` largest residual-diagonal entries
    as candidates, forms their Z-rows against the current residual, runs
    ``blk`` greedy steps inside the candidate panel and applies the rank-blk
    update. Selection differs slightly from strict greedy but has the same
    rank-revealing quality.
    """
    ng = aoR.shape[0]
    d = (aoR * aoR).sum(1) ** 2
    n_steps = -(-n_ip // blk)
    ncand = min(ng, 4 * blk)
    L = torch.zeros((n_steps * blk, ng), dtype=aoR.dtype, device=aoR.device)
    idx = torch.zeros(n_steps * blk, dtype=torch.int64, device=aoR.device)
    zero = torch.zeros((), dtype=aoR.dtype, device=aoR.device)
    for step in range(n_steps):
        cand = torch.topk(d, ncand).indices
        Lp = L[:step * blk]
        rr = (aoR[cand] @ aoR.T) ** 2 - Lp[:, cand].T @ Lp   # (ncand, ng)
        for j in range(blk):
            jloc = torch.argmax(d[cand])
            p = cand[jloc]
            dp = d[p]
            lrow = rr[jloc] / torch.sqrt(torch.clamp(dp, min=1e-300))
            lrow = torch.where(dp > 1e-30, lrow, zero)
            rr = rr - lrow[cand][:, None] * lrow[None, :]
            d = torch.clamp(d - lrow * lrow, min=0.0)
            d[p] = 0.0
            L[step * blk + j] = lrow
            idx[step * blk + j] = p
    return idx[:n_ip], d

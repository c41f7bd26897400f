"""Interpolation-point (IP) selection for ISDF (torch).

Three selections, each returning grid indices (n_ip,):

  * :func:`pivoted_cholesky_points` (and its blocked form): greedy
    pivoted Cholesky on the Hadamard-squared AO Gram matrix
    Z[g,g'] = (sum_mu ao_mu(g) ao_mu(g'))^2, run matrix-free (only the
    diagonal and one row per step are formed). This is algebraically
    equivalent to column-pivoted QR on the pair matrix (the QRCP step of
    the ISDF papers, arXiv:1711.01531). Each step stays on the device: the
    pivot is a 0-dim tensor, so the loop never waits on the host. Both
    also return the final residual diagonal.
  * :func:`atomic_points`: the greedy selection inside each atom's
    Voronoi cell.
  * :func:`cvt_points`: centroidal Voronoi tessellation, a
    density-weighted K-means (the CVT variant of Dong-Hu-Lin) by Lloyd
    iterations over the grid.
"""
from __future__ import annotations

import torch

# grid rows per CVT distance block: the largest temporary is
# (CHUNK_ROWS, n_ip), never (ngrids, n_ip) (9.2 GB at diamond 3x3x3 c=16)
CHUNK_ROWS = 4096


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


def atomic_points(aoR, coords, atom_coords, n_ip_per_atom: int):
    """Atom-partitioned ('robust fit') interpolation points.

    Grid points are assigned to their nearest atom by the plain Euclidean
    distance to the atom positions as given, with no periodic image (the
    reference's assignment, kept for parity); a greedy pivoted Cholesky
    then runs inside each atom's cell with its own budget of
    min(n_ip_per_atom, points in the cell).

    Returns (sum over atoms of the budgets,) int64 grid indices on the
    device of ``aoR``.
    """
    dev = aoR.device
    coords = torch.as_tensor(coords, dtype=torch.float64, device=dev)
    atoms = torch.as_tensor(atom_coords, dtype=torch.float64, device=dev)
    owner = ((coords[:, None, :] - atoms[None, :, :]) ** 2).sum(-1).argmin(1)
    idx_all = []
    for ia in range(atoms.shape[0]):
        sel = torch.nonzero(owner == ia).squeeze(1)
        k = min(n_ip_per_atom, sel.numel())
        idx_all.append(sel[pivoted_cholesky_points(aoR[sel], k)[0]])
    return torch.cat(idx_all)


def _sq_dist(coords, centers):
    """(len(coords), len(centers)) squared distances in the difference
    form sum_x (r_x - c_x)^2, which keeps the digits the expansion
    |r|^2 - 2 r.c + |c|^2 loses."""
    return ((coords[:, None, 0] - centers[None, :, 0]) ** 2
            + (coords[:, None, 1] - centers[None, :, 1]) ** 2
            + (coords[:, None, 2] - centers[None, :, 2]) ** 2)


def cvt_centroids(coords, rho, n_ip: int, n_iter: int = 30, seed: int = 0,
                  init_idx=None):
    """The Lloyd iterations of :func:`cvt_points`: (n_ip, 3) centroids.

    Each step moves a centroid to the rho-weighted mean of the grid points
    nearest to it (the first of equal distances, as the reference's
    argmin), and keeps a centroid that no point is nearest to. Distances
    are taken in blocks of CHUNK_ROWS grid rows. Arguments as
    :func:`cvt_points`.
    """
    coords = torch.as_tensor(coords, dtype=torch.float64)
    dev = coords.device
    rho = torch.as_tensor(rho, dtype=torch.float64, device=dev)
    if init_idx is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        init_idx = torch.multinomial(rho / rho.sum(), n_ip, replacement=False,
                                     generator=gen)
    centers = coords[torch.as_tensor(init_idx, dtype=torch.int64, device=dev)]
    wr = coords * rho[:, None]
    for _ in range(n_iter):
        wsum = torch.zeros(n_ip, dtype=torch.float64, device=dev)
        wcoords = torch.zeros((n_ip, 3), dtype=torch.float64, device=dev)
        for g0 in range(0, coords.shape[0], CHUNK_ROWS):
            rows = slice(g0, g0 + CHUNK_ROWS)
            assign = _sq_dist(coords[rows], centers).argmin(1)
            wsum.index_add_(0, assign, rho[rows])
            wcoords.index_add_(0, assign, wr[rows])
        centers = torch.where(wsum[:, None] > 0, wcoords / wsum[:, None], centers)
    return centers


def nearest_points(coords, centers):
    """(len(centers),) int64 index of the grid point nearest to each
    centre, the first of equal distances (blocks of CHUNK_ROWS rows)."""
    n = centers.shape[0]
    best = torch.full((n,), float("inf"), dtype=torch.float64, device=centers.device)
    idx = torch.zeros(n, dtype=torch.int64, device=centers.device)
    for g0 in range(0, coords.shape[0], CHUNK_ROWS):
        d, i = _sq_dist(coords[g0:g0 + CHUNK_ROWS], centers).min(0)
        better = d < best                 # strict: an earlier block wins a tie
        best = torch.where(better, d, best)
        idx = torch.where(better, i + g0, idx)
    return idx


def cvt_points(coords, rho, n_ip: int, n_iter: int = 30, seed: int = 0,
               init_idx=None):
    """Density-weighted K-means (CVT) interpolation points.

    Args:
        coords: (ngrids, 3) grid coordinates (sets the device).
        rho: (ngrids,) nonnegative weights (the electron density).
        n_ip: number of centroids.
        n_iter: Lloyd iterations.
        seed: seeds the initial draw when ``init_idx`` is None.
        init_idx: (n_ip,) grid indices of the initial centroids. Without
            it, n_ip indices are drawn with probability rho / sum(rho),
            without replacement, by ``torch.multinomial`` from a
            ``torch.Generator`` on the device of ``coords`` seeded with
            ``seed``. That draw differs from the reference's
            ``jax.random.choice``, which torch cannot reproduce: hand the
            reference's draw in as ``init_idx`` to reproduce its points.

    Returns (n_ip,) int64 indices of the grid points nearest to the
    centroids of :func:`cvt_centroids`.
    """
    coords = torch.as_tensor(coords, dtype=torch.float64)
    return nearest_points(coords, cvt_centroids(coords, rho, n_ip, n_iter, seed,
                                                init_idx))

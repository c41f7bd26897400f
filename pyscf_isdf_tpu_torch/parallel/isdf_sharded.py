"""Multi-rank ISDF build: the grid axis split into x-slabs over the ranks.

aoR is row-split into x-slabs, the interpolation-point search runs as an
SPMD greedy pivoted Cholesky (one all_gather of one candidate row per rank
a pivot, or of a panel of candidates per ``blk`` pivots), the
interpolation-vector FFTs go through the distributed 3-D FFT (all_to_all
transposes), and W is summed by one all_reduce. Every rank returns the same
replicated :class:`~pyscf_isdf_tpu_torch.df.isdf.ISDF`.

Ties: a tie across ranks goes to the lowest rank (the first maximum of the
gathered candidates), a tie within a rank to the first index. The pivots
stay on the device: no pivot is read on the host.
"""
from __future__ import annotations

import torch

from pyscf_isdf_tpu_torch.df.isdf import ISDF, _solve_xi
from pyscf_isdf_tpu_torch.parallel import distributed_fft as dfft
from pyscf_isdf_tpu_torch.parallel.mesh import slab_rows
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def _select_ips_local(A_l, n_ip: int, group):
    """SPMD greedy pivoted Cholesky on the split pair Gram
    Z[g, g'] = |A[g] . conj(A[g'])|^2 (real ``A_l``: the Hadamard-squared
    AO Gram; complex: the k-stacked pair Gram of ``isdf_k_sharded``).

    A pivot gathers the winning candidate of every rank (residual diagonal,
    A row as real numbers, L column). Returns (Ag replicated (n_ip, n),
    owner (n_ip,) rank, local_idx (n_ip,) local grid index on the owner, -1
    on the other ranks).
    """
    ngl, n = A_l.shape
    dev = A_l.device
    cplx = A_l.is_complex()
    me = group.rank
    d = (A_l.abs() ** 2).sum(1) ** 2
    L = torch.zeros((n_ip, ngl), dtype=d.dtype, device=dev)
    Ag = torch.zeros((n_ip, n), dtype=A_l.dtype, device=dev)
    owners = torch.zeros(n_ip, dtype=torch.int64, device=dev)
    locs = torch.zeros(n_ip, dtype=torch.int64, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=d.dtype, device=dev)
    nrow = 2 * n if cplx else n
    for i in range(n_ip):
        pl = torch.argmax(d)
        row = A_l[pl]
        row = torch.cat([row.real, row.imag]) if cplx else row
        allc = group.all_gather(torch.cat([d[pl][None], row, L[:, pl]]))
        j = torch.argmax(allc[:, 0])                # ties: the lowest rank
        dmax = allc[j, 0]
        row = allc[j, 1:1 + nrow]
        row = torch.complex(row[:n], row[n:]) if cplx else row
        Lp = allc[j, 1 + nrow:]
        zrow = (A_l @ row.conj()).abs() ** 2
        lrow = (zrow - L[:i].T @ Lp[:i]) / torch.sqrt(torch.clamp(dmax, min=1e-300))
        L[i] = lrow
        d = torch.clamp(d - lrow * lrow, min=0.0)
        mine = j == me
        d[pl] = torch.where(mine, zero, d[pl])
        Ag[i] = row
        owners[i] = j
        locs[i] = torch.where(mine, pl, minus1)
    return Ag, owners, locs


def _select_ips_local_blocked(aoR_l, n_ip: int, n_dev: int, blk: int, group):
    """SPMD block-greedy pivoted Cholesky: ``blk`` pivots per all_gather.

    Each panel step gathers every rank's top-``blk`` residual-diagonal
    candidates (AO row and current L column each); then every rank runs the
    same in-panel scan: the argmax over the replicated candidate diagonal,
    the local L row from the split residual rows. One collective per
    ``blk`` picks instead of one per pick.
    """
    ngl, nao = aoR_l.shape
    dev, dt = aoR_l.device, aoR_l.dtype
    me = group.rank
    d = (aoR_l * aoR_l).sum(1) ** 2
    n_steps = -(-n_ip // blk)
    n_tot = n_steps * blk
    ncl = min(blk, ngl)                                  # candidates a rank
    C = n_dev * ncl
    L = torch.zeros((n_tot, ngl), dtype=dt, device=dev)
    aoRg = torch.zeros((n_tot, nao), dtype=dt, device=dev)
    owners = torch.zeros(n_tot, dtype=torch.int64, device=dev)
    locs = torch.zeros(n_tot, dtype=torch.int64, device=dev)
    own_c = torch.arange(n_dev, device=dev).repeat_interleave(ncl)
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for step in range(n_steps):
        vals, idxl = torch.topk(d, ncl)
        pack = torch.cat([vals[:, None], idxl[:, None].to(dt), aoR_l[idxl],
                          L[:, idxl].T], dim=1)
        allp = group.all_gather(pack).reshape(C, -1)
        d_c = allp[:, 0]
        gidx = allp[:, 1].to(torch.int64)                # local index @ owner
        ao_c = allp[:, 2:2 + nao]
        L_c = allp[:, 2 + nao:]                          # (C, n_tot)
        Ls = L[:step * blk]
        rr = (ao_c @ aoR_l.T) ** 2 - L_c[:, :step * blk] @ Ls       # (C, ngl)
        Lcs = L_c[:, :step * blk]
        rc_m = (ao_c @ ao_c.T) ** 2 - Lcs @ Lcs.T                    # (C, C)
        dc = d_c
        for jj in range(blk):
            j = torch.argmax(dc)
            dj = dc[j]
            inv = torch.where(dj > 1e-30,
                              1.0 / torch.sqrt(torch.clamp(dj, min=1e-300)), zero)
            lrow = rr[j] * inv                           # (ngl,) local
            rc = rc_m[j] * inv                           # (C,) replicated
            rr = rr - rc[:, None] * lrow[None, :]
            rc_m = rc_m - rc[:, None] * rc[None, :]
            d = torch.clamp(d - lrow * lrow, min=0.0)
            dc = torch.clamp(dc - rc * rc, min=0.0)
            dc[j] = 0.0
            mine = own_c[j] == me
            loc_j = gidx[j]
            d[loc_j] = torch.where(mine, zero, d[loc_j])
            row = step * blk + jj
            L[row] = lrow
            aoRg[row] = ao_c[j]
            owners[row] = own_c[j]
            locs[row] = torch.where(mine, loc_j, minus1)
    return aoRg[:n_ip], owners[:n_ip], locs[:n_ip]


def _xi_and_w_local(aoR_l, aoRg, coulG_t_l, mesh3, weight, fft_chunk: int,
                    group):
    """Interpolation vectors (this rank's columns) and the summed W matrix.

    The columns solve against the replicated IP Gram exactly as the unsplit
    build does (:func:`~pyscf_isdf_tpu_torch.df.isdf._solve_xi`, the same
    shift and arithmetic), so the split and unsplit factorizations from one
    point set differ only by the FFT's and W's summation order. The W
    columns are built ``fft_chunk`` interpolation vectors at a time (no
    grid-sized V xi tensor is kept)."""
    nip = aoRg.shape[0]
    xi_l = _solve_xi(aoR_l, aoRg)                          # (nip, ngl)
    W = torch.empty((nip, nip), dtype=aoR_l.dtype, device=aoR_l.device)
    for i0 in range(0, nip, fft_chunk):
        v = dfft.poisson_slab(xi_l[i0:i0 + fft_chunk], coulG_t_l, mesh3, group)
        W[:, i0:i0 + fft_chunk] = xi_l @ v.T
    W = group.all_reduce(weight * W)
    return xi_l, 0.5 * (W + W.T)


def build_isdf_sharded(dev_mesh, aoR, coulG, mesh3, weight, n_ip: int,
                       fft_chunk: int = 64, method: str = "auto",
                       blk: int = 64, timer=None) -> ISDF:
    """Multi-rank ISDF build; returns the replicated :class:`ISDF`.

    Args:
        dev_mesh: this rank's :class:`~pyscf_isdf_tpu_torch.parallel.mesh.RankGroup`.
        aoR: (ngrids / P, nao) this rank's x-slab of the AO values
            (:func:`~pyscf_isdf_tpu_torch.parallel.mesh.slab_rows`).
        coulG: (ngrids,) the plain Coulomb kernel in standard FFT layout
            (replicated).
        method: 'greedy' (one all_gather a pivot), 'blocked' (panel
            pivoting, one all_gather per ``blk`` pivots), or 'auto'
            (blocked once n_ip >= 512).
        timer: optional stage timer; records 'select' and 'xi_w'.
    Returns an ISDF whose ``ip_idx`` are global grid indices.
    """
    grp = dev_mesh
    timer = timer or null_timer
    mesh3 = tuple(mesh3)
    coulG_t = dfft.coulG_transposed_layout(
        torch.as_tensor(coulG, dtype=aoR.dtype, device=aoR.device), mesh3)
    coulG_t_l = coulG_t[slab_rows(mesh3, grp.rank, grp.world)]
    if method == "auto":
        method = "blocked" if n_ip >= 512 else "greedy"
    if method not in ("blocked", "greedy"):
        raise ValueError(f"unknown selection method {method!r}")
    with timer("select"):
        if method == "blocked":
            aoRg, owners, locs = _select_ips_local_blocked(aoR, n_ip, grp.world,
                                                           blk, grp)
        else:
            aoRg, owners, locs = _select_ips_local(aoR, n_ip, grp)
    with timer("xi_w"):
        _, W = _xi_and_w_local(aoR, aoRg, coulG_t_l, mesh3, weight, fft_chunk,
                               grp)
    # global grid index of each IP: the owner's slab offset + local index
    ngl = aoR.shape[0]
    glob = grp.all_reduce(torch.where(locs >= 0, owners * ngl + locs,
                                      torch.zeros_like(locs)))
    return ISDF(aoRg=aoRg, W=W, ip_idx=glob)

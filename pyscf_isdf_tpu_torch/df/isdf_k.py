"""k-point sampled ISDF: shared interpolation points, per-q Coulomb kernels.

Bloch pair densities factorize through the *periodic* parts
u_{k,mu}(r) = e^{-ik.r} phi^k_mu(r):

    conj(u_{k1,mu}) u_{k2,nu} (r) ~= sum_P xi_P(r) conj(u_{k1,mu}(r_P)) u_{k2,nu}(r_P)

with one REAL interpolation-vector set xi shared by every (k1,k2) pair
(fit over the k-stacked orbital space; Hu-Lin-Yang ISDF-K,
arXiv:1707.09141). Per momentum transfer q = k2 - k1:

    W_q[P,Q] = w * sum_g xi_P(g) ifft(coulG(q) fft(xi_Q))(g)   (Hermitian)

built once per geometry (nq * n_IP FFTs). The per-iteration exchange is

    M = Ug[k2] D_{k2} Ug[k2]^H ;  K_{k1} += (1/nk) Ug[k1]^H (conj(W_q) o M) Ug[k1]

— nk^2 n_IP-sized GEMMs, replacing the nao * nk^2 grid-sized FFTs of the
FFTDF K build (pyscf/pbc/df/fft_jk.py:250-292). Everything runs in torch
on the device of the AO values, float64 / complex128.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.ops import coulomb


@dataclass(frozen=True)
class ISDFK:
    """k-point ISDF factorization (tensors on one device)."""

    Ug: torch.Tensor        # (nk, n_ip, nao) periodic-part values at IPs
    Wq: torch.Tensor        # (nq, n_ip, n_ip) complex per-q kernels
    qmap: np.ndarray        # (nk, nk) -> q index for (k2, k1)
    ip_idx: torch.Tensor    # (n_ip,)
    xi: torch.Tensor | None = None   # (n_ip, ng) interpolation vectors

    @property
    def n_ip(self) -> int:
        return self.Ug.shape[1]


def _select_ips_complex(U, n_ip: int):
    """Greedy pivoted Cholesky on Z[g,g'] = |sum_a U[g,a] conj(U[g',a])|^2,
    matrix-free (the diagonal and one row per step); ties in the pivot
    break on the first index. Returns (n_ip,) int64 grid indices."""
    ng = U.shape[0]
    d = (U.abs() ** 2).sum(1) ** 2
    L = torch.zeros((n_ip, ng), dtype=d.dtype, device=U.device)
    idx = torch.zeros(n_ip, dtype=torch.int64, device=U.device)
    for i in range(n_ip):
        p = torch.argmax(d)
        zrow = (U @ U[p].conj()).abs() ** 2
        lrow = (zrow - L[:i].T @ L[:i, p]) / torch.sqrt(torch.clamp(d[p], min=1e-300))
        L[i] = lrow
        d = torch.clamp(d - lrow * lrow, min=0.0)
        d[p] = 0.0
        idx[i] = p
    return idx


def _select_ips_complex_blocked(U, n_ip: int, blk: int = 64):
    """Block-greedy pivoted Cholesky on the k-stacked pair Gram: ``blk``
    pivots per outer step from the ``4 blk`` largest residual-diagonal
    candidates, so the sequential depth is n_ip/blk and each step does
    dense (ncand x ng) complex products."""
    ng = U.shape[0]
    d = (U.abs() ** 2).sum(1) ** 2
    n_steps = -(-n_ip // blk)
    ncand = min(ng, 4 * blk)
    L = torch.zeros((n_steps * blk, ng), dtype=d.dtype, device=U.device)
    idx = torch.zeros(n_steps * blk, dtype=torch.int64, device=U.device)
    zero = torch.zeros((), dtype=d.dtype, device=U.device)
    for step in range(n_steps):
        cand = torch.topk(d, ncand).indices
        Lp = L[:step * blk]
        rr = (U[cand] @ U.conj().T).abs() ** 2 - Lp[:, cand].T @ Lp
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
    return idx[:n_ip]


def select_ips(U, n_ip: int, method: str = "auto", blk: int = 64):
    """IP selection on the k-stacked periodic parts ``U`` (ng, nk*nao):
    'cholesky' (greedy), 'cholesky-blocked', or 'auto' (blocked once
    n_ip >= 512, where the greedy loop is bound by launch latency)."""
    if method == "auto":
        method = "cholesky-blocked" if n_ip >= 512 else "cholesky"
    if method == "cholesky":
        return _select_ips_complex(U, n_ip)
    if method == "cholesky-blocked":
        return _select_ips_complex_blocked(U, n_ip, blk=blk)
    raise ValueError(f"unknown IP selection method {method!r}")


def periodic_parts(cell, aoR_k, kpts):
    """u_k = e^{-ik.r} phi^k: (nk, ng, nao) and its k-stacked (ng, nk*nao)."""
    nk, ng, nao = aoR_k.shape
    coords = torch.as_tensor(cell.uniform_grid(), dtype=torch.float64,
                             device=aoR_k.device)
    kt = torch.as_tensor(np.reshape(kpts, (-1, 3)), dtype=torch.float64,
                         device=aoR_k.device)
    U3 = aoR_k * torch.exp(-1j * (coords @ kt.T)).T[:, :, None]
    return U3, U3.transpose(0, 1).reshape(ng, nk * nao)


def unique_q(cell, kpts):
    """Map (k2, k1) pairs to unique momentum transfers q = k2 - k1.

    One np.unique over the nk^2 differences, binned to 1e-8 (MP-mesh
    differences are exact multiples of b/n). Returns (q_list (nq, 3),
    qmap (nk, nk) int) with q_list in first-appearance (row-major pair
    scan) order.
    """
    kpts = np.reshape(kpts, (-1, 3))
    nk = len(kpts)
    diffs = (kpts[:, None, :] - kpts[None, :, :]).reshape(-1, 3)
    _, first, inv = np.unique(np.round(diffs, 8), axis=0,
                              return_index=True, return_inverse=True)
    order = np.argsort(first)              # sorted-unique -> first-appearance
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    qmap = rank[inv.ravel()].reshape(nk, nk).astype(np.int64)
    return diffs[np.sort(first)], qmap


def _xi_wq(U, ip_idx, coulG_q, mesh, weight, fft_chunk: int = 64,
           solve_chunk: int = 4096):
    """Interpolation vectors and the per-q W kernels.

    xi solves (C1 + eps I) xi = C2^T with C1 = |Ug Ug^H|^2 and C2 =
    |U Ug^H|^2, the shift 1e-12 * mean diagonal (float64), Cholesky on the
    (nip, nip) Gram and the right-hand sides in ``solve_chunk`` grid
    columns. Returns (Wq, xi).
    """
    ng = U.shape[0]
    Ug = U[ip_idx]                                          # (nip, nk*nao)
    nip = Ug.shape[0]
    R1 = Ug @ Ug.conj().T
    C1 = (R1 * R1.conj()).real                              # (nip, nip)
    eps = 1e-12 * torch.trace(C1) / nip
    cho = torch.linalg.cholesky(
        C1 + eps * torch.eye(nip, dtype=C1.dtype, device=C1.device))
    xi = torch.empty((nip, ng), dtype=C1.dtype, device=C1.device)
    for g0 in range(0, ng, solve_chunk):
        R2 = U[g0:g0 + solve_chunk] @ Ug.conj().T             # (sc, nip)
        C2 = (R2 * R2.conj()).real
        xi[:, g0:g0 + solve_chunk] = torch.cholesky_solve(C2.T, cho)
    return _wq_from_xi(xi.to(U.dtype), coulG_q, mesh, weight, fft_chunk), xi


def _wq_from_xi(xi_c, coulG_q, mesh, weight, fft_chunk: int = 64):
    """Per-q W kernels from (complex-cast) interpolation vectors, built
    column block by column block (no grid-sized V xi tensor)."""
    nip = xi_c.shape[0]
    Wq = torch.empty((coulG_q.shape[0], nip, nip), dtype=xi_c.dtype,
                     device=xi_c.device)
    for iq, coulG in enumerate(coulG_q):
        for i0 in range(0, nip, fft_chunk):
            v = ifft3(coulG * fft3(xi_c[i0:i0 + fft_chunk], mesh), mesh)
            Wq[iq, :, i0:i0 + fft_chunk] = xi_c @ v.T
    Wq = weight * Wq
    return 0.5 * (Wq + Wq.conj().transpose(1, 2))


def build_isdf_k(cell, aoR_k, kpts, n_ip=None, c: float = 8.0,
                 keep_xi: bool = False, exxdiv=None, omega: float = 0.0,
                 method: str = "auto", blk: int = 64,
                 precision: str | None = None) -> ISDFK:
    """Build the k-point ISDF factorization on the device of ``aoR_k``.

    Args:
        aoR_k: (nk, ng, nao) complex Bloch AO values.
        kpts: (nk, 3).
        n_ip: interpolation points (default c * nao * nk: the k-stacked
            pair space folds like the supercell).
        keep_xi: retain the interpolation vectors (n_ip x ngrids), needed
            by :func:`w_phased`.
        exxdiv: None; 'ewald' is the SCF loop's madelung shift (pass None
            for it). The 'vcut_*' kernels, ``precision='dd'`` and the CVT
            selection are not ported and raise ``NotImplementedError``.
        omega: range separation of the per-q kernels (> 0 long-range erf,
            < 0 short-range erfc), for range-separated exchange.
        method: 'cholesky', 'cholesky-blocked' or 'auto'.
    """
    if precision is not None:
        raise NotImplementedError(f"build precision {precision!r}: the port "
                                  "solves in float64")
    kpts = np.reshape(np.asarray(kpts), (-1, 3))
    nk, ng, nao = aoR_k.shape
    if n_ip is None:
        n_ip = int(c * nao * nk)
    n_ip = min(n_ip, ng)
    U3, U = periodic_parts(cell, aoR_k, kpts)
    ip_idx = select_ips(U, n_ip, method, blk)
    q_list, qmap = unique_q(cell, kpts)
    coulG_q = torch.as_tensor(np.stack([
        coulomb.get_coulG(cell, k=q, exxdiv=exxdiv, kpts=kpts, omega=omega or None)
        for q in q_list
    ]), dtype=torch.float64, device=aoR_k.device)
    Wq, xi = _xi_wq(U, ip_idx, coulG_q, tuple(cell.mesh), cell.grid_weight)
    return ISDFK(Ug=U3[:, ip_idx, :], Wq=Wq, qmap=qmap, ip_idx=ip_idx,
                 xi=(xi if keep_xi else None))


def w_phased(isdfk: ISDFK, cell, q, Gshift, kpts=None, fft_chunk: int = 64):
    """Kernel variant with an e^{iG.r} phase on the second pair:

        W~[P,Q] = w sum_g ifft(coulG(q) fft(xi_P))(g) e^{iG.r_g} xi_Q(g)

    needed when a pair's momentum transfer matches -q only modulo the
    reciprocal-lattice vector ``Gshift``. Requires the factorization to have
    been built with ``keep_xi=True``.
    """
    if isdfk.xi is None:
        raise ValueError("w_phased needs build_isdf_k(..., keep_xi=True)")
    dev = isdfk.Ug.device
    xi_c = isdfk.xi.to(isdfk.Ug.dtype)
    mesh3 = tuple(cell.mesh)
    coulG_q = torch.as_tensor(coulomb.get_coulG(cell, k=np.asarray(q), kpts=kpts),
                              dtype=torch.float64, device=dev)
    coords = torch.as_tensor(cell.uniform_grid(), dtype=torch.float64, device=dev)
    phase = torch.exp(1j * (coords @ torch.as_tensor(Gshift, dtype=torch.float64,
                                                     device=dev)))
    Vxi = torch.cat([ifft3(coulG_q * fft3(xi_c[i0:i0 + fft_chunk], mesh3), mesh3)
                     for i0 in range(0, xi_c.shape[0], fft_chunk)])
    return cell.grid_weight * (Vxi @ (xi_c * phase[None, :]).T)


def get_k_kpts(isdfk: ISDFK, dm_k, k1_idx=None):
    """Exchange via per-q GEMMs: (1/nk) sum_k2 Ug1^H (conj(W_q) o M2) Ug1.

    The sum over k2 accumulates conj(M2) o W_q one pair at a time (the q
    index read on the host, so no index tensor reaches the device and the
    loop can be captured into a CUDA graph) and conjugates once: no
    (nk, n_ip, n_ip) gather of W per band k-point.

    ``k1_idx``: optional band k-points (the sum still runs over every
    density k2), the IBZ driver's subset. Output order follows k1_idx.
    """
    Ug = isdfk.Ug
    nk = Ug.shape[0]
    dm_k = dm_k.to(Ug.dtype)
    Mc = Ug.conj() @ dm_k.conj() @ Ug.transpose(1, 2)        # conj(M), (nk, nip, nip)
    out = []
    for k1 in (range(nk) if k1_idx is None else k1_idx):
        inner = Mc[0] * isdfk.Wq[int(isdfk.qmap[0, k1])]
        for k2 in range(1, nk):
            inner.addcmul_(Mc[k2], isdfk.Wq[int(isdfk.qmap[k2, k1])])
        out.append(Ug[k1].conj().T @ inner.conj() @ Ug[k1] / nk)
    return torch.stack(out)

"""ISDF: interpolative separable density fitting J/K engine (torch).

Factorizes AO pair densities

    phi_mu(r) phi_nu(r) ~= sum_P xi_P(r) phi_mu(r_P) phi_nu(r_P)

over n_IP = c * nao interpolation points, turning the per-SCF-iteration
exchange build from O(nao * ngrids) FFTs (pyscf/pbc/df/fft_jk.py:276-291 in
the reference) into n_IP-sized GEMMs:

    M = aoRg D aoRg^T;   K = aoRg^T (W o M) aoRg

with the Coulomb-kernel matrix W built once per geometry from batched FFTs
of the interpolation vectors (Lu-Ying ISDF; Hu-Lin-Yang arXiv:1707.09141).

Build steps:
  1. IP selection: pivoted Cholesky on (aoR aoR^T)^{o2}, per atom or
     not, or density-weighted K-means (ops/interp_points.py).
  2. Interpolation vectors: xi = C2 C1^{-1} with C1 = (aoRg aoRg^T)^{o2},
     C2 = (aoR aoRg^T)^{o2}  (Cholesky solve of the n_IP x n_IP Gram).
  3. W_PQ = w * sum_g xi_P(g) ifft(coulG * fft(xi_Q))(g), w = vol/ngrids,
     and optionally Vxi = ifft(coulG * fft(xi)) for the robust-fit K.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pyscf_isdf_tpu_torch.df.fftdf import _complex, fft3, ifft3
from pyscf_isdf_tpu_torch.ops.cuda_robust_k import robust_k_cross
from pyscf_isdf_tpu_torch.ops.interp_points import (
    atomic_points, cvt_points, pivoted_cholesky_points,
    pivoted_cholesky_points_blocked,
)
from pyscf_isdf_tpu_torch.utils.timing import null_timer


@dataclass(frozen=True)
class ISDF:
    """Built ISDF factorization (tensors on one device)."""

    aoRg: torch.Tensor      # (n_ip, nao) AO values at interpolation points
    W: torch.Tensor         # (n_ip, n_ip) Coulomb kernel between xi vectors
    ip_idx: torch.Tensor    # (n_ip,) grid indices
    Vxi: torch.Tensor | None = None   # (n_ip, ng) Coulomb-transformed xi
    # (kept when built with keep_v=True; enables the robust-fit K whose
    # error is quadratic in the fit residual)

    @property
    def n_ip(self) -> int:
        return self.aoRg.shape[0]


def _solve_xi(aoR, aoRg):
    """Interpolation vectors xi (nip, ng) solving xi C1 = C2^T.

    Regularized Cholesky solve (C1 is PSD, near-singular for large c), with
    the dtype-aware shift of the reference: 1e-12 * mean diagonal in
    float64, 3e-7 * trace in float32. The solve is two GEMMs with the
    explicit inverse of the small (nip, nip) factor, so the peak memory
    stays O(nip ng): C2, the half-solved vectors and xi.
    """
    nip = aoRg.shape[0]
    C1 = (aoRg @ aoRg.T) ** 2                                # (nip, nip)
    is_f64 = aoR.dtype == torch.float64
    eps = 1e-12 * torch.trace(C1) / nip if is_f64 else 3e-7 * torch.trace(C1)
    eye = torch.eye(nip, dtype=aoR.dtype, device=aoR.device)
    L = torch.linalg.cholesky(C1 + eps * eye)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Y = Linv @ ((aoR @ aoRg.T) ** 2).T                       # L^{-1} C2^T
    return Linv.T @ Y                                        # (nip, ng)


def _build_from_idx(aoR, ip_idx, coulG, mesh, weight, fft_chunk: int = 128,
                    keep_v: bool = False, timer=None):
    """Steps 2+3 of the ISDF build for a given IP set.

    ``coulG`` is one kernel (ng,) or a stack (nw, ng): the interpolation
    vectors are solved once and one W is built per kernel (the
    range-separated path builds the full-range and long-range W from one
    fit). Each ``fft_chunk`` rows of xi are FFT'd once and contracted into
    W columns for every kernel; ``keep_v`` also keeps
    V xi = ifft(coulG fft(xi)) per kernel (needed by the robust-fit K).
    Returns (aoRg, W, Vxi or None), W and Vxi with a leading kernel axis
    when ``coulG`` is a stack.
    """
    timer = timer or null_timer
    aoRg = aoR[ip_idx]                                    # (nip, nao)
    with timer("isdf_xi"):
        xi = _solve_xi(aoR, aoRg)                         # (nip, ng)
    with timer("isdf_w_vxi"):
        squeeze = coulG.dim() == 1
        coulGs = coulG[None] if squeeze else coulG         # (nw, ng)
        nw = coulGs.shape[0]
        nip, ng = xi.shape
        W = torch.empty((nw, nip, nip), dtype=aoR.dtype, device=aoR.device)
        Vxi = (torch.empty((nw, nip, ng), dtype=aoR.dtype, device=aoR.device)
               if keep_v else None)
        for i0 in range(0, nip, fft_chunk):
            fG = fft3(_complex(xi[i0:i0 + fft_chunk]), mesh)
            for iw in range(nw):
                v = ifft3(coulGs[iw] * fG, mesh).real
                W[iw, :, i0:i0 + fft_chunk] = xi @ v.T
                if keep_v:
                    Vxi[iw, i0:i0 + fft_chunk] = v
        W = weight * W
        W = 0.5 * (W + W.transpose(1, 2))
    if squeeze:
        return aoRg, W[0], (Vxi[0] if keep_v else None)
    return aoRg, W, Vxi


def _select(aoR, n_ip, c, method, timer, coords=None, rho=None,
            atom_coords=None):
    """Step 1: the interpolation points (default c * nao of them)."""
    if n_ip is None:
        n_ip = int(c * aoR.shape[1])
    n_ip = min(n_ip, aoR.shape[0])
    if method == "cvt" and (coords is None or rho is None):
        raise ValueError("cvt selection needs coords and rho")
    if method == "atomic" and (coords is None or atom_coords is None):
        raise ValueError("atomic selection needs coords and atom_coords")
    with timer("isdf_select"):
        if method == "cholesky":
            return pivoted_cholesky_points(aoR, n_ip)[0]
        if method == "cholesky-blocked":
            return pivoted_cholesky_points_blocked(aoR, n_ip)[0]
        if method == "cvt":
            return cvt_points(torch.as_tensor(coords, device=aoR.device),
                              rho, n_ip)
        if method == "atomic":
            per_atom = max(1, n_ip // len(atom_coords))
            return atomic_points(aoR, coords, atom_coords, per_atom)
    raise ValueError(f"unknown IP selection method {method!r}")


def build_isdf(aoR, coulG, mesh, weight, n_ip=None, c: float = 8.0,
               method: str = "cholesky", coords=None, rho=None,
               atom_coords=None, keep_v: bool = False,
               precision: str | None = None, timer=None) -> ISDF:
    """Build the ISDF factorization from gridded AOs.

    Args:
        aoR: (ngrids, nao) real AO values (Gamma); sets device and dtype.
        coulG: (ngrids,) Coulomb kernel (G=0 -> 0; exxdiv handled post-hoc).
        weight: vol / ngrids.
        n_ip: number of interpolation points (default c * nao).
        method: 'cholesky' (greedy selection), 'cholesky-blocked', 'cvt'
            (density-weighted K-means; needs coords and rho) or 'atomic'
            (greedy per atom's Voronoi cell; needs coords and atom_coords).
        coords: (ngrids, 3) grid coordinates, for 'cvt' and 'atomic'.
        rho: (ngrids,) density weights, for 'cvt'.
        atom_coords: (natm, 3) atom positions, for 'atomic'.
        keep_v: keep Vxi for :func:`get_k_robust`.
        timer: optional stage timer (``timer(name)`` is a context manager).
    """
    if precision is not None:
        raise NotImplementedError(f"isdf precision {precision!r}: the port "
                                  "solves in the working dtype (float64)")
    timer = timer or null_timer
    ip_idx = _select(aoR, n_ip, c, method, timer, coords, rho, atom_coords)
    coulG = torch.as_tensor(coulG, dtype=aoR.dtype, device=aoR.device)
    aoRg, W, Vxi = _build_from_idx(aoR, ip_idx, coulG, tuple(mesh), weight,
                                   keep_v=keep_v, timer=timer)
    return ISDF(aoRg=aoRg, W=W, ip_idx=ip_idx, Vxi=Vxi)


def build_isdf_multi(aoR, coulGs, mesh, weight, n_ip=None, c: float = 8.0,
                     method: str = "cholesky", keep_v: bool = False,
                     precision: str | None = None, timer=None) -> tuple:
    """One factorization, several Coulomb kernels (e.g. full-range and
    long-range for a range-separated hybrid).

    Returns a tuple of :class:`ISDF` sharing aoRg and ip_idx, one per
    kernel in ``coulGs``: the IP selection and the interpolation-vector
    solve are done once. Arguments as :func:`build_isdf`; ``method`` is
    'cholesky' or 'cholesky-blocked', as in the reference.
    """
    if method not in ("cholesky", "cholesky-blocked"):
        raise ValueError(f"unknown IP selection method {method!r}")
    if precision is not None:
        raise NotImplementedError(f"isdf precision {precision!r}: the port "
                                  "solves in the working dtype (float64)")
    timer = timer or null_timer
    ip_idx = _select(aoR, n_ip, c, method, timer)
    stack = torch.stack([torch.as_tensor(g, dtype=aoR.dtype, device=aoR.device)
                         for g in coulGs])
    aoRg, W, Vxi = _build_from_idx(aoR, ip_idx, stack, tuple(mesh), weight,
                                   keep_v=keep_v, timer=timer)
    return tuple(ISDF(aoRg=aoRg, W=W[i], ip_idx=ip_idx,
                      Vxi=(Vxi[i] if keep_v else None))
                 for i in range(len(coulGs)))


def get_k(isdf: ISDF, dm):
    """Exchange via 3 GEMMs: K = aoRg^T (W o (aoRg D aoRg^T)) aoRg."""
    M = isdf.aoRg @ dm @ isdf.aoRg.T
    return isdf.aoRg.T @ (isdf.W * M) @ isdf.aoRg


def get_k_robust(isdf: ISDF, aoR, dm, weight):
    """Robust-fit exchange: error quadratic in the ISDF fit residual.

    The robust form (ab|cd) ~= (ab~|cd) + (ab|cd~) - (ab~|cd~) keeps one
    exact pair per term:

        K = T1 + T1^T - K_isdf,
        T1[mu,nu] = w sum_P aoRg[P,mu] C[P,nu],
        C[P,nu] = sum_g Vxi[P,g] (aoR (aoRg D)^T)[g,P] aoR[g,nu],

    with the cross term C from :func:`robust_k_cross` (the CUDA kernel on
    the GPU). Requires build_isdf(..., keep_v=True).
    """
    if isdf.Vxi is None:
        raise ValueError("robust K needs build_isdf(..., keep_v=True)")
    B = isdf.aoRg @ dm                       # (nip, nao)
    T1 = weight * (isdf.aoRg.T @ robust_k_cross(aoR, B, isdf.Vxi))
    return T1 + T1.T - get_k(isdf, dm)


def get_j(isdf: ISDF, dm):
    """Coulomb through the ISDF kernel: vj = aoRg^T diag(W rho) aoRg."""
    rho_ip = torch.einsum("pi,ij,pj->p", isdf.aoRg, dm, isdf.aoRg)
    u = isdf.W @ rho_ip
    return isdf.aoRg.T @ (u[:, None] * isdf.aoRg)


def robust_k_error(isdf: ISDF, aoR, C_w, coulG, mesh, weight) -> float:
    """Exact residual form of the robust-fit exchange-energy error:

        tr(D (K_exact - K_robust)) = w sum_ij (r_ij, V r_ij) >= 0,
        r_ij = rho_ij - rho~_ij,

    for the density D = C_w C_w^T. The robust fit's error is quadratic
    (E_rob = 2 (rho, V rho~) - (rho~, V rho~) per occupied pair), so the
    deficit telescopes to the residual's Coulomb norm, a positive sum with
    no cancellation of large terms. The residual r = rho - c xi is formed
    explicitly, with xi re-solved by the build's own regularized solve so
    that it is the residual of the factorization in use.

    Args:
        C_w: (nao, nocc) occupied orbitals scaled by sqrt(occupation).
        coulG: (ngrids,) Coulomb kernel of the factorization.
    Returns the deficit as a float.
    """
    C_w = torch.as_tensor(C_w, dtype=aoR.dtype, device=aoR.device)
    coulG = torch.as_tensor(coulG, dtype=aoR.dtype, device=aoR.device)
    psi = aoR @ C_w                                   # (ng, no)
    psig = isdf.aoRg @ C_w                            # (nip, no)
    xi = _solve_xi(aoR, isdf.aoRg)                    # (nip, ng)
    total = torch.zeros((), dtype=aoR.dtype, device=aoR.device)
    for i in range(psi.shape[1]):
        r = (psi * psi[:, i:i + 1]).T - (psig * psig[:, i:i + 1]).T @ xi
        Vr = ifft3(coulG * fft3(_complex(r), tuple(mesh)), tuple(mesh)).real
        total += (r * Vr).sum()
    return float(weight * total)

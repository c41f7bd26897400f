"""q-resolved k-point ISDF: per-momentum-transfer interpolation vectors.

The translation-symmetric supercell ISDF expressed in momentum space. ONE
set of interpolation points S0 in the primitive cell (|S0| = c * nao, the
IP density of a Gamma-supercell build with that c); the supercell
factorization over the translated copies of S0 block-diagonalizes EXACTLY
over momentum transfers q:

    C1_q[P,P'] = (1/nk) sum_k  R_k[P,P'] conj(R_{k-q}[P,P'])
    C2_q[g,P]  = (1/nk) sum_k  P_k[g,P]  conj(P_{k-q}[g,P])
    X_q        = (C1_q + eps I)^{-1} C2_q^H          (nip, ng)

with R_k / P_k the k-resolved AO pair Grams restricted to S0. A Bloch
pair density conj(phi_k1,mu) phi_k2,nu (momentum q = k2 - k1) is fitted
by the q-sector vectors alone:

    rho~(g) = sum_P X_q[P,g] conj(phi_k1,mu(r_P)) phi_k2,nu(r_P)

The per-q solves cost nk * nip^2 * ng, a factor nk^2 below the dense
supercell solve, which makes the float64 certificate of the supercell
factorization cheap (:mod:`pyscf_isdf_tpu_torch.df.isdf_sym`).

Conventions (exact in the n_ip == ng limit):
    K_k1 = (1/nk) sum_k2 A1^H (M2 o conj(W_q)) A1,  M2 = A2 D2 A2^H
    W_q[P,Q] = w sum_g conj(X_q[P,g]) (V_q X_q[Q])(g)
    (V_q f)(g) = e^{iq.r_g} ifft( coulG(q) fft(e^{-iq.r} f) )(g)
with A_k = aoR_k[:, S0] (Bloch values, phases included) and D the
ket-major density matrix dm[k][mu,nu] = sum_i C[mu,i] occ_i conj(C[nu,i]).

Reference baseline for the exact exchange these kernels replace:
pyscf/pbc/df/fft_jk.py:50-107. Everything runs in torch on the device of
the AO values, complex128; the float64 host certificate
(:func:`deficit_robust_numpy`) runs in numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.df.isdf_k import periodic_parts, select_ips
from pyscf_isdf_tpu_torch.ops import coulomb
from pyscf_isdf_tpu_torch.ops.interp_points import cvt_points


def unique_q(cell, kpts):
    """Map (k2, k1) pairs to unique momentum-transfer CLASSES q = k2 - k1
    wrapped into [-1/2, 1/2) fractional coordinates (mod G), so nq == nk
    on any uniform Monkhorst-Pack mesh. The fit acts on full Bloch pair
    values, which do not depend on the representative; phase_q and
    coulG_q use the same one.
    Returns (q_list (nq, 3), qmap (nk, nk) int), first-appearance order.
    """
    kpts = np.reshape(kpts, (-1, 3))
    nk = len(kpts)
    b = lattice.reciprocal_vectors(cell.a)
    diffs = (kpts[:, None, :] - kpts[None, :, :]).reshape(-1, 3)
    frac = diffs @ np.linalg.inv(b)
    frac = ((frac + 0.5) % 1.0) - 0.5
    # snap to exact multiples of 1/n on an n-point mesh axis, so the bins
    # are stable and q carries no rounding: rounding to 8 decimals puts
    # 1/3 off by 3e-9, and the assembled supercell factorization (whose
    # phases e^{-iq.r} then miss) off the dense supercell build by 1e-8
    n = coulomb.monkhorst_pack_size(cell, kpts)
    snapped = np.rint(frac * n) / n
    frac = np.where(np.abs(frac - snapped) < 1e-8, snapped, frac)
    diffs = frac @ b
    _, first, inv = np.unique(np.round(diffs, 8), axis=0,
                              return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    qmap = rank[inv.ravel()].reshape(nk, nk).astype(np.int64)
    return diffs[np.sort(first)], qmap


@dataclass(frozen=True)
class ISDFQ:
    """q-resolved k-point ISDF factorization (tensors on one device)."""

    Ag: torch.Tensor        # (nk, nip, nao) complex Bloch AO values at IPs
    Wq: torch.Tensor        # (nq, nip, nip) complex per-q kernels
    qmap: np.ndarray        # (nk, nk) -> q index of (k_i - k_j)
    ip_idx: torch.Tensor    # (nip,) primitive-grid indices
    Xq: torch.Tensor | None = None       # (nq, nip, ng) per-q interp vectors
    VXq: torch.Tensor | None = None      # (nq, nip, ng) V_q-applied Xq rows
    phase_q: torch.Tensor | None = None  # (nq, ng) e^{-i q.r} (with Xq/VXq)

    @property
    def n_ip(self) -> int:
        return self.Ag.shape[1]


def _build_q(R, P, ksub_q, coulG_q, phase_q, mesh, weight, fft_chunk: int = 64):
    """One momentum sector: (C1_q, C2_q) -> X_q, V_q X_q, W_q.

    Args:
        R: (nk, nip, nip) per-k IP Grams conj(Ag_k) Ag_k^T.
        P: (nk, ng, nip) per-k grid-IP Grams conj(A_k) Ag_k^T.
        ksub_q: (nk,) index of k - q per k.
        phase_q: (ng,) e^{-i q.r}.

    The shift is 1e-12 of the mean diagonal of C1_q, the supercell
    build's float64 shift.
    """
    nk, nip = R.shape[0], R.shape[1]
    C1 = (R * R[ksub_q].conj()).sum(0) / nk                  # (nip, nip)
    C2 = (P * P[ksub_q].conj()).sum(0) / nk                  # (ng, nip)
    eps = 1e-12 * torch.trace(C1).real / nip
    cho = torch.linalg.cholesky(
        C1 + eps * torch.eye(nip, dtype=C1.dtype, device=C1.device))
    Xq = torch.cholesky_solve(C2.conj().T, cho)              # (nip, ng)
    return _vx_wq(Xq, coulG_q, phase_q, mesh, weight, fft_chunk)


def _vx_wq(Xq, coulG_q, phase_q, mesh, weight, fft_chunk: int = 64):
    """V_q applied to each X_q row (``fft_chunk`` rows at a time) and the
    Hermitian W_q kernel. Returns (Xq, VXq, Wq)."""
    VX = torch.cat([
        phase_q.conj() * ifft3(coulG_q * fft3(phase_q * Xq[i0:i0 + fft_chunk],
                                              mesh), mesh)
        for i0 in range(0, Xq.shape[0], fft_chunk)])
    Wq = weight * (Xq.conj() @ VX.T)
    return Xq, VX, 0.5 * (Wq + Wq.conj().T)


def _ksub(cell, kpts, q_list):
    """ksub[iq, ik] = index m with k_m == k_ik - q_iq (mod G)."""
    nk, nq = len(kpts), len(q_list)
    ksub = np.zeros((nq, nk), dtype=np.int64)
    binv = np.linalg.inv(lattice.reciprocal_vectors(cell.a))
    kf = kpts @ binv
    for iq in range(nq):
        tgt = kf - q_list[iq] @ binv
        dd = ((tgt[:, None, :] - kf[None, :, :] + 0.5) % 1.0) - 0.5
        m = np.argmin(np.abs(dd).sum(-1), axis=1)
        if np.abs(dd[np.arange(nk), m]).max() > 1e-8:
            raise ValueError("k-mesh is not closed under q-translation "
                             "(need a uniform Monkhorst-Pack mesh)")
        ksub[iq] = m
    return ksub


def coulG_table(cell, kpts, q_list, exxdiv=None, omega=None):
    """(nq, ng) per-q Coulomb kernels (range-separated with ``omega``), the
    q=0 one symmetrized over G -> -G.

    On non-orthogonal lattices the fftfreq Nyquist planes make |G|^2
    index-asymmetric (the -n/2 frequency is kept, +n/2 aliases onto it);
    the real Gamma pipeline and the k-point J symmetrize implicitly by
    taking .real of the ifft, and this keeps the complex q=0 sector on the
    same convention.
    """
    coulG_q = np.stack([coulomb.get_coulG(cell, k=q, exxdiv=exxdiv, kpts=kpts,
                                          omega=omega)
                        for q in q_list])
    mesh3 = tuple(cell.mesh)
    neg = np.ravel_multi_index(
        np.meshgrid(*[(-np.arange(n)) % n for n in mesh3], indexing="ij"),
        mesh3).ravel()
    for iq in range(len(q_list)):
        if np.abs(q_list[iq]).max() < 1e-9:
            coulG_q[iq] = 0.5 * (coulG_q[iq] + coulG_q[iq][neg])
    return coulG_q


def build_isdf_q(cell, aoR_k, kpts, n_ip=None, c: float = 16.0,
                 exxdiv=None, omega: float = 0.0, keep_x: bool = False,
                 method: str = "auto", blk: int = 64, coulG_q=None,
                 precision: str | None = None, rho=None) -> ISDFQ:
    """Build the q-resolved k-point ISDF factorization on the device of
    ``aoR_k``.

    Args:
        aoR_k: (nk, ng, nao) complex Bloch AO values on the primitive grid.
        c: IP count as a multiple of nao, the SUPERCELL-equivalent
            compression (n_ip = c * nao points in the primitive cell).
        exxdiv: None; 'ewald' is the SCF loop's madelung shift, pass None.
        keep_x: retain Xq/VXq/phase_q (needed by the robust exchange and
            the residual-deficit certificates).
        method: 'cholesky', 'cholesky-blocked', 'auto' or 'cvt'
            (density-weighted K-means on the primitive grid, weighted by
            ``rho``; by default the k-averaged AO density
            (1/nk) sum_k sum_mu |phi^k_mu|^2).
        coulG_q: optional caller-supplied (nq, ng) kernel table in q_list
            order (e.g. the coset slices of a supercell kernel,
            df/isdf_sym.py).
        omega: range separation of the per-q kernels (> 0 long-range erf,
            < 0 short-range erfc), for range-separated exchange.

    ``precision='dd'`` is not ported and raises ``NotImplementedError``.
    """
    if precision is not None:
        raise NotImplementedError(f"build precision {precision!r}: the port "
                                  "solves in float64")
    kpts = np.reshape(np.asarray(kpts), (-1, 3))
    nk, ng, nao = aoR_k.shape
    dev = aoR_k.device
    if n_ip is None:
        n_ip = int(c * nao)
    n_ip = min(n_ip, ng)
    if n_ip >= ng:
        # exact limit: every grid point is an interpolation point (the
        # pivoted selection's Gram is singular past the pair rank)
        ip_idx = torch.arange(ng, device=dev)
    elif method == "cvt":
        if rho is None:
            rho = (aoR_k.abs() ** 2).sum(2).mean(0)
        ip_idx = cvt_points(torch.as_tensor(cell.uniform_grid(), device=dev),
                            rho, n_ip)
    else:
        _, U = periodic_parts(cell, aoR_k, kpts)
        ip_idx = select_ips(U, n_ip, method, blk)

    q_list, qmap = unique_q(cell, kpts)
    nq = len(q_list)
    ksub = _ksub(cell, kpts, q_list)
    if coulG_q is None:
        coulG_q = coulG_table(cell, kpts, q_list, exxdiv, omega or None)
    elif np.shape(coulG_q) != (nq, ng):
        raise ValueError(f"coulG_q must be ({nq}, {ng}), got {np.shape(coulG_q)}")
    coulG_q = torch.as_tensor(np.asarray(coulG_q), dtype=torch.float64, device=dev)
    coords = torch.as_tensor(cell.uniform_grid(), dtype=torch.float64, device=dev)
    qt = torch.as_tensor(q_list, dtype=torch.float64, device=dev)
    phase_q = torch.exp(-1j * (coords @ qt.T)).T.contiguous()   # (nq, ng)
    Ag = aoR_k[:, ip_idx]                                       # (nk, nip, nao)
    R = Ag.conj() @ Ag.transpose(1, 2)                          # (nk, nip, nip)
    P = aoR_k.conj() @ Ag.transpose(1, 2)                       # (nk, ng, nip)

    Wq = torch.empty((nq, Ag.shape[1], Ag.shape[1]), dtype=Ag.dtype, device=dev)
    Xq = VXq = None
    if keep_x:
        Xq = torch.empty((nq, Ag.shape[1], ng), dtype=Ag.dtype, device=dev)
        VXq = torch.empty_like(Xq)
    for iq in range(nq):
        X, VX, Wq[iq] = _build_q(R, P, torch.as_tensor(ksub[iq], device=dev),
                                 coulG_q[iq], phase_q[iq], tuple(cell.mesh),
                                 cell.grid_weight)
        if keep_x:
            Xq[iq], VXq[iq] = X, VX
    return ISDFQ(Ag=Ag, Wq=Wq, qmap=qmap, ip_idx=ip_idx, Xq=Xq, VXq=VXq,
                 phase_q=(phase_q if keep_x else None))


def get_j_kpts(isdfq: ISDFQ, dm_k):
    """Fitted Coulomb: the q=0 sector is a Gamma-type ISDF.

    vj_k = A_k^H diag(W_0 rho_ip) A_k,
    rho_ip[P] = (1/nk) sum_k2 (A2 D2 A2^H)[P,P].
    """
    Ag = isdfq.Ag
    nk = Ag.shape[0]
    rho = torch.einsum("kpa,kab,kpb->p", Ag, dm_k.to(Ag.dtype), Ag.conj()) / nk
    u = isdfq.Wq[int(isdfq.qmap[0, 0])] @ rho
    return torch.einsum("kpa,p,kpb->kab", Ag.conj(), u, Ag)


def get_k_kpts(isdfq: ISDFQ, dm_k):
    """Fitted exchange: K_k1 = (1/nk) sum_k2 A1^H (M2 o conj(W_q)) A1."""
    Ag = isdfq.Ag
    nk = Ag.shape[0]
    M = Ag @ dm_k.to(Ag.dtype) @ Ag.conj().transpose(1, 2)    # (nk, nip, nip)
    Wc = isdfq.Wq.conj()
    return torch.stack([
        Ag[k1].conj().T @ (M * Wc[isdfq.qmap[:, k1]]).sum(0) @ Ag[k1] / nk
        for k1 in range(nk)])


def get_k_kpts_robust(isdfq: ISDFQ, dm_k, aoR_k, weight):
    """Robust-fit exchange (error quadratic in the fit residual):

        K_rob = T + T^H - K_fit,
        T_k1  = (w/nk) sum_k2 Phi1^H ((t2 o conj(VX_q^T)) A1),
        t2    = Phi2 D2 A2^H

    — one exact pair per term, the k-point analog of isdf.get_k_robust.
    Requires build_isdf_q(..., keep_x=True).
    """
    if isdfq.VXq is None:
        raise ValueError("robust K needs build_isdf_q(..., keep_x=True)")
    Ag = isdfq.Ag
    nk = Ag.shape[0]
    dm_k = dm_k.to(Ag.dtype)
    AgH = Ag.conj().transpose(1, 2)
    M = Ag @ dm_k @ AgH                                      # (nk, nip, nip)
    t = aoR_k @ dm_k @ AgH                                   # (nk, ng, nip)
    Wc = isdfq.Wq.conj()
    out = []
    for k1 in range(nk):
        iq = isdfq.qmap[:, k1]
        Y = (t * isdfq.VXq[iq].conj().transpose(1, 2)).sum(0)   # (ng, nip)
        T = weight / nk * (aoR_k[k1].conj().T @ (Y @ Ag[k1]))
        Kf = Ag[k1].conj().T @ (M * Wc[iq]).sum(0) @ Ag[k1]
        out.append(T + T.conj().T - Kf / nk)
    return torch.stack(out)


def _pairs(psi_a, psi_b):
    """(npair, no*no, n) pair products conj(psi_a[i]) psi_b[j], per pair."""
    p = psi_a.conj()[..., :, :, None] * psi_b[..., :, None, :]
    return p.reshape(p.shape[:-3] + (p.shape[-3], -1)).transpose(-1, -2)


def deficit_robust(isdfq: ISDFQ, psi_k, kpts, coulG_q_full, mesh, weight):
    """EXACT robust-fit exchange-energy error at a k-sampled density:

        tr(D (K_exact - K_rob)) = (w/nk) sum_{k1 i k2 j} (r, V_q r),
        r = conj(psi_k1,i) psi_k2,j  -  X_q^T [pair at IPs]

    a POSITIVE sum with no large-number cancellation (the robust error
    telescopes to the residual Coulomb norm per occupied pair), on the
    device of the factorization. The pairs of one momentum class q share
    X_q, so each class is one GEMM and one batch of FFTs.

    Args:
        psi_k: (nk, ng, nocc) sqrt(occupation)-scaled occupied Bloch
            orbitals on the primitive grid.
        coulG_q_full: (nq, ng) per-q Coulomb kernels (exxdiv=None).
    Returns the TOTAL (supercell) deficit in Hartree.
    """
    if isdfq.Xq is None:
        raise ValueError("deficit needs build_isdf_q(..., keep_x=True)")
    dev = isdfq.Xq.device
    psi_k = torch.as_tensor(psi_k, dtype=torch.complex128, device=dev)
    coulG = torch.as_tensor(np.asarray(coulG_q_full), dtype=torch.float64,
                            device=dev)
    nk = psi_k.shape[0]
    psig = psi_k[:, isdfq.ip_idx]
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for iq in range(isdfq.Xq.shape[0]):
        k2s, k1s = np.nonzero(isdfq.qmap == iq)
        r = _pairs(psi_k[k1s], psi_k[k2s]) \
            - _pairs(psig[k1s], psig[k2s]) @ isdfq.Xq[iq]     # (npair, no^2, ng)
        ph = isdfq.phase_q[iq]
        vr = ph.conj() * ifft3(coulG[iq] * fft3(ph * r, mesh), mesh)
        total += (r.conj() * vr).real.sum()
    return float(weight * total / nk)


def deficit_robust_numpy(Xq, phase_q, qmap, ip_idx, psi_k, coulG_q_full,
                         mesh, weight):
    """Host float64 evaluation of :func:`deficit_robust` in numpy
    complex128, independent of the device's arithmetic: the same
    identity, per momentum class, with numpy's FFTs and GEMMs.

    Args:
        Xq: (nq, nip, ng) interpolation vectors.
        phase_q: (nq, ng) e^{-i q.r}.
        qmap: (nk, nk) q index of k_i - k_j.
        psi_k: (nk, ng, nocc) sqrt(occ)-scaled occupied Bloch orbitals.
        coulG_q_full: (nq, ng) per-q Coulomb kernels (exxdiv=None).
    """
    Xq = np.asarray(Xq, dtype=np.complex128)
    phase_q = np.asarray(phase_q, dtype=np.complex128)
    psi_k = np.asarray(psi_k, dtype=np.complex128)
    coulG_q_full = np.asarray(coulG_q_full, dtype=np.float64)
    ipg = np.asarray(ip_idx)
    nk, ng, nocc = psi_k.shape
    mesh = tuple(mesh)
    psig = psi_k[:, ipg, :]

    def pairs(a, b):                      # (npair, n, no) x2 -> (npair, no^2, n)
        p = a.conj()[:, :, :, None] * b[:, :, None, :]
        return p.reshape(p.shape[0], p.shape[1], -1).transpose(0, 2, 1)

    total = 0.0
    for iq in range(Xq.shape[0]):
        k2s, k1s = np.nonzero(np.asarray(qmap) == iq)
        r = pairs(psi_k[k1s], psi_k[k2s]) - pairs(psig[k1s], psig[k2s]) @ Xq[iq]
        per = (phase_q[iq] * r).reshape(-1, *mesh)
        vG = np.fft.fftn(per, axes=(1, 2, 3)) * coulG_q_full[iq].reshape(mesh)
        vr = phase_q[iq].conj() * np.fft.ifftn(vG, axes=(1, 2, 3)).reshape(r.shape)
        total += float(np.sum((r.conj() * vr).real))
    return weight * total / nk

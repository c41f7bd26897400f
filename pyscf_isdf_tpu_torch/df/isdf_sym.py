"""Translation-symmetric supercell ISDF: per-q solves, assembled factorization.

A Gamma-supercell (nrep = N1 x N2 x N3 primitive cells) ISDF whose
interpolation points are one primitive-cell set replicated over the nk
translations block-diagonalizes EXACTLY over momentum transfers q
(df/isdf_q.py). This module assembles the SUPERCELL factorization
(aoRg, W, Vxi of :class:`pyscf_isdf_tpu_torch.df.isdf.ISDF`, the object
the robust-K kernel K2 consumes) from the per-q pieces:

    xi_super[(r,P),(s,g)] = (1/nk) sum_q conj(ph[r,q]) ph[s,q] X_q[P,g]
    Vxi_super             =  same with VX_q
    W_super[(r,P),(s,Q)]  = (w/nk) sum_q conj(ph[r,q]) ph[s,q]
                            (X_q VX_{-q}^T)[P,Q]
    ph[r,q] = e^{i q . T_r}

with the per-q Coulomb kernels COSET-SLICED from the supercell kernel
(G_s = (t + nrep*j) b_s per axis, t = q in supercell reciprocal units,
j = primitive fftfreq) so the assembled operator matches the supercell
FFTDF semantics exactly, Nyquist conventions included. The assembled
matrices carry a small antisymmetric imaginary artifact from the Nyquist
shell; real densities only probe the real symmetric part, so the .real
projection is exact for the supercell exchange.

The per-q solves cost nk * nip_p^2 * ng_p, a factor nk^2 below the dense
supercell solve, so the float64 build and the exact residual-deficit
certificate

    tr(D (K_exact - K_robust)) = w sum_pairs (r, V r) >= 0

are cheap at the diamond 3x3x3 scale. The build, the assembly and the
device certificate run in torch on the device of the AO values; the host
certificate runs in numpy.

Reference baseline being replaced: pyscf/pbc/df/fft_jk.py:276-291
(exact-K cost model); the supercell/k-point duality is the reference's own
test contract (pyscf/pbc/dft/test/test_gamma_vs_ks.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.df import isdf_q as isdf_q_mod
from pyscf_isdf_tpu_torch.df.isdf import ISDF


def translations(nrep):
    """(ncells, 3) integer translations, R-major (matching
    models.diamond_supercell atom ordering)."""
    return np.stack(np.meshgrid(*[np.arange(n) for n in nrep],
                                indexing="ij"), -1).reshape(-1, 3)


def _signed_freq(prim_mesh):
    pm = np.asarray(prim_mesh)
    gi = np.stack(np.unravel_index(np.arange(int(np.prod(pm))), tuple(pm)), -1)
    return np.where(gi <= (pm - 1) // 2, gi, gi - pm)


def grid_map(prim_mesh, nrep):
    """(ncells, ng_prim) supercell grid index of every (R, g_prim) point.

    uniform_grid uses fftfreq (wrap-around) ordering, so the map runs
    through signed frequencies: i_s = (pm*R + signed(i_p)) mod (pm*nrep)
    per axis.
    """
    pm = np.asarray(prim_mesh)
    sm = pm * np.asarray(nrep)
    j = _signed_freq(prim_mesh)
    Rs = translations(nrep)
    out = np.empty((len(Rs), j.shape[0]), dtype=np.int64)
    for r, R in enumerate(Rs):
        out[r] = np.ravel_multi_index(((pm * R + j) % sm).T, tuple(sm))
    return out


def coset_kernels(coulG_super, prim_mesh, nrep, q_list, a_super):
    """(nq, ng_prim) per-q kernel tables sliced from the supercell kernel.

    Supercell G-vector of (q, G_prim): per axis m = t + nrep * j with
    t = q in supercell reciprocal-lattice units and j the primitive
    signed frequency, wrapped into the supercell fftfreq range. The per-q
    tables then agree with the supercell kernel ENTRY-WISE, Nyquist
    aliasing included.
    """
    nrep = np.asarray(nrep)
    sm = np.asarray(prim_mesh) * nrep
    j = _signed_freq(prim_mesh)
    coulG_super = np.asarray(coulG_super)
    out = np.empty((len(q_list), j.shape[0]), dtype=np.float64)
    for iq, qv in enumerate(q_list):
        t = np.rint(qv @ np.asarray(a_super).T / (2 * np.pi)).astype(int)
        m = (t[None, :] + nrep * j) % sm          # frequency -> fft index
        out[iq] = coulG_super[np.ravel_multi_index(m.T, tuple(sm))]
    return out


@dataclass
class SymISDF:
    """Per-q factorization of a symmetric supercell build, plus what
    assembling and certifying it needs (tensors on one device)."""

    isdfq: isdf_q_mod.ISDFQ      # per-q factorization (keep_x=True)
    q_list: np.ndarray           # (nq, 3)
    kpts: np.ndarray             # (nk, 3)
    nrep: tuple                  # (3,)
    prim_mesh: tuple             # (3,)
    coulG_q: np.ndarray          # (nq, ng_prim) coset kernel slices
    Mq: torch.Tensor             # (nq, nip, nip) w * X_q VX_{-q}^T
    weight: float                # primitive == supercell grid weight


def build_sym(prim_cell, nrep, aoR_k, kpts, coulG_super, c=24.0,
              n_ip=None, method: str = "auto",
              precision: str | None = None) -> SymISDF:
    """Per-q build of the translation-symmetric supercell ISDF.

    Args:
        aoR_k: (nk, ng_prim, nao_prim) complex128 Bloch AOs on the
            primitive grid (k-mesh == nrep, Gamma-centred); the build runs
            on their device in float64.
        coulG_super: (ng_super,) the SUPERCELL Coulomb kernel the
            supercell SCF uses (exxdiv=None for the ewald-shift convention).
        c: supercell-equivalent compression (n_ip = c * nao_prim points
            per primitive cell = c * nao_super total).

    ``precision='dd'`` (the TPU's double-float solve) is not ported:
    float64 on the card replaces it, and it raises ``NotImplementedError``.
    """
    if precision is not None:
        raise NotImplementedError(f"build precision {precision!r}: the port "
                                  "solves in float64")
    kpts = np.reshape(np.asarray(kpts), (-1, 3))
    q_list, _ = isdf_q_mod.unique_q(prim_cell, kpts)
    coulG_q = coset_kernels(coulG_super, prim_cell.mesh, nrep, q_list,
                            np.asarray(prim_cell.a) * np.asarray(nrep)[:, None])
    isdfq = isdf_q_mod.build_isdf_q(
        prim_cell, aoR_k, kpts, n_ip=n_ip, c=c, keep_x=True, method=method,
        coulG_q=coulG_q)
    # -q class index map
    binv = np.linalg.inv(lattice.reciprocal_vectors(prim_cell.a))
    nq = len(q_list)
    negq = np.empty(nq, dtype=np.int64)
    for iq in range(nq):
        d = ((-q_list[iq] - q_list) @ binv + 0.5) % 1.0 - 0.5
        negq[iq] = int(np.argmin(np.abs(d).sum(1)))
        if np.abs(d[negq[iq]]).max() > 1e-8:
            raise ValueError("q classes not closed under negation")
    # a plain transpose, not the conjugate one
    Mq = prim_cell.grid_weight * (isdfq.Xq @ isdfq.VXq[negq].transpose(1, 2))
    return SymISDF(isdfq=isdfq, q_list=q_list, kpts=kpts,
                   nrep=tuple(int(n) for n in nrep),
                   prim_mesh=tuple(int(n) for n in prim_cell.mesh),
                   coulG_q=coulG_q, Mq=Mq,
                   weight=float(prim_cell.grid_weight))


def assemble(sym: SymISDF, aoR_super, prim_a) -> ISDF:
    """Assemble the supercell ISDF factorization on the device and in the
    dtype of ``aoR_super``.

    aoRg rows are taken from the caller's own supercell aoR (exact
    consistency with the surrounding SCF); W and Vxi are assembled from
    the per-q pieces by the translation-group DFT. The output feeds
    isdf.get_k / isdf.get_k_robust / isdf.get_j unchanged.
    """
    return assemble_pieces(sym.nrep, sym.prim_mesh, prim_a, sym.q_list,
                           sym.isdfq.ip_idx, sym.isdfq.VXq, sym.Mq,
                           aoR_super)


def assemble_pieces(nrep, prim_mesh, prim_a, q_list, ip_idx, VXq, Mq,
                    aoR_super) -> ISDF:
    """Array-based assembly core. Vxi (ncell*nip, ngrids) is allocated once
    and each grid cell's column block is copied into it in place."""
    dev = aoR_super.device
    dtype = aoR_super.dtype
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    Rs = translations(nrep)
    Ts = Rs @ np.asarray(prim_a)
    qph = torch.as_tensor(np.exp(1j * Ts @ np.asarray(q_list).T), dtype=cdt,
                          device=dev)                     # (ncell, nq)
    ns = grid_map(prim_mesh, nrep)                        # (ncell, ngp)
    ipg = np.asarray(torch.as_tensor(ip_idx).cpu())
    nk, ngp = ns.shape
    nip = len(ipg)
    Mq = torch.as_tensor(Mq, device=dev).to(cdt)
    VXq = torch.as_tensor(VXq, device=dev).to(cdt)

    W = torch.einsum("rq,sq,qPQ->rPsQ", qph.conj(), qph, Mq)
    W = (W.real / nk).to(dtype).reshape(nk * nip, nk * nip)

    Vxi = torch.empty((nk * nip, nk * ngp), dtype=dtype, device=dev)
    for s in range(nk):
        blk = torch.einsum("rq,qPg->rPg", qph.conj() * qph[s], VXq)
        Vxi.index_copy_(1, torch.as_tensor(ns[s], device=dev),
                        (blk.real / nk).to(dtype).reshape(nk * nip, ngp))
        del blk

    ip_super = torch.as_tensor(ns[:, ipg].reshape(-1), device=dev)
    return ISDF(aoRg=aoR_super[ip_super], W=W, ip_idx=ip_super, Vxi=Vxi)


def certify_deficit(sym: SymISDF, psi_k) -> float:
    """EXACT robust-fit exchange deficit of the assembled supercell
    factorization at the density D = sum_k psi_k psi_k^H / nk-unfolded:

        tr(D (K_exact - K_robust)) = (w/nk) sum_pairs (r, V_q r) >= 0

    evaluated per q in float64 on the factorization's device. psi_k are
    sqrt(occupation)-scaled occupied Bloch orbitals on the primitive grid;
    the returned value is the TOTAL supercell deficit in Hartree.
    """
    return isdf_q_mod.deficit_robust(sym.isdfq, psi_k, sym.kpts, sym.coulG_q,
                                     sym.prim_mesh, sym.weight)


def certify_deficit_host(sym: SymISDF, psi_k) -> float:
    """:func:`certify_deficit` evaluated on the host in numpy complex128
    (:func:`~pyscf_isdf_tpu_torch.df.isdf_q.deficit_robust_numpy`): the
    shipped vectors' method error, independent of the device's FFTs and
    GEMMs."""
    q = sym.isdfq
    if q.Xq is None or q.phase_q is None:
        raise ValueError("host certification needs keep_x=True pieces")
    return isdf_q_mod.deficit_robust_numpy(
        q.Xq.cpu().numpy(), q.phase_q.cpu().numpy(), q.qmap,
        q.ip_idx.cpu().numpy(), torch.as_tensor(psi_k).cpu().numpy(),
        sym.coulG_q, sym.prim_mesh, sym.weight)

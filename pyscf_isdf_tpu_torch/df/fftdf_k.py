"""k-point sampled FFT density fitting: J and K at sampled k (torch).

Complex Bloch-AO version of :mod:`pyscf_isdf_tpu_torch.df.fftdf`
(algorithmic contract: pyscf/pbc/df/fft_jk.py:33-109 for J, :177-302 for
K):

  J: one Poisson solve of the k-averaged density, then per-k quadrature.
  K: double k-loop over (k1, k2) momentum transfers q = k2 - k1 with the
     wrap-around Coulomb kernel coulG(q) and e^{-iq.r} phase factors — the
     O(nao nk^2) FFT cost the k-point ISDF engines amortize. For each
     density k2 the bra rows of every band k1 go through the FFTs
     together, ``chunk`` rows at a time. At band k-points off the SCF set
     (:func:`get_k_band`) the band k-points' AOs are the bra.

The per-(k1,k2) constants (coulG(q), expmikr) are precomputed on the host
in float64 (:func:`make_k_kernels`).
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.ops import coulomb


def get_j_kpts(aoR_k, dm_k, coulG, mesh, weight):
    """Coulomb matrices at all k.

    Args:
        aoR_k: (nk, ng, nao) complex Bloch AOs.
        dm_k: (nk, nao, nao) density matrices.
        coulG: (ng,) kernel at q=0.
    Returns (nk, nao, nao) complex vj.
    """
    nk = aoR_k.shape[0]
    t = aoR_k @ dm_k                                         # (nk, ng, nao)
    rho = (t * aoR_k.conj()).sum((0, 2)).real / nk
    vR = ifft3(coulG * fft3(rho.to(aoR_k.dtype), mesh), mesh).real
    return weight * ((aoR_k.conj().transpose(1, 2) * vR) @ aoR_k)


def make_k_kernels(cell, kpts, exxdiv=None, omega=None):
    """Host-precompute per-(k1,k2) Coulomb kernels and phase factors.

    Returns (coulG_pairs (nk,nk,ng) float64, expmikr (nk,nk,ng) complex128)
    with expmikr[k2,k1] = exp(-i (k2-k1).r). exxdiv='ewald' is handled
    post-hoc via the madelung shift, so kernels use exxdiv=None
    (fft_jk.py:267-270 semantics). ``omega`` > 0 gives the long-range
    (erf), < 0 the short-range (erfc) kernels of range-separated exchange.
    """
    kpts = np.reshape(kpts, (-1, 3))
    nk = len(kpts)
    coords = cell.uniform_grid()
    ng = coords.shape[0]
    ex = exxdiv if exxdiv != "ewald" else None
    coulG = np.empty((nk, nk, ng))
    expmikr = np.empty((nk, nk, ng), dtype=np.complex128)
    for k2 in range(nk):
        for k1 in range(nk):
            q = kpts[k2] - kpts[k1]
            coulG[k2, k1] = coulomb.get_coulG(cell, k=q, exxdiv=ex, kpts=kpts,
                                              omega=omega)
            expmikr[k2, k1] = np.exp(-1j * coords @ q)
    return coulG, expmikr


def _k_sum(ao1, nk2, ket, ket_dm, kernel, mesh, weight, chunk):
    """sum_k2 w conj(phase) [ifft(coulG fft(bra x ket_k2)) . ket_dm_k2] ao1
    over the bra rows conj(ao1) phase of every band k-point in ``ao1``
    (n1, ng, nao); ``kernel(k2)`` gives the (n1, ng) kernels coulG and
    phases e^{-i(k2-k1).r} of the band k-points against density k2."""
    n1, ng, nao = ao1.shape
    vk = torch.zeros((n1, nao, nao), dtype=ao1.dtype, device=ao1.device)
    for k2 in range(nk2):
        ketT, dmT = ket(k2), ket_dm(k2)                      # (nb, ng) each
        cG, phase = kernel(k2)                               # (n1, ng) each
        bra = (ao1.conj().transpose(1, 2) * phase[:, None, :]).reshape(-1, ng)
        rows = []
        for i0 in range(0, bra.shape[0], chunk):
            blk = bra[i0:i0 + chunk]                         # (b, ng)
            kk = torch.arange(i0, i0 + blk.shape[0], device=bra.device) // nao
            rho1 = blk[:, None, :] * ketT[None, :, :]        # (b, nb, ng)
            vR = ifft3(cG[kk][:, None, :] * fft3(rho1, mesh), mesh)
            rows.append((vR * dmT[None]).sum(1))
        vR_dm = torch.cat(rows).reshape(n1, nao, ng) * phase.conj()[:, None, :]
        vk += weight * (vR_dm @ ao1)
    return vk


def _pair_kernels(aoR_k, coulG_pairs, expmikr, k1_idx):
    """The band rows ``k1_idx`` (all k when None) of the SCF set and the
    kernel function of :func:`_k_sum` over them."""
    if k1_idx is None:
        return aoR_k, lambda k2: (coulG_pairs[k2], expmikr[k2])
    k1 = torch.as_tensor(list(k1_idx), device=aoR_k.device)
    return aoR_k[k1], lambda k2: (coulG_pairs[k2][k1], expmikr[k2][k1])


def get_k_kpts(aoR_k, dm_k, coulG_pairs, expmikr, mesh, weight,
               chunk: int = 16, k1_idx=None):
    """Exchange matrices at all k (double k-loop pair-density FFTs).

    Args:
        coulG_pairs: (nk, nk, ng) kernels coulG(k2-k1) from make_k_kernels.
        expmikr: (nk, nk, ng) phases exp(-i(k2-k1).r).
        weight: (1/nk) * vol/ngrids.
        k1_idx: optional band k-points (the exchange still sums over every
            density k2), the IBZ driver's subset. Output order follows
            k1_idx.
    """
    ao1, kernel = _pair_kernels(aoR_k, coulG_pairs, expmikr, k1_idx)
    return _k_sum(ao1, aoR_k.shape[0], lambda k2: aoR_k[k2].T,
                  lambda k2: dm_k[k2] @ aoR_k[k2].T.conj(), kernel, mesh, weight,
                  chunk)


def get_k_band(aoRb, aoR_k, dm_k, coulG_bk, expmikr_bk, mesh, kweight,
               chunk: int = 16):
    """Exchange at band k-points from the k-sampled SCF density (the
    reference's get_bands exchange, pyscf/pbc/scf/khf.py:581 with the
    fft_jk kpts_band path): the bra rows are the band k-point's AOs, the
    sum runs over every density k2 as in :func:`get_k_kpts`.

    Args:
        aoRb: (ng, nao) Bloch AOs at one band k-point, or (nb, ng, nao)
            at ``nb`` of them at once.
        aoR_k / dm_k: (nk, ng, nao) / (nk, nao, nao) SCF-set quantities.
        coulG_bk: (nk, ng) kernels coulG(k2 - kb), or (nb, nk, ng).
        expmikr_bk: (nk, ng) phases exp(-i (k2-kb).r), or (nb, nk, ng).
        kweight: (1/nk) * vol/ngrids.
    Returns (nao, nao), or (nb, nao, nao) for a batch of band k-points.
    """
    one = aoRb.dim() == 2
    ao1 = aoRb[None] if one else aoRb
    cG = coulG_bk[None] if one else coulG_bk
    ph = expmikr_bk[None] if one else expmikr_bk
    vk = _k_sum(ao1.to(aoR_k.dtype), aoR_k.shape[0], lambda k2: aoR_k[k2].T,
                lambda k2: dm_k[k2] @ aoR_k[k2].T.conj(),
                lambda k2: (cG[:, k2], ph[:, k2]), mesh, kweight, chunk)
    return vk[0] if one else vk


def get_k_kpts_occ(aoR_k, mo_w_k, coulG_pairs, expmikr, mesh, weight,
                   chunk: int = 16):
    """Exchange at all k via occupied-MO pair densities (the reference's
    tagged-DM fast path, pyscf/pbc/df/fft_jk.py:235-259): per (k1, k2)
    the FFT batch is (nao x nocc) instead of (nao x nao).

    Args:
        mo_w_k: (nk, ng, nocc) occupied Bloch MOs on the grid, each
            column scaled by sqrt(occ) — equals K[dm] for
            dm_k = (C_k * occ_k) C_k^H.
    """
    ao1, kernel = _pair_kernels(aoR_k, coulG_pairs, expmikr, None)
    return _k_sum(ao1, aoR_k.shape[0], lambda k2: mo_w_k[k2].T,
                  lambda k2: mo_w_k[k2].T.conj(), kernel, mesh, weight, chunk)

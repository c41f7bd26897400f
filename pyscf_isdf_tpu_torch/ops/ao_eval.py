"""Crystalline AO collocation on real-space grids (dense torch version).

Evaluates the periodic AOs

    Phi_mu^k(r_g) = sum_T e^{i k.T} phi_mu(r_g - R_mu - T)

on the uniform FFT grid (functional spec per the reference C kernel
pyscf/lib/pbc/grid_ao.c:512-680 driven by pyscf/pbc/gto/eval_gto.py:31-165).
:func:`eval_ao` sums every image for every shell at Gamma; the production
path there is the image-culled kernel of
:mod:`pyscf_isdf_tpu_torch.ops.cuda_ao`. The Bloch sums at k-points are
:func:`eval_ao_kpts`, which keeps per shell the images that can reach the
grid (the port of the reference's ``eval_ao(kpt=)`` and
``eval_ao_numpy(kpt=)``). Gradients (GGA) are spectral:
``grad aoR = ifft(iG * fft(aoR))``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch.ops.solid_harmonics import solid_harmonics


@dataclass(frozen=True, eq=False)
class PackedBasis:
    """Shells grouped by l, padded to common primitive/contraction counts.

    All arrays are host numpy. ``col_index`` maps the per-l blocks' columns
    into the cell's AO ordering (shells in cell order, contraction-major
    within a shell, then m); padding columns are -1.
    """

    ls: tuple                   # distinct angular momenta present
    centers: dict               # l -> (ns, 3) shell centers
    exps: dict                  # l -> (ns, P) padded exponents
    coeffs: dict                # l -> (ns, P, K) padded coefficients
    col_index: np.ndarray       # (nao_padded,) AO column of each block column
    nao: int

    @classmethod
    def from_cell(cls, cell) -> "PackedBasis":
        groups: dict[int, list] = {}
        offsets = cell.ao_loc
        for ish, sh in enumerate(cell.shells):
            groups.setdefault(sh.l, []).append((ish, sh))
        ls = tuple(sorted(groups))
        centers, exps, coeffs = {}, {}, {}
        cols = []
        for l in ls:
            shells = groups[l]
            P = max(len(sh.exps) for _, sh in shells)
            K = max(sh.nctr for _, sh in shells)
            ns = len(shells)
            ctr = np.zeros((ns, 3))
            es = np.ones((ns, P))
            cs = np.zeros((ns, P, K))
            for i, (ish, sh) in enumerate(shells):
                ctr[i] = cell.coords[sh.atom]
                es[i, : len(sh.exps)] = sh.exps
                cs[i, : len(sh.exps), : sh.nctr] = sh.coeffs
                base = offsets[ish]
                for k in range(K):
                    for m in range(2 * l + 1):
                        cols.append(base + k * (2 * l + 1) + m
                                    if k < sh.nctr else -1)
            centers[l], exps[l], coeffs[l] = ctr, es, cs
        return cls(ls=ls, centers=centers, exps=exps, coeffs=coeffs,
                   col_index=np.array(cols, dtype=np.int64), nao=cell.nao)

    def inverse_columns(self) -> np.ndarray:
        """(nao,) block column of each AO: ``blocks[:, inv]`` is aoR."""
        keep = self.col_index >= 0
        inv = np.zeros(self.nao, dtype=np.int64)
        inv[self.col_index[keep]] = np.nonzero(keep)[0]
        return inv


def _eval_block(packed: PackedBasis, images, coords, img_chunk: int = 32):
    """AO values for one grid block: (nb, nao_padded) in packed order."""
    nimg = images.shape[0]
    npad = (-nimg) % img_chunk
    # pad with far-away dummy images (contribute exp(-large) = 0)
    imgs = torch.cat([images, torch.full((npad, 3), 1e6, dtype=images.dtype,
                                         device=images.device)])
    blocks = []
    for l in packed.ls:
        kw = dict(dtype=coords.dtype, device=coords.device)
        ctr = torch.as_tensor(packed.centers[l], **kw)                # (ns,3)
        es = torch.as_tensor(packed.exps[l], **kw)                    # (ns,P)
        cs = torch.as_tensor(packed.coeffs[l], **kw)                  # (ns,P,K)
        ns, K = es.shape[0], cs.shape[2]
        acc = torch.zeros((ns, coords.shape[0], K, 2 * l + 1), **kw)
        for i0 in range(0, imgs.shape[0], img_chunk):
            T = imgs[i0:i0 + img_chunk]                                # (nt,3)
            d = (coords[None, :, None, :] - ctr[:, None, None, :]
                 - T[None, None, :, :])                                # (ns,nb,nt,3)
            r2 = (d * d).sum(-1)
            g = torch.exp(-es[:, None, None, :] * r2[..., None])       # (ns,nb,nt,P)
            ang = solid_harmonics(l, d, torch)                         # (ns,nb,nt,M)
            acc += torch.einsum("sntp,spk,sntm->snkm", g, cs, ang)
        blocks.append(acc.permute(1, 0, 2, 3).reshape(coords.shape[0], -1))
    return torch.cat(blocks, dim=1)


def eval_ao(packed: PackedBasis, coords, images, block_size: int = 8192):
    """Evaluate aoR at every grid point, summing every image.

    Args:
        packed: PackedBasis of the cell.
        coords: (ngrids, 3) grid coordinates tensor (sets device and dtype).
        images: (nimg, 3) lattice translation vectors tensor.
        block_size: grid points per block (memory knob).

    Returns:
        (ngrids, nao) AO values in the cell's AO ordering.
    """
    out = torch.cat([_eval_block(packed, images, coords[g0:g0 + block_size])
                     for g0 in range(0, coords.shape[0], block_size)])
    return out[:, torch.as_tensor(packed.inverse_columns(),
                                  device=coords.device)]


def eval_ao_kpts(cell, kpts, coords=None, device=None, img_chunk: int = 32):
    """Bloch AOs at every k-point: (nk, ngrids, nao) complex128.

    The build-time collocation of the k-point SCF, on ``device`` in
    float64. Per shell it keeps the lattice images whose shifted centre
    lies within the shell's cutoff radius plus the grid's radius of the
    grid centre (the reference's ``eval_ao_numpy`` pruning), and sums them
    with the phases e^{i k.T} of every k at once.
    """
    from pyscf_isdf_tpu_torch.device import resolve_device

    device = resolve_device(device)
    if coords is None:
        coords = cell.uniform_grid()
    kpts = np.reshape(np.asarray(kpts, dtype=np.float64), (-1, 3))
    images = cell.lattice_images()
    center = coords.mean(axis=0)
    grid_rad = np.sqrt(((coords - center) ** 2).sum(axis=1).max())
    f64 = dict(dtype=torch.float64, device=device)
    r = torch.as_tensor(coords, **f64)
    kt = torch.as_tensor(kpts, **f64)
    ng = coords.shape[0]
    out = torch.empty((len(kpts), ng, cell.nao), dtype=torch.complex128,
                      device=device)
    ao_loc = cell.ao_loc
    for ish, sh in enumerate(cell.shells):
        A = cell.coords[sh.atom]
        dist = np.linalg.norm(A + images - center, axis=1)
        imgs = torch.as_tensor(images[dist <= shell_rcut(sh) + grid_rad], **f64)
        es = torch.as_tensor(sh.exps, **f64)
        cs = torch.as_tensor(sh.coeffs, **f64)
        acc = torch.zeros((len(kpts), ng, sh.nctr, 2 * sh.l + 1),
                          dtype=torch.complex128, device=device)
        for i0 in range(0, imgs.shape[0], img_chunk):
            T = imgs[i0:i0 + img_chunk]                                # (nt,3)
            d = r[:, None, :] - torch.as_tensor(A, **f64) - T[None]    # (ng,nt,3)
            r2 = (d * d).sum(-1)
            rad = torch.exp(-es * r2[..., None]) @ cs                  # (ng,nt,K)
            ang = solid_harmonics(sh.l, d, torch)                      # (ng,nt,M)
            ph = torch.exp(1j * (T @ kt.T))                            # (nt,nk)
            acc += torch.einsum("gtk,gtm,tq->qgkm", rad.to(ph.dtype),
                                ang.to(ph.dtype), ph)
        out[:, :, ao_loc[ish]:ao_loc[ish + 1]] = acc.reshape(len(kpts), ng, sh.nao)
    return out


def shell_rcut(sh, precision: float = 1e-10) -> float:
    """Radius beyond which this shell's most diffuse primitive is negligible."""
    i = int(np.argmin(sh.exps))
    a = float(sh.exps[i])
    c = float(np.abs(sh.coeffs[i]).max()) + 1e-300
    r2 = max(np.log(max(c, 1.0) / precision), 5.0) / a
    for _ in range(3):
        val = c * max(r2, 1.0) ** (sh.l / 2 + 1)
        r2 = max(np.log(max(val, 1e-300) / precision), 5.0) / a
    return float(np.sqrt(r2))


def ao_gradient_fft(aoR, mesh, Gv):
    """Spectral gradient of gridded periodic functions: (3, ngrids, nao).

    grad f = ifft(i G fft(f)); exact up to aliasing for band-limited aoR.
    """
    ng, nao = aoR.shape
    fG = torch.fft.fftn(aoR.reshape(*mesh, nao), dim=(0, 1, 2))
    iG = (1j * Gv.T).reshape(3, *mesh)
    out = torch.fft.ifftn(fG[None] * iG[..., None], dim=(1, 2, 3))
    out = out.reshape(3, ng, nao)
    return out if aoR.is_complex() else out.real


def ao_gradient_fft_k(aoR_k, mesh, Gv, kpt, coords):
    """Spectral gradient of Bloch AOs at k: (3, ngrids, nao) complex.

    phi^k = e^{ik.r} u with u periodic; grad phi^k =
    e^{ik.r} ifft(i(G+k) fft(u)).
    """
    ng, nao = aoR_k.shape
    phase = torch.exp(-1j * (coords @ kpt))                     # (ng,)
    u = aoR_k * phase[:, None]
    uG = torch.fft.fftn(u.reshape(*mesh, nao), dim=(0, 1, 2))
    iGk = (1j * (Gv + kpt[None, :]).T).reshape(3, *mesh)
    du = torch.fft.ifftn(uG[None] * iGk[..., None], dim=(1, 2, 3)).reshape(3, ng, nao)
    return du * phase.conj()[None, :, None]

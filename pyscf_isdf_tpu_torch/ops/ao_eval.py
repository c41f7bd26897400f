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


def _eval_block(packed: PackedBasis, images, coords, kpt=None,
                img_chunk: int = 32):
    """AO values for one grid block: (nb, nao_padded) in packed order,
    complex with the image phases e^{i kpt.T} when ``kpt`` is given."""
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
        acc = torch.zeros((ns, coords.shape[0], K, 2 * l + 1),
                          dtype=coords.dtype if kpt is None else torch.complex128,
                          device=coords.device)
        for i0 in range(0, imgs.shape[0], img_chunk):
            T = imgs[i0:i0 + img_chunk]                                # (nt,3)
            d = (coords[None, :, None, :] - ctr[:, None, None, :]
                 - T[None, None, :, :])                                # (ns,nb,nt,3)
            r2 = (d * d).sum(-1)
            g = torch.exp(-es[:, None, None, :] * r2[..., None])       # (ns,nb,nt,P)
            ang = solid_harmonics(l, d, torch)                         # (ns,nb,nt,M)
            if kpt is None:
                acc = acc + torch.einsum("sntp,spk,sntm->snkm", g, cs, ang)
            else:
                ph = torch.exp(1j * (T @ kpt))                         # (nt,)
                acc = acc + torch.einsum("sntp,spk,sntm,t->snkm", g.to(ph.dtype),
                                         cs.to(ph.dtype), ang.to(ph.dtype), ph)
        blocks.append(acc.permute(1, 0, 2, 3).reshape(coords.shape[0], -1))
    return torch.cat(blocks, dim=1)


def eval_ao(packed: PackedBasis, coords, images, kpt=None,
            block_size: int = 8192):
    """Evaluate aoR at every grid point, summing every image.

    Args:
        packed: PackedBasis of the cell.
        coords: (ngrids, 3) grid coordinates tensor (sets device and dtype).
        images: (nimg, 3) lattice translation vectors tensor.
        kpt: optional (3,) k-point tensor: complex Bloch AOs with the
            phases e^{i k.T}.
        block_size: grid points per block (memory knob).

    Returns:
        (ngrids, nao) AO values in the cell's AO ordering. Every operation
        is differentiable in ``coords`` (forward mode included).
    """
    out = torch.cat([_eval_block(packed, images, coords[g0:g0 + block_size], kpt)
                     for g0 in range(0, coords.shape[0], block_size)])
    return out[:, torch.as_tensor(packed.inverse_columns(),
                                  device=coords.device)]


def _harmonic_grad(l: int, d):
    """Gradient of the real solid harmonics S_lm at displacements d (...,
    3): (3, ..., 2l+1), term by term from their monomial expansion."""
    from pyscf_isdf_tpu_torch.ops.ft_ao import _monos

    monos, C = _monos(l)                                     # C (2l+1, nmono)
    if l == 0:
        return torch.zeros((3,) + d.shape[:-1] + (1,), dtype=d.dtype,
                           device=d.device)
    pw = [[torch.ones_like(d[..., x])] for x in range(3)]
    for x in range(3):
        for _ in range(l):
            pw[x].append(pw[x][-1] * d[..., x])
    Ct = torch.as_tensor(C.T, dtype=d.dtype, device=d.device)    # (nmono, M)
    out = []
    for x in range(3):
        terms = []
        for al in monos:
            if al[x] == 0:
                terms.append(torch.zeros_like(d[..., 0]))
                continue
            t = al[x] * pw[x][al[x] - 1]
            for y in range(3):
                if y != x:
                    t = t * pw[y][al[y]]
            terms.append(t)
        out.append(torch.stack(terms, -1) @ Ct)
    return torch.stack(out)


def _reaching_images(packed, l, c, imgs, drop):
    """Indices of the images through which some shell of angular momentum
    l reaches a point of the block ``c`` with a term of at least ``drop``:
    max_p |c_p| (1 + l + 2 a_p) exp(-a_p d_min^2) max(1, d_max)^(l+1) over
    the block's bounding sphere bounds the value and the gradient."""
    ctr = torch.as_tensor(packed.centers[l], dtype=c.dtype, device=c.device)
    es = torch.as_tensor(packed.exps[l], dtype=c.dtype, device=c.device)
    cmax = torch.as_tensor(np.abs(packed.coeffs[l]).max(axis=2), dtype=c.dtype,
                           device=c.device)                       # (ns, P)
    mid = 0.5 * (c.max(0).values + c.min(0).values)
    rad = float(torch.linalg.norm(c - mid, dim=1).max())
    dist = torch.linalg.norm(mid - ctr[:, None, :] - imgs[None], dim=-1)   # (ns, nt)
    dmin = torch.clamp(dist - rad, min=0.0)
    dfar = torch.clamp(dist + rad, min=1.0)
    grow = (l + 1) * torch.log(dfar)
    logb = torch.log(cmax * (1.0 + l + 2.0 * es) + 1e-300)[:, None, :] \
        - es[:, None, :] * (dmin * dmin)[..., None] + grow[..., None]
    return torch.nonzero((logb >= np.log(drop)).any(dim=2).any(dim=0)).squeeze(1)


GRAD_DROP = 1e-17   # bound on each term eval_ao_deriv1 skips


def eval_ao_deriv1(packed: PackedBasis, coords, images, kpt=None,
                   block_size: int = 1024, img_chunk: int = 32,
                   values: bool = True):
    """AO values and their spatial gradients at every point:
    ((ngrids, nao), (3, ngrids, nao)), complex with the image phases
    e^{i k.T} at a k-point ``kpt``; with ``values=False`` the values are
    not summed and None stands in their place.

    The terms of :func:`eval_ao` and their exact derivatives:
    grad [S_lm(d) e^{-a d^2}] = (grad S_lm(d) - 2 a d S_lm(d)) e^{-a d^2},
    the harmonic's gradient from its monomial expansion. Per block of
    points and l, the images whose every term (value or gradient) is
    below :data:`GRAD_DROP` over the block are skipped.
    """
    kw = dict(dtype=coords.dtype, device=coords.device)
    odt = coords.dtype if kpt is None else torch.complex128
    vals, grads = [], []
    for g0 in range(0, coords.shape[0], block_size):
        c = coords[g0:g0 + block_size]
        nb = c.shape[0]
        bv, bg = [], []
        for l in packed.ls:
            ctr = torch.as_tensor(packed.centers[l], **kw)
            es = torch.as_tensor(packed.exps[l], **kw)
            cs = torch.as_tensor(packed.coeffs[l], **kw)
            ns, K, M = es.shape[0], cs.shape[2], 2 * l + 1
            acc = torch.zeros((ns, nb, K, M), dtype=odt, device=c.device) if values else None
            gacc = torch.zeros((3, ns, nb, K, M), dtype=odt, device=c.device)
            near = images[_reaching_images(packed, l, c, images, GRAD_DROP)]
            for i0 in range(0, near.shape[0], img_chunk):
                T = near[i0:i0 + img_chunk]
                d = (c[None, :, None, :] - ctr[:, None, None, :]
                     - T[None, None, :, :])                            # (ns,nb,nt,3)
                r2 = (d * d).sum(-1)
                g = torch.exp(-es[:, None, None, :] * r2[..., None])   # (ns,nb,nt,P)
                rad = torch.einsum("sntp,spk->sntk", g, cs)
                drad = torch.einsum("sntp,spk->sntk", g * (-2.0 * es[:, None, None, :]), cs)
                ang = solid_harmonics(l, d, torch)                     # (ns,nb,nt,M)
                dang = _harmonic_grad(l, d)                            # (3,ns,nb,nt,M)
                if kpt is not None:
                    ph = torch.exp(1j * (T @ kpt))[None, None, :, None]  # (nt,)
                    rad, drad = rad.to(odt) * ph, drad.to(odt) * ph
                    d, ang, dang = d.to(odt), ang.to(odt), dang.to(odt)
                if values:
                    acc = acc + torch.einsum("sntk,sntm->snkm", rad, ang)
                # grad S_lm e^{-a d^2} + (-2 a) d S_lm e^{-a d^2}
                gacc = gacc + torch.einsum("sntk,xsntm->xsnkm", rad, dang) \
                    + torch.einsum("sntk,sntx,sntm->xsnkm", drad, d, ang)
            if values:
                bv.append(acc.permute(1, 0, 2, 3).reshape(nb, -1))
            bg.append(gacc.permute(0, 2, 1, 3, 4).reshape(3, nb, -1))
        if values:
            vals.append(torch.cat(bv, dim=1))
        grads.append(torch.cat(bg, dim=2))
    inv = torch.as_tensor(packed.inverse_columns(), device=coords.device)
    return (torch.cat(vals)[:, inv] if values else None,
            torch.cat(grads, dim=1)[:, :, inv])


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

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
``grad aoR = ifft(iG * fft(aoR))``. :func:`eval_ao_positions` is aoR as a
differentiable function of the atom positions, grid points and images
(the forces and the stress tensor), its backward the analytic AO
derivatives of :func:`eval_ao_deriv1`'s terms.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

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
    atoms: dict                 # l -> (ns,) atom index of each shell
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
        centers, atoms, exps, coeffs = {}, {}, {}, {}
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
            atoms[l] = np.array([sh.atom for _, sh in shells], dtype=np.int64)
        return cls(ls=ls, centers=centers, atoms=atoms, exps=exps, coeffs=coeffs,
                   col_index=np.array(cols, dtype=np.int64), nao=cell.nao)

    def inverse_columns(self) -> np.ndarray:
        """(nao,) block column of each AO: ``blocks[:, inv]`` is aoR."""
        keep = self.col_index >= 0
        inv = np.zeros(self.nao, dtype=np.int64)
        inv[self.col_index[keep]] = np.nonzero(keep)[0]
        return inv

    def ao_atoms(self) -> np.ndarray:
        """(nao,) atom index of each AO."""
        per_col = np.concatenate([
            np.repeat(self.atoms[l], self.coeffs[l].shape[2] * (2 * l + 1))
            for l in self.ls])
        out = np.zeros(self.nao, dtype=np.int64)
        keep = self.col_index >= 0
        out[self.col_index[keep]] = per_col[keep]
        return out

    def centers_at(self, positions: torch.Tensor) -> dict:
        """l -> (ns, 3) shell centers gathered from atom ``positions``
        (natm, 3), differentiable in them."""
        return {l: positions[torch.as_tensor(self.atoms[l], device=positions.device)]
                for l in self.ls}


def _eval_block(packed: PackedBasis, images, coords, kpt=None,
                img_chunk: int = 32, centers=None, drop=None):
    """AO values for one grid block: (nb, nao_padded) in packed order;
    at a k-point ``kpt`` (3,) complex with the image phases e^{i kpt.T},
    and (nk, nb, nao_padded) for a stack of k-points (nk, 3), every k from
    one evaluation of the Gaussians. ``centers`` (l -> (ns, 3) tensor)
    replaces the cell's shell centers. With ``drop`` the images whose every
    term is below it over the block are skipped (:func:`_reaching_images`)."""
    kb = None if kpt is None else kpt.reshape(-1, 3)
    nb = coords.shape[0]
    blocks = []
    for l in packed.ls:
        kw = dict(dtype=coords.dtype, device=coords.device)
        ctr = (torch.as_tensor(packed.centers[l], **kw) if centers is None
               else centers[l])                                       # (ns,3)
        near = images if drop is None else \
            images[_reaching_images(packed, l, coords, images, drop, ctr)]
        npad = (-near.shape[0]) % img_chunk
        # pad with far-away dummy images (contribute exp(-large) = 0)
        imgs = torch.cat([near, torch.full((npad, 3), 1e6, dtype=images.dtype,
                                           device=images.device)])
        es = torch.as_tensor(packed.exps[l], **kw)                    # (ns,P)
        cs = torch.as_tensor(packed.coeffs[l], **kw)                  # (ns,P,K)
        ns, K = es.shape[0], cs.shape[2]
        shape = (ns, nb, K, 2 * l + 1) if kb is None else (kb.shape[0], ns, nb, K, 2 * l + 1)
        acc = torch.zeros(shape, dtype=coords.dtype if kb is None else torch.complex128,
                          device=coords.device)
        for i0 in range(0, imgs.shape[0], img_chunk):
            T = imgs[i0:i0 + img_chunk]                                # (nt,3)
            d = (coords[None, :, None, :] - ctr[:, None, None, :]
                 - T[None, None, :, :])                                # (ns,nb,nt,3)
            r2 = (d * d).sum(-1)
            g = torch.exp(-es[:, None, None, :] * r2[..., None])       # (ns,nb,nt,P)
            ang = solid_harmonics(l, d, torch)                         # (ns,nb,nt,M)
            if kb is None:
                acc = acc + torch.einsum("sntp,spk,sntm->snkm", g, cs, ang)
            else:
                ph = torch.exp(1j * (T @ kb.T))                        # (nt,nk)
                rad = torch.einsum("sntp,spk->sntk", g, cs)
                acc = acc + torch.einsum("sntk,sntm,tq->qsnkm", rad.to(ph.dtype),
                                         ang.to(ph.dtype), ph)
        blocks.append(acc.transpose(-4, -3).reshape(acc.shape[:-4] + (nb, -1)))
    out = torch.cat(blocks, dim=-1)
    return out[0] if kpt is not None and kpt.dim() == 1 else out


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


def _reaching_images(packed, l, c, imgs, drop, ctr=None):
    """Indices of the images through which some shell of angular momentum
    l reaches a point of the block ``c`` with a term of at least ``drop``:
    max_p |c_p| (1 + l + 2 a_p) exp(-a_p d_min^2) max(1, d_max)^(l+1) over
    the block's bounding sphere bounds the value and the gradient (shell
    centers ``ctr``, the cell's by default)."""
    if ctr is None:
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
                   values: bool = True, centers=None):
    """AO values and their spatial gradients at every point:
    ((ngrids, nao), (3, ngrids, nao)), complex with the image phases
    e^{i k.T} at a k-point ``kpt``; with ``values=False`` the values are
    not summed and None stands in their place.

    The terms of :func:`eval_ao` and their exact derivatives:
    grad [S_lm(d) e^{-a d^2}] = (grad S_lm(d) - 2 a d S_lm(d)) e^{-a d^2},
    the harmonic's gradient from its monomial expansion. Per block of
    points and l, the images whose every term (value or gradient) is
    below :data:`GRAD_DROP` over the block are skipped. ``centers`` (l ->
    (ns, 3) tensor) replaces the cell's shell centers.
    """
    kw = dict(dtype=coords.dtype, device=coords.device)
    odt = coords.dtype if kpt is None else torch.complex128
    vals, grads = [], []
    for g0 in range(0, coords.shape[0], block_size):
        c = coords[g0:g0 + block_size]
        nb = c.shape[0]
        bv, bg = [], []
        for l in packed.ls:
            ctr = (torch.as_tensor(packed.centers[l], **kw) if centers is None
                   else centers[l])
            es = torch.as_tensor(packed.exps[l], **kw)
            cs = torch.as_tensor(packed.coeffs[l], **kw)
            ns, K, M = es.shape[0], cs.shape[2], 2 * l + 1
            acc = torch.zeros((ns, nb, K, M), dtype=odt, device=c.device) if values else None
            gacc = torch.zeros((3, ns, nb, K, M), dtype=odt, device=c.device)
            near = images[_reaching_images(packed, l, c, images, GRAD_DROP, ctr)]
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


def _k1_positions(cell, positions, coords):
    """Gamma aoR of ``cell`` with its atoms at ``positions`` on ``coords``
    through the collocation kernel K1 (:mod:`~pyscf_isdf_tpu_torch.ops.cuda_ao`):
    the brick plan when ``coords`` is the cell's uniform grid, the slab plan
    of the explicit points otherwise."""
    from pyscf_isdf_tpu_torch.ops.cuda_ao import make_ao_evaluator

    moved = replace(cell, coords=positions.detach().cpu().numpy())
    pts = coords.detach().cpu().numpy()
    grid = moved.uniform_grid()
    on_grid = pts.shape == grid.shape and np.allclose(pts, grid, rtol=0, atol=1e-12)
    return make_ao_evaluator(moved, coords=None if on_grid else pts,
                             dtype=coords.dtype, device=coords.device)()


class _AOPositions(torch.autograd.Function):
    """aoR(positions, coords, images); see :func:`eval_ao_positions`."""

    @staticmethod
    def forward(ctx, positions, coords, images, packed, kpt, cell, block_size, timer):
        centers = packed.centers_at(positions)
        if coords.device.type == "cpu":
            out = torch.cat([_eval_block(packed, images, coords[g0:g0 + block_size],
                                         kpt, centers=centers, drop=GRAD_DROP)
                             for g0 in range(0, coords.shape[0], block_size)], dim=-2)
            out = out[..., torch.as_tensor(packed.inverse_columns())]
        elif cell is None:
            raise ValueError("eval_ao_positions on the GPU needs cell= (its "
                             "collocation plan is built from the cell)")
        elif kpt is None:
            out = _k1_positions(cell, positions, coords)
        else:
            moved = replace(cell, coords=positions.detach().cpu().numpy())
            out = eval_ao_kpts(moved, kpt.detach().cpu().numpy().reshape(-1, 3),
                               coords=coords.detach().cpu().numpy(), device=coords.device)
            out = out[0] if kpt.dim() == 1 else out
        ctx.save_for_backward(positions, coords, images)
        ctx.packed, ctx.kpt = packed, None if kpt is None else kpt.detach()
        ctx.timer = timer
        return out

    @staticmethod
    def backward(ctx, gout):
        positions, coords, images = ctx.saved_tensors
        need_pos, need_coords, need_imgs = ctx.needs_input_grad[:3]
        centers = ctx.packed.centers_at(positions)
        with ctx.timer("ao_vjp"):
            if need_coords or need_imgs or ctx.kpt is not None:
                g_pos, g_coords, g_imgs = _ao_vjp_images(ctx.packed, coords, images,
                                                         centers, ctx.kpt, gout)
            else:
                g_pos, g_coords, g_imgs = _ao_vjp_positions(
                    ctx.packed, coords, images, centers, gout), None, None
        return (g_pos if need_pos else None, g_coords if need_coords else None,
                g_imgs if need_imgs else None, None, None, None, None, None)


VJP_BLOCK = 8192    # grid points per block of the AO-derivative pass


def _ao_vjp_positions(packed, coords, images, centers, gout, block=VJP_BLOCK):
    """dE/dR_A = -sum_g sum_{mu on A} G(g, mu) grad phi_mu(g) for the
    Gamma cotangent G = dE/d aoR, the AO gradients from
    :func:`eval_ao_deriv1` one block of ``block`` points at a time."""
    natm = 1 + max(int(packed.atoms[l].max()) for l in packed.ls)
    g_pos = torch.zeros((natm, 3), dtype=coords.dtype, device=coords.device)
    ao_atom = torch.as_tensor(packed.ao_atoms(), device=coords.device)
    for g0 in range(0, coords.shape[0], block):
        _, d1 = eval_ao_deriv1(packed, coords[g0:g0 + block], images,
                               values=False, centers=centers)      # (3, nb, nao)
        h = (gout[g0:g0 + block][None] * d1).sum(1)                # (3, nao)
        g_pos.index_add_(0, ao_atom, -h.T)
    return g_pos


def _ao_vjp_images(packed, coords, images, centers, kpt, gout, block: int = 1024,
                   img_chunk: int = 32):
    """The cotangent G = dE/d aoR pulled back onto the atom positions, the
    grid points and each lattice image: with d = r - A - T every term
    phi(d_T) of the lattice sum gives Re(conj(G) grad phi(d_T)) to r, and
    its negative to A and to T. At k-points (``kpt`` (3,) or (nk, 3), G
    (nk, ng, nao) then) the terms carry e^{i k.T}, summed over k once per
    image; the phase is held fixed (a strain moves k and T
    contragradiently, so k.T does not change). Returns (g_positions,
    g_coords, g_images)."""
    kw = dict(dtype=coords.dtype, device=coords.device)
    kb = None if kpt is None else kpt.reshape(-1, 3)
    natm = 1 + max(int(packed.atoms[l].max()) for l in packed.ls)
    g_pos = torch.zeros((natm, 3), **kw)
    g_coords = torch.zeros_like(coords)
    g_imgs = torch.zeros_like(images)
    col = torch.as_tensor(packed.col_index, device=coords.device)
    # the cotangent in packed column order, zero on the padding columns,
    # with a leading k axis
    gp = (gout[..., col.clamp(min=0)] * (col >= 0)).reshape(-1, coords.shape[0], col.numel())
    if kb is not None:
        gp = gp.conj()
    for g0 in range(0, coords.shape[0], block):
        c = coords[g0:g0 + block]
        nb = c.shape[0]
        off = 0
        for l in packed.ls:
            ctr = centers[l]
            es = torch.as_tensor(packed.exps[l], **kw)
            cs = torch.as_tensor(packed.coeffs[l], **kw)
            ns, K, M = es.shape[0], cs.shape[2], 2 * l + 1
            gl = gp[:, g0:g0 + block, off:off + ns * K * M].reshape(-1, nb, ns, K, M) \
                .transpose(1, 2)                                       # (nq,ns,nb,K,M)
            off += ns * K * M
            g_ctr = torch.zeros((ns, 3), **kw)
            near = _reaching_images(packed, l, c, images, GRAD_DROP, ctr)
            for i0 in range(0, near.shape[0], img_chunk):
                idx = near[i0:i0 + img_chunk]
                T = images[idx]
                d = (c[None, :, None, :] - ctr[:, None, None, :]
                     - T[None, None, :, :])                            # (ns,nb,nt,3)
                g = torch.exp(-es[:, None, None, :] * (d * d).sum(-1)[..., None])
                rad = torch.einsum("sntp,spk->sntk", g, cs)
                drad = torch.einsum("sntp,spk->sntk", g * (-2.0 * es[:, None, None, :]), cs)
                if kb is None:
                    gr = torch.einsum("snkm,sntk->sntm", gl[0], rad)
                    gd = torch.einsum("snkm,sntk->sntm", gl[0], drad)
                else:
                    # sum_k conj(G_k) e^{i k.T} once per image
                    gph = torch.einsum("qsnkm,tq->sntkm", gl, torch.exp(1j * (T @ kb.T)))
                    gr = torch.einsum("sntkm,sntk->sntm", gph, rad.to(gph.dtype))
                    gd = torch.einsum("sntkm,sntk->sntm", gph, drad.to(gph.dtype))
                ang = solid_harmonics(l, d, torch)
                h = torch.einsum("sntm,xsntm->xsnt", gr, _harmonic_grad(l, d).to(gr.dtype)) \
                    + torch.einsum("sntm,sntx->xsnt", gd * ang, d.to(gd.dtype))
                h = h.real                                             # (3,ns,nb,nt)
                g_coords[g0:g0 + block] += h.sum((1, 3)).T
                g_ctr -= h.sum((2, 3)).T
                g_imgs.index_add_(0, idx, -h.sum((1, 2)).T)
            g_pos.index_add_(0, torch.as_tensor(packed.atoms[l], device=coords.device),
                             g_ctr)
    return g_pos, g_coords, g_imgs


def eval_ao_positions(packed: PackedBasis, coords, images, positions, kpt=None,
                      cell=None, block_size: int = 1024, timer=None):
    """aoR (ngrids, nao) as a differentiable function of the atom
    positions, the grid points and the lattice images (the reference's
    ``eval_ao_positions``: shell centers gathered from ``positions``);
    (nk, ngrids, nao) for a stack of k-points ``kpt`` (nk, 3).

    Forward: on CPU tensors the plain lattice sum over the images in
    ``images`` (:func:`eval_ao`'s, complex with the phases e^{i k.T} at a
    k-point ``kpt``), per block of ``block_size`` points skipping the
    images whose every term is below :data:`GRAD_DROP` there; on CUDA tensors at Gamma the collocation kernel K1
    on a plan built for ``cell`` with its atoms at ``positions`` (which
    takes the images of its own radius), at a k-point the Bloch evaluator
    :func:`eval_ao_kpts` of that cell. ``cell`` is needed on the GPU.

    Backward: the cotangent is contracted with the analytic AO first
    derivatives. At Gamma, when only the positions need a gradient, they
    come from :func:`eval_ao_deriv1` one block of grid points at a time,
    dE/dR_A = -sum_g sum_{mu on A} G grad phi_mu; when the points or the
    images need one too (the strain derivative, where points, images and
    positions all move), and at k-points, the image-resolved terms are
    summed in the same blocks, every k-point at once. ``kpt`` is not
    differentiated. ``timer``
    (a :class:`~pyscf_isdf_tpu_torch.utils.timing.StageTimer`) records the
    backward's pass as 'ao_vjp'.
    """
    from pyscf_isdf_tpu_torch.utils.timing import null_timer

    return _AOPositions.apply(positions, coords, images, packed, kpt, cell, block_size,
                              timer or null_timer)


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

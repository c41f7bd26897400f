"""Image-culled crystalline AO collocation: CUDA kernel K1 and its plain version.

Replaces the TPU Pallas kernel ``_make_kernel`` of
``pyscf_isdf_tpu/ops/pallas_ao.py`` (launched by ``make_ao_evaluator``).
The lattice-image sum  ao_mu(r_g) = sum_T phi_mu(r_g - A_mu - T)  is
irregular: each (shell, grid block) pair sees only the few images whose
translated centre lies within the shell's decay radius. The host planner
:func:`plan_ao_blocks` (unchanged semantics: per-(shell, block) culled
image lists padded to IMAX with a dummy far image at 1e6, and a trip
count) feeds one launch per angular momentum l.

Kernel (``csrc/ao_collocate.cu``): one CTA per (grid block, shell), one
thread per grid point. The CTA loads its own trip count and culled image
list into shared memory (the TPU's scalar prefetch) with the shell's
exponents and coefficients; the image loop accumulates the K(2l+1)
values in registers (instantiated per l and K) and the CTA writes the
transposed (rows, ngrids) layout, so neighbouring threads store
neighbouring addresses. The permutation to (ngrids, nao) AO order is done
outside the kernel. What bounds it on the card is the exponentials:
sum_{s,b} counts[s,b] * NB * P evaluations of exp,
which the culling keeps to the images that matter
(:func:`collocation_work`).

On a CPU tensor :func:`collocate` runs :func:`collocate_plain`, the same
function in plain torch; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.ops import cuda_lib
from pyscf_isdf_tpu_torch.ops.ao_eval import PackedBasis, shell_rcut
from pyscf_isdf_tpu_torch.ops.solid_harmonics import solid_harmonics

MAX_L = 3          # kernel instantiations: l = 0..3
MAX_K = 4          # and 1..4 contractions per shell


@dataclass(frozen=True, eq=False)
class _LPlan:
    l: int
    ns: int
    P: int
    K: int
    centers: np.ndarray     # (ns, 3)
    exps: np.ndarray        # (ns, P)
    coeffs: np.ndarray      # (ns, P, K)
    imgs: np.ndarray        # (ns, nb, 3, IMAX) culled image lists
    counts: np.ndarray      # (ns, nb) int32
    cols: np.ndarray        # (ns*K*(2l+1),) AO column for each output row


def plan_ao_blocks(cell, coords=None, block: int = 512, imax: int | None = None):
    """Host-side planning: pack shells per l and cull images per block."""
    packed = PackedBasis.from_cell(cell)
    if coords is None:
        coords = cell.uniform_grid()
    ng = coords.shape[0]
    nb = -(-ng // block)
    images = cell.lattice_images()

    # block centers and radii
    npad = (-ng) % block
    cpad = np.pad(coords, ((0, npad), (0, 0)), mode="edge")
    cblk = cpad.reshape(nb, block, 3)
    bcent = cblk.mean(axis=1)                                  # (nb, 3)
    brad = np.sqrt(((cblk - bcent[:, None]) ** 2).sum(-1).max(axis=1))

    groups: dict[int, list] = {}
    for ish, sh in enumerate(cell.shells):
        groups.setdefault(sh.l, []).append((ish, sh))

    plans = []
    for l in packed.ls:
        shells = groups[l]
        ns = len(shells)
        P = packed.exps[l].shape[1]
        K = packed.coeffs[l].shape[2]
        M = 2 * l + 1
        rcuts = np.array([shell_rcut(sh) for _, sh in shells])
        # |t - b|^2 = |t|^2 + |b|^2 - 2 t.b with the cross term as a
        # batched GEMM (a broadcast difference array is a large temporary)
        ctr = packed.centers[l]                                # (ns, 3)
        tc = ctr[:, None, :] + images[None, :, :]              # (ns, nimg, 3)
        tnorm = np.einsum("sti,sti->st", tc, tc)               # (ns, nimg)
        bnorm = np.einsum("bi,bi->b", bcent, bcent)            # (nb,)
        cross = np.matmul(bcent, tc.transpose(0, 2, 1))        # (ns, nb, ni)
        d2 = tnorm[:, None, :] + bnorm[None, :, None] - 2.0 * cross
        rmax = rcuts[:, None, None] + brad[None, :, None]
        keep = d2 <= rmax * rmax                               # (ns, nb, nimg)
        counts = keep.sum(axis=2).astype(np.int32)
        cmax = int(counts.max()) if counts.size else 0
        IMAX = imax or max(128, -(-cmax // 128) * 128)
        if cmax > IMAX:
            raise ValueError(f"IMAX={IMAX} < required {cmax}")
        # kept images first in each list: argpartition pulls them into the
        # leading slots, a stable argsort of that slice orders them
        nimg = keep.shape[2]
        width = min(IMAX, nimg)        # cells with few images keep them all
        order = np.argpartition(~keep, width - 1, axis=2)[:, :, :width]
        sub = np.take_along_axis(~keep, order, axis=2)
        order = np.take_along_axis(
            order, np.argsort(sub, axis=2, kind="stable"), axis=2)
        imgs = np.moveaxis(images.T[:, order], 0, 3)   # (ns, nb, width, 3)
        slot = np.arange(width)[None, None, :]
        imgs[slot >= counts[:, :, None]] = 1e6     # dummy far image
        if width < IMAX:               # pad dummy slots up to IMAX
            imgs = np.concatenate(
                [imgs, np.full((ns, nb, IMAX - width, 3), 1e6)], axis=2)
        imgs = np.ascontiguousarray(imgs.transpose(0, 1, 3, 2))
        # output rows (s-major, then k, then m) -> AO columns
        cols = []
        for ish, sh in shells:
            base = cell.ao_loc[ish]
            for k in range(K):
                for m in range(M):
                    cols.append(base + k * M + m if k < sh.nctr else -1)
        plans.append(_LPlan(
            l=l, ns=ns, P=P, K=K,
            centers=packed.centers[l],
            exps=packed.exps[l],
            coeffs=packed.coeffs[l],
            imgs=imgs, counts=counts, cols=np.array(cols, dtype=np.int64),
        ))
    return plans, nb, block


_ANG_FLOPS = {0: 0, 1: 3, 2: 12, 3: 26}   # solid harmonics per point


def collocation_work(plans, block: int) -> tuple[int, int]:
    """(exp evaluations, floating-point operations) of the kernels on this
    plan: per live (shell, block, image, point) 8 flops for the
    displacement and r^2, per primitive one product, one exp (counted as
    one operation) and a K-wide FMA, the harmonics, and a K*M-wide FMA."""
    n_exp = flops = 0
    for p in plans:
        M = 2 * p.l + 1
        pts = int(p.counts.sum()) * block
        n_exp += pts * p.P
        flops += pts * (8 + p.P * (2 + 2 * p.K) + _ANG_FLOPS[p.l] + 2 * p.K * M)
    return n_exp, flops


def _shapes(l, counts, centers, exps, coeffs, coordsT, imgs):
    ns, nb = counts.shape
    P, K, imax = exps.shape[1], coeffs.shape[2], imgs.shape[3]
    ng_p = coordsT.shape[1]
    if (centers.shape != (ns, 3) or exps.shape != (ns, P)
            or coeffs.shape != (ns, P, K) or imgs.shape != (ns, nb, 3, imax)
            or coordsT.shape[0] != 3 or ng_p % nb):
        raise ValueError("inconsistent AO collocation shapes")
    return ns, nb, P, K, imax, ng_p, ng_p // nb


def collocate_plain(l, counts, centers, exps, coeffs, coordsT, imgs,
                    chunk_elems: int = 1 << 24):
    """Plain torch version of the kernel, same signature and result.

    out[(s*K + k)*(2l+1) + m, b*NB + i] = sum_{j < counts[s,b]}
        sum_p coeffs[s,p,k] exp(-exps[s,p] r^2) S_lm(d),
        d = (coordsT[:, b*NB+i] - centers[s]) - imgs[s, b, :, j].
    """
    ns, nb, P, K, imax, ng_p, NB = _shapes(l, counts, centers, exps, coeffs,
                                           coordsT, imgs)
    M = 2 * l + 1
    out = torch.empty((ns, K, M, nb, NB), dtype=coordsT.dtype,
                      device=coordsT.device)
    slot = torch.arange(imax, device=coordsT.device)
    bc = max(1, chunk_elems // (ns * imax * NB * max(P, M, K)))
    for b0 in range(0, nb, bc):
        b1 = min(nb, b0 + bc)
        xyz = coordsT[:, b0 * NB:b1 * NB].reshape(3, b1 - b0, 1, NB)
        T = imgs[:, b0:b1]                                    # (ns, bc, 3, imax)
        d = torch.stack([(xyz[c][None] - centers[:, c, None, None, None])
                         - T[:, :, c, :, None] for c in range(3)], -1)
        r2 = (d * d).sum(-1)                                  # (ns, bc, imax, NB)
        live = (slot < counts[:, b0:b1, None]).to(coordsT.dtype)
        g = torch.exp(-exps[:, None, None, None, :] * r2[..., None])
        rad = torch.einsum("sbjgp,spk->sbjgk", g, coeffs) \
            * live[..., None, None]
        ang = solid_harmonics(l, d, torch)                    # (ns, bc, imax, NB, M)
        out[:, :, :, b0:b1] = torch.einsum("sbjgk,sbjgm->skmbg", rad, ang)
    return out.reshape(ns * K * M, ng_p)


def collocate(l, counts, centers, exps, coeffs, coordsT, imgs):
    """AO rows of one angular momentum: (ns*K*(2l+1), ng_p).

    CPU tensors take :func:`collocate_plain`; CUDA tensors launch the
    kernel (``ao_collocate_f32``/``_f64``) on the current stream.
    """
    if coordsT.device.type == "cpu":
        return collocate_plain(l, counts, centers, exps, coeffs, coordsT, imgs)
    ns, nb, P, K, imax, ng_p, NB = _shapes(l, counts, centers, exps, coeffs,
                                           coordsT, imgs)
    dtype = coordsT.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"AO collocation kernel: unsupported dtype {dtype}")
    for t in (centers, exps, coeffs, coordsT, imgs):
        if t.device != coordsT.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("AO collocation kernel: inputs must be contiguous "
                             f"{dtype} tensors on {coordsT.device}")
    if (counts.device != coordsT.device or counts.dtype != torch.int32
            or not counts.is_contiguous()):
        raise ValueError("AO collocation kernel: counts must be contiguous "
                         "int32 on the same device")
    if not (0 <= l <= MAX_L and 1 <= K <= MAX_K):
        raise NotImplementedError(f"AO collocation kernel: l={l}, K={K}")
    out = torch.empty((ns * K * (2 * l + 1), ng_p), dtype=dtype,
                      device=coordsT.device)
    lib = cuda_lib.load()
    fn = lib.ao_collocate_f64 if dtype == torch.float64 else lib.ao_collocate_f32
    stream = torch.cuda.current_stream(coordsT.device).cuda_stream
    rc = fn(l, K, P, ns, nb, NB, imax, ng_p, counts.data_ptr(),
            centers.data_ptr(), exps.data_ptr(), coeffs.data_ptr(),
            coordsT.data_ptr(), imgs.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(rc, "ao_collocate")
    collocate.launches += 1
    return out


collocate.launches = 0


def make_ao_evaluator(cell, coords=None, block: int = 512,
                      dtype=torch.float64, device=None):
    """Plan once, evaluate many: returns ``fn() -> aoR (ngrids, nao)``.

    Host planning (image culling per block) happens here; the returned
    callable launches one collocation per l on pre-staged tensors. The
    staged per-l inputs are available as ``fn.staged`` (a list of
    argument tuples of :func:`collocate`).
    """
    device = resolve_device(device)
    plans, nb, NB = plan_ao_blocks(cell, coords, block)
    if coords is None:
        coords = cell.uniform_grid()
    ng = coords.shape[0]
    npad = nb * NB - ng
    coordsT = torch.as_tensor(
        np.ascontiguousarray(np.pad(coords, ((0, npad), (0, 0)), mode="edge").T),
        dtype=dtype, device=device)                                  # (3, ng_p)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    staged = [(p.l, torch.as_tensor(p.counts, device=device), dev(p.centers),
               dev(p.exps), dev(p.coeffs), coordsT, dev(p.imgs)) for p in plans]
    cols = np.concatenate([p.cols for p in plans])
    keep = cols >= 0
    inv = np.zeros(cell.nao, dtype=np.int64)
    inv[cols[keep]] = np.nonzero(keep)[0]
    inv_t = torch.as_tensor(inv, device=device)

    def evaluate():
        rows = torch.cat([collocate(*args) for args in staged])
        return rows[inv_t, :ng].T.contiguous()

    evaluate.staged = staged
    evaluate.plans = plans
    evaluate.block = NB
    return evaluate

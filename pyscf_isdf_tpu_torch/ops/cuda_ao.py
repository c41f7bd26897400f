"""Image-culled crystalline AO collocation: CUDA kernel K1 and its plain version.

Replaces the TPU Pallas kernel ``_make_kernel`` of
``pyscf_isdf_tpu/ops/pallas_ao.py`` (launched by ``make_ao_evaluator``).
The lattice-image sum  ao_mu(r_g) = sum_T phi_mu(r_g - A_mu - T)  is
irregular: each (shell, grid block) pair sees only the few images whose
translated centre lies within the shell's decay radius, and of an image
far from the block only the diffuse primitives reach it.

What bounds the kernel on the H100 is FP64 instructions: it has no
tensor-core work, and each ``exp(double)`` is a software sequence of
:data:`EXP_FP64_INSTR` FP64 instructions (counted from SASS by
``tools/k1_exp_probe.cu``) on 64 FP64 lanes per SM. Its time therefore
follows the number of exponentials it evaluates, and the planners decide
that number. Two planners fill the same kernel arguments:

* :func:`plan_ao_bricks`, for the uniform FFT grid (the main path): blocks
  are compact bricks of at most 8x8x8 points (each axis is cut at the
  FFT-order wrap, index ceil(n/2), so no brick spans the cell). Per
  (shell, brick) it keeps the reference's image cull (images within
  rcut + brick radius of the brick centre, rcut the radius where the
  shell's most diffuse term falls below ``rcut_precision``, the
  reference's :data:`RCUT_PRECISION` by default), and then per kept
  image the
  prefix of the shell's primitives, sorted most diffuse first, that
  contains every primitive whose bound over the brick,
  max_k |c_pk| exp(-a_p d_min^2) max(1, r_max)^l, reaches :data:`DROP`
  (d_min, r_max: nearest and farthest distance from the image centre to
  the brick). Since |S_lm(d)| <= |d|^l for l <= 4, every dropped term is
  below DROP = 1e-16 in absolute value at every point of the brick. An
  image with no primitive left leaves the list. It also sets a per-shell
  cut: a point stops at its first primitive with -a r^2 below it, where
  that term and every later one is below DROP.
* :func:`plan_ao_blocks`, for explicit coordinates: the reference's
  semantics unchanged (slabs of ``block`` consecutive points, every
  primitive of every kept image, no cut).

Either plan gives, per (shell, block), the trip count and the image list
padded to IMAX with a dummy far image at 1e6, the primitive count of each
listed image, the shell's cut, and per block slot the point's coordinates
and its flat grid index (-1 for a slot with no point).
:func:`collocation_work` counts the work a plan lets the kernel evaluate
and the work the inputs need; the bound on the card is the second.

Kernel (``csrc/ao_collocate.cu``): one CTA per (block, shell); the CTA
loads its image list and primitive counts into shared memory, so every
warp walks the same trip counts and a primitive the planner drops costs
no divergence. The K(2l+1) sums live in registers (instantiated per l and
K) and each thread stores them at its point's flat grid index in the
transposed (rows, ngrids) layout; the permutation to (ngrids, nao) AO
order is one gather outside.

On a CPU tensor :func:`collocate` runs :func:`collocate_plain`, the same
function in plain torch; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.ops import cuda_lib
from pyscf_isdf_tpu_torch.ops.ao_eval import PackedBasis, shell_rcut
from pyscf_isdf_tpu_torch.ops.solid_harmonics import solid_harmonics

MAX_L = 4          # kernel instantiations: l = 0..4
MAX_K = 4          # and 1..4 contractions per shell
BRICK = 8          # brick edge (points) of the uniform-grid planner
DROP = 1e-16       # bound on each primitive term the brick planner drops
# the reference's image radius: where a shell's most diffuse term falls
# below this. At 1e-10 the diffuse l = 4 auxiliary functions of Gaussian
# density fitting miss their full image sum by 2.2e-12, and the AOs on a
# Becke cloud by 2.8e-12: those two take the tighter radius
RCUT_PRECISION = 1e-10
TIGHT_RCUT_PRECISION = 1e-11

# FP64 instructions of one exp(double) on sm_90a (nvcc 12.8) on its path for
# arguments in [-708, 0]: 14 DFMA and 1 DADD (SASS, tools/k1_exp_probe.cu)
EXP_FP64_INSTR = 15
# per (point, image) pair: displacement (3) and r^2 (3), the harmonics
_ANG_INSTR = {0: 0, 1: 3, 2: 12, 3: 26, 4: 38}


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
    nprim: np.ndarray       # (ns, nb, IMAX) int32 primitives of each listed image
    cuts: np.ndarray        # (ns,) least -a r^2 a point evaluates (-inf: all)
    cols: np.ndarray        # (ns*K*(2l+1),) AO column for each output row


def _block_geometry(coords, dest):
    """Centre and radius of each block over its points (dest >= 0)."""
    valid = dest >= 0
    pts = coords[np.where(valid, dest, dest[:, :1])]           # (nb, NB, 3)
    bcent = (pts * valid[..., None]).sum(axis=1) / valid.sum(axis=1)[:, None]
    brad = np.sqrt(((pts - bcent[:, None]) ** 2).sum(-1).max(axis=1))
    return bcent, brad


def _plan_l(cell, packed, l, shells, images, bcent, brad, imax, drop,
            rcut_precision=RCUT_PRECISION):
    """Cull images per (shell, block); with ``drop`` also primitives."""
    nb = bcent.shape[0]
    ns = len(shells)
    centers, exps, coeffs = packed.centers[l], packed.exps[l], packed.coeffs[l]
    P, K = exps.shape[1], coeffs.shape[2]
    M = 2 * l + 1
    rcuts = np.array([shell_rcut(sh, rcut_precision) for _, sh in shells])
    # |t - b|^2 = |t|^2 + |b|^2 - 2 t.b with the cross term as a
    # batched GEMM (a broadcast difference array is a large temporary)
    tc = centers[:, None, :] + images[None, :, :]              # (ns, nimg, 3)
    tnorm = np.einsum("sti,sti->st", tc, tc)                   # (ns, nimg)
    bnorm = np.einsum("bi,bi->b", bcent, bcent)                # (nb,)
    cross = np.matmul(bcent, tc.transpose(0, 2, 1))            # (ns, nb, ni)
    d2 = tnorm[:, None, :] + bnorm[None, :, None] - 2.0 * cross
    rmax = rcuts[:, None, None] + brad[None, :, None]
    keep = d2 <= rmax * rmax                                   # (ns, nb, nimg)
    nprim = keep * np.int32(P)
    cuts = np.full(ns, -np.inf)
    if drop is not None:
        # most diffuse first, padding primitives (zero coefficients) last
        cmax = np.abs(coeffs).max(axis=2)                      # (ns, P)
        perm = np.argsort(np.where(cmax > 0, exps, np.inf), axis=1, kind="stable")
        exps = np.take_along_axis(exps, perm, axis=1)
        coeffs = np.take_along_axis(coeffs, perm[:, :, None], axis=1)
        cmax = np.take_along_axis(cmax, perm, axis=1)
        s, b, t = np.nonzero(keep)
        dist = np.sqrt(np.maximum(d2[s, b, t], 0.0))
        dmin = np.maximum(dist - brad[b], 0.0)
        rfar = np.maximum(dist + brad[b], 1.0)
        bound = cmax[s] * np.exp(-exps[s] * (dmin * dmin)[:, None]) \
            * (rfar ** l)[:, None]                             # (nkept, P)
        surv = bound >= drop
        reach = surv.any(axis=1)
        nprim[s, b, t] = np.where(reach, P - np.argmax(surv[:, ::-1], axis=1), 0)
        keep = nprim > 0
        s, b, t = s[reach], b[reach], t[reach]     # kept, in (s, b, t) order
        # per-point cut: with r <= R (the farthest brick point of any kept
        # image), c_pk exp(-a_p r^2) S_lm < cmax_s exp(cut) R^l = drop when
        # -a_p r^2 < cut, and so is every later (tighter) primitive
        if drop > 0:
            rfar_s = np.ones(ns)
            np.maximum.at(rfar_s, s, rfar[reach])
            cuts = np.log(drop) - np.log(cmax.max(axis=1)) - l * np.log(rfar_s)
    counts = keep.sum(axis=2).astype(np.int32)
    cmax_img = int(counts.max()) if counts.size else 0
    IMAX = imax or max(128, -(-cmax_img // 128) * 128)
    if cmax_img > IMAX:
        raise ValueError(f"IMAX={IMAX} < required {cmax_img}")
    nimg = keep.shape[2]
    width = min(IMAX, nimg)        # cells with few images keep them all
    wl = min(max(cmax_img, 1), width)              # slots any list uses
    if drop is None:
        # the reference's order: argpartition pulls the kept images into
        # the leading slots, a stable argsort of that slice orders them
        order = np.argpartition(~keep, width - 1, axis=2)[:, :, :width]
        sub = np.take_along_axis(~keep, order, axis=2)
        order = np.take_along_axis(
            order, np.argsort(sub, axis=2, kind="stable")[:, :, :wl], axis=2)
    else:
        # kept images in index order: a triple's slot is its rank in its list
        order = np.zeros((ns, nb, wl), dtype=np.int64)
        first = np.cumsum(counts.ravel()) - counts.ravel()
        order[s, b, np.arange(s.size) - first[s * nb + b]] = t
    live = np.arange(wl)[None, None, :] < counts[:, :, None]
    imgs = np.full((ns, nb, 3, IMAX), 1e6)         # dummy far image
    imgs[..., :wl] = np.where(live[:, :, None], images.T[:, order]
                              .transpose(1, 2, 0, 3), 1e6)
    prims = np.zeros((ns, nb, IMAX), dtype=np.int32)
    prims[..., :wl] = np.where(live, np.take_along_axis(nprim, order, axis=2), 0)
    # output rows (s-major, then k, then m) -> AO columns
    cols = []
    for ish, sh in shells:
        base = cell.ao_loc[ish]
        for k in range(K):
            for m in range(M):
                cols.append(base + k * M + m if k < sh.nctr else -1)
    return _LPlan(l=l, ns=ns, P=P, K=K, centers=centers, exps=exps,
                  coeffs=coeffs, imgs=imgs, counts=counts, nprim=prims,
                  cuts=cuts, cols=np.array(cols, dtype=np.int64))


def _plans(cell, coords, dest, imax, drop, rcut_precision=RCUT_PRECISION):
    packed = PackedBasis.from_cell(cell)
    images = cell.lattice_images()
    bcent, brad = _block_geometry(coords, dest)
    groups: dict[int, list] = {}
    for ish, sh in enumerate(cell.shells):
        groups.setdefault(sh.l, []).append((ish, sh))
    return [_plan_l(cell, packed, l, groups[l], images, bcent, brad, imax, drop,
                    rcut_precision) for l in packed.ls]


def slab_slots(ng: int, block: int = 512) -> np.ndarray:
    """(nb, block) slots of the reference's blocks: consecutive flat
    indices, -1 past the last point."""
    nb = -(-ng // block)
    dest = np.arange(nb * block).reshape(nb, block)
    dest[dest >= ng] = -1
    return dest


def plan_ao_blocks(cell, coords=None, block: int = 512, imax: int | None = None):
    """The reference's host planning: pack shells per l and cull images per
    slab of ``block`` consecutive points, every primitive kept."""
    if coords is None:
        coords = cell.uniform_grid()
    ng = coords.shape[0]
    dest = slab_slots(ng, block)
    # the reference pads the last slab with copies of the last point, and
    # they count in its centre and radius
    plans = _plans(cell, coords, np.where(dest >= 0, dest, ng - 1), imax, None)
    return plans, dest.shape[0], block


def _axis_runs(n: int, brick: int) -> list:
    """Brick edges along one mesh axis. FFT order jumps from +1/2 to -1/2
    at index ceil(n/2), so each half is cut on its own, into near-equal
    runs of at most ``brick`` indices."""
    h = -(-n // 2)
    runs = []
    for lo, hi in ((0, h), (h, n)):
        if hi > lo:
            runs += np.array_split(np.arange(lo, hi), -(-(hi - lo) // brick))
    return runs


def brick_slots(mesh) -> np.ndarray:
    """(nb, BRICK**3) flat grid index of each slot of each brick of the
    uniform grid (C order within the brick), -1 past the brick's points."""
    runs = [_axis_runs(int(n), BRICK) for n in mesh]
    n1, n2 = int(mesh[1]), int(mesh[2])
    NB = BRICK ** 3
    slots = []
    for r0 in runs[0]:
        for r1 in runs[1]:
            for r2 in runs[2]:
                idx = ((r0[:, None, None] * n1 + r1[None, :, None]) * n2
                       + r2[None, None, :]).ravel()
                slots.append(np.pad(idx, (0, NB - idx.size), constant_values=-1))
    return np.array(slots, dtype=np.int64)


def plan_ao_bricks(cell, drop: float = DROP, rcut_precision: float = RCUT_PRECISION):
    """Host planning on the uniform grid: compact bricks, images culled per
    (shell, brick), then primitives per image (terms below ``drop`` over
    the whole brick; ``drop=0`` keeps them all). Returns (per-l plans,
    slots (nb, BRICK**3))."""
    dest = brick_slots(cell.mesh)
    return _plans(cell, cell.uniform_grid(), dest, None, drop, rcut_precision), dest


def _instr(l: int, K: int, pairs, n_exp):
    """FP64 instructions of the kernel body: per (point, image) pair the
    displacement, r^2, harmonics and K(2l+1) accumulations; per primitive
    the product -a r^2, the exp and K accumulations."""
    return pairs * (6 + _ANG_INSTR[l] + K * (2 * l + 1)) \
        + n_exp * (1 + EXP_FP64_INSTR + K)


def needed_work(cell, device=None, rcut_precision: float = RCUT_PRECISION,
                coords=None) -> dict:
    """What the inputs need on the uniform grid (or on ``coords``), whatever
    the blocks: the
    (point, image, primitive) triples with the image within the shell's
    rcut (at ``rcut_precision``) of the point and max_k |c_pk| exp(-a_p r^2) max(1, r)^l >= DROP,
    and the (point, image) pairs with at least one such primitive. Chunked
    torch on ``device``; measurement code, called by nothing on the main
    path."""
    device = resolve_device(device)
    if coords is None:
        coords = cell.uniform_grid()
    packed = PackedBasis.from_cell(cell)
    images = cell.lattice_images()
    kw = dict(dtype=torch.float64, device=device)
    pts = torch.as_tensor(coords, **kw)
    # points lie within reach of the origin: prefilter images per shell
    reach = float(np.sqrt((coords ** 2).sum(axis=1).max()))
    log_drop = math.log(DROP)
    chunk = 1 << 25                     # elements of the largest temporary
    n_exp = pairs = instr = 0
    for l in packed.ls:
        K = packed.coeffs[l].shape[2]
        s_exp = s_pairs = 0
        for sh in cell.shells:
            if sh.l != l:
                continue
            rc = shell_rcut(sh, rcut_precision)
            cmax = np.abs(sh.coeffs).max(axis=1)
            alive = cmax > 0
            a = torch.as_tensor(sh.exps[alive], **kw)
            logc = torch.as_tensor(np.log(cmax[alive]), **kw)
            tc = cell.coords[sh.atom] + images
            tc = tc[np.linalg.norm(tc, axis=1) <= rc + reach]
            step = max(1, chunk // max(1, pts.shape[0] * max(1, a.numel())))
            for t0 in range(0, tc.shape[0], step):
                t = torch.as_tensor(tc[t0:t0 + step], **kw)
                r2 = ((pts[None] - t[:, None]) ** 2).sum(-1)    # (nt, ng)
                lhs = 0.5 * l * torch.log(torch.clamp(r2, min=1.0)) - log_drop
                need = (logc[:, None, None] - a[:, None, None] * r2[None]
                        + lhs[None] >= 0) & (r2 <= rc * rc)[None]   # (p, nt, ng)
                s_exp += int(need.sum())
                s_pairs += int(need.any(dim=0).sum())
        n_exp += s_exp
        pairs += s_pairs
        instr += _instr(l, K, s_pairs, s_exp)
    return dict(exp=n_exp, pairs=pairs, fp64_instr=instr)


def collocation_work(cell, plans, dest, device=None,
                     rcut_precision: float = RCUT_PRECISION, coords=None) -> dict:
    """Work of kernel K1 on a plan and what its inputs need.

    ``evaluated``: the exponentials, (point, image) pairs and FP64
    instructions this plan lets the kernel run (slots with no point run
    nothing; the per-point cut can only lower the count); ``needed``:
    :func:`needed_work` of the inputs, the same for any plan of the same
    cell and grid (the uniform grid, or ``coords``)."""
    npts = (np.asarray(dest) >= 0).sum(axis=1)                  # (nb,)
    n_exp = pairs = instr = 0
    for p in plans:
        pe = int((p.nprim.sum(axis=2) * npts[None]).sum())
        pp = int((p.counts * npts[None]).sum())
        n_exp += pe
        pairs += pp
        instr += _instr(p.l, p.K, pp, pe)
    return dict(evaluated=dict(exp=n_exp, pairs=pairs, fp64_instr=instr),
                needed=needed_work(cell, device, rcut_precision, coords))


def _shapes(l, counts, nprim, cuts, centers, exps, coeffs, coordsT, dest, imgs):
    ns, nb = counts.shape
    P, K, imax = exps.shape[1], coeffs.shape[2], imgs.shape[3]
    ntot = coordsT.shape[1]
    if (centers.shape != (ns, 3) or exps.shape != (ns, P) or cuts.shape != (ns,)
            or coeffs.shape != (ns, P, K) or imgs.shape != (ns, nb, 3, imax)
            or nprim.shape != (ns, nb, imax) or coordsT.shape[0] != 3
            or dest.shape != (ntot,) or ntot % nb):
        raise ValueError("inconsistent AO collocation shapes")
    return ns, nb, P, K, imax, ntot // nb


def collocate_plain(l, counts, nprim, cuts, centers, exps, coeffs, coordsT,
                    dest, imgs, ng, chunk_elems: int = 1 << 24):
    """Plain torch version of the kernel, same signature and result.

    out[(s*K + k)*(2l+1) + m, dest[b*NB + i]] = sum_{j < counts[s,b]}
        sum_{p < nprim[s,b,j], -exps[s,p] r^2 >= cuts[s]}
        coeffs[s,p,k] exp(-exps[s,p] r^2) S_lm(d),
        d = (coordsT[:, b*NB+i] - centers[s]) - imgs[s, b, :, j],
    for every slot with dest >= 0. (The kernel stops at a point's first
    primitive below the cut; the brick plan sorts the exponents, so that
    is the same sum.)
    """
    ns, nb, P, K, imax, NB = _shapes(l, counts, nprim, cuts, centers, exps,
                                     coeffs, coordsT, dest, imgs)
    M = 2 * l + 1
    dev = coordsT.device
    prim = torch.arange(P, device=dev)
    km = torch.arange(K * M, device=dev)
    out = torch.zeros((ns * K * M, ng), dtype=coordsT.dtype, device=dev)
    # only the slots that land on the grid (a partial brick's others are
    # padding); shells in groups of like image counts (a diffuse shell
    # lists many more images than a tight one), each group in blocks of
    # about chunk_elems (slot, image, primitive) terms
    slots_all = torch.nonzero(dest >= 0).squeeze(1)
    for sub in _shell_groups(counts):
        jm = max(1, int(counts[sub].max()))                    # live slots
        cen, ex, cut, np_, im, co = (a[sub] for a in (centers, exps, cuts, nprim, imgs,
                                                       coeffs))
        rows = (sub[:, None] * (K * M) + km).reshape(-1, 1)
        pc = max(1, chunk_elems // (len(sub) * jm * max(P, M, K)))
        for i0 in range(0, slots_all.numel(), pc):
            slots = slots_all[i0:i0 + pc]
            brick = slots // NB
            xyz = coordsT[:, slots]                                # (3, n)
            T = im[:, brick, :, :jm]                               # (s, n, 3, jm)
            d = torch.stack([(xyz[c][None, :, None] - cen[:, c, None, None])
                             - T[:, :, c] for c in range(3)], -1)  # (s, n, jm, 3)
            r2 = (d * d).sum(-1)                                   # (s, n, jm)
            live = prim < np_[:, brick, :jm, None]                 # (s, n, jm, P)
            arg = -ex[:, None, None, :] * r2[..., None]
            g = torch.exp(arg) * (live & (arg >= cut[:, None, None, None]))
            rad = torch.einsum("snjp,spk->snjk", g, co)
            ang = solid_harmonics(l, d, torch)                     # (s, n, jm, M)
            out[rows, dest[slots].long()[None, :]] = torch.einsum(
                "snjk,snjm->skmn", rad, ang).reshape(len(sub) * K * M, -1)
    return out


def _shell_groups(counts):
    """Shell indices in groups, by falling image count, each group's
    counts above half its largest: (ns, nb) counts -> list of tensors."""
    if counts.numel() == 0:
        return []
    top = counts.max(1).values
    order = torch.argsort(top, descending=True, stable=True)
    groups, start = [], 0
    for i in range(1, len(order) + 1):
        lead = int(top[order[start]])
        if i == len(order) or (lead > 0 and 2 * int(top[order[i]]) <= lead):
            groups.append(order[start:i])
            start = i
    return groups


def collocate(l, counts, nprim, cuts, centers, exps, coeffs, coordsT, dest,
              imgs, ng):
    """AO rows of one angular momentum: (ns*K*(2l+1), ng).

    CPU tensors take :func:`collocate_plain`; CUDA tensors launch the
    kernel (``ao_collocate_f32``/``_f64``) on the current stream. The
    kernel clamps trip counts to the list and skips slots whose index is
    outside [0, ng), so no value of the integer inputs writes out of
    bounds.
    """
    if coordsT.device.type == "cpu":
        return collocate_plain(l, counts, nprim, cuts, centers, exps, coeffs,
                               coordsT, dest, imgs, ng)
    ns, nb, P, K, imax, NB = _shapes(l, counts, nprim, cuts, centers, exps,
                                     coeffs, coordsT, dest, imgs)
    dtype = coordsT.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"AO collocation kernel: unsupported dtype {dtype}")
    for t in (cuts, centers, exps, coeffs, coordsT, imgs):
        if t.device != coordsT.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("AO collocation kernel: inputs must be contiguous "
                             f"{dtype} tensors on {coordsT.device}")
    for t in (counts, nprim, dest):
        if (t.device != coordsT.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError("AO collocation kernel: counts, nprim and dest "
                             "must be contiguous int32 on the same device")
    if not (0 <= l <= MAX_L and 1 <= K <= MAX_K):
        raise NotImplementedError(f"AO collocation kernel: l={l}, K={K}")
    if nb * NB >= 2 ** 31 or ng >= 2 ** 31:
        raise ValueError("AO collocation kernel: grid too large")
    out = torch.empty((ns * K * (2 * l + 1), ng), dtype=dtype,
                      device=coordsT.device)
    lib = cuda_lib.load()
    fn = lib.ao_collocate_f64 if dtype == torch.float64 else lib.ao_collocate_f32
    stream = torch.cuda.current_stream(coordsT.device).cuda_stream
    rc = fn(l, K, P, ns, nb, NB, imax, ng, counts.data_ptr(), nprim.data_ptr(),
            cuts.data_ptr(), centers.data_ptr(), exps.data_ptr(), coeffs.data_ptr(),
            coordsT.data_ptr(), dest.data_ptr(), imgs.data_ptr(),
            out.data_ptr(), stream)
    cuda_lib.check(rc, "ao_collocate")
    collocate.launches += 1
    return out


collocate.launches = 0


def make_ao_evaluator(cell, coords=None, block: int = 512,
                      dtype=torch.float64, device=None, drop=None,
                      rcut_precision: float = RCUT_PRECISION):
    """Plan once, evaluate many: returns ``fn() -> aoR (ngrids, nao)``.

    Host planning happens here: bricks on the uniform grid
    (``coords=None``), slabs of ``block`` points for explicit ``coords``:
    the reference's plan (every primitive of the images within the
    reference's radius) by default, or with ``drop`` (e.g. :data:`DROP`)
    the brick planner's cull on those slabs (terms below ``drop`` over a
    slab dropped, nothing else). ``rcut_precision`` sets the image radius
    of the brick plan and of the culled slabs (the reference's 1e-10 by
    default). The returned callable launches one
    collocation per l on pre-staged tensors. The staged per-l inputs are
    available as ``fn.staged`` (a list of argument tuples of
    :func:`collocate`), the plans and slots as ``fn.plans`` and
    ``fn.dest``.
    """
    device = resolve_device(device)
    if coords is None:
        plans, dest = plan_ao_bricks(cell, rcut_precision=rcut_precision)
        coords = cell.uniform_grid()
    else:
        dest = slab_slots(coords.shape[0], block)
        if drop is None:
            plans, _, _ = plan_ao_blocks(cell, coords, block)
        else:
            plans = _plans(cell, coords, dest, None, drop, rcut_precision)
    ng = coords.shape[0]
    flat = dest.ravel()
    coordsT = torch.as_tensor(
        np.ascontiguousarray(coords[np.where(flat >= 0, flat, 0)].T),
        dtype=dtype, device=device)                             # (3, nb*NB)
    dest_t = torch.as_tensor(flat.astype(np.int32), device=device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    staged = [(p.l, torch.as_tensor(p.counts, device=device),
               torch.as_tensor(p.nprim, device=device), dev(p.cuts), dev(p.centers),
               dev(p.exps), dev(p.coeffs), coordsT, dest_t, dev(p.imgs), ng)
              for p in plans]
    cols = np.concatenate([p.cols for p in plans])
    keep = cols >= 0
    inv = np.zeros(cell.nao, dtype=np.int64)
    inv[cols[keep]] = np.nonzero(keep)[0]
    inv_t = torch.as_tensor(inv, device=device)

    def evaluate():
        rows = torch.cat([collocate(*args) for args in staged])
        return rows[inv_t].T.contiguous()

    evaluate.staged = staged
    evaluate.plans = plans
    evaluate.dest = dest
    return evaluate

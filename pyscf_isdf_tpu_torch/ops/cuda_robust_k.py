"""Robust-fit ISDF exchange cross term: CUDA kernel K2 and its plain version.

Replaces the TPU Pallas kernel ``_kernel`` of
``pyscf_isdf_tpu/ops/pallas_robust_k.py`` (launched by ``robust_k_cross``).
The robust-fit K (:func:`pyscf_isdf_tpu_torch.df.isdf.get_k_robust`) needs,
on every SCF iteration,

    C[P, nu] = sum_g Vxi[P, g] * (sum_mu aoR[g, mu] B[P, mu]) * aoR[g, nu]

The unfused formulation writes two (ng, n_ip) temporaries to device memory
(t = aoR B^T and z = Vxi^T * t, 3 GB each in float64 at diamond 3x3x3).
The kernel (``csrc/robust_k.cu``) keeps t and z on chip: each block owns a
tile of 64 rows of P and a slice of g, loads its B tile once and streams
16-row chunks of aoR with their Vxi tiles through a ``cp.async`` ring in
shared memory; C stays in registers, and a second pass sums the per-slice
partials in a fixed order (deterministic, no atomics). What bounds it on
the card is arithmetic, 4 ng n_ip nao flops (3.3e11 at the main-path
shape) against 3.3 GB of inputs. In float64 both products run on the FP64
tensor cores (``mma.sync`` m16n8k8 f64, DMMA). Where one block's B tile and
ring do not fit shared memory (nao > 216 with three stages, > 264 with
two), a cluster of blocks splits mu = nu into ranges of at most 256
columns and adds the ranks' partial t through distributed shared memory.
:func:`block_f64` chooses cluster, stages and width, :func:`split_g` the g
slices. float32 keeps the SIMT FMA kernel (:func:`plan_f32`): TF32 tensor
cores would miss its 1e-4 relative bar.

On a CPU tensor :func:`robust_k_cross` runs :func:`robust_k_cross_plain`;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from pyscf_isdf_tpu_torch.ops import cuda_lib

SMEM_LIMIT = 232448     # shared memory a block can use on Hopper

# float32 SIMT kernel (csrc/robust_k.cu, robust_k_cross_kernel)
TG = 16                 # grid points staged per step
PASS_COLS = 256         # nu columns per column pass

# float64 DMMA kernel (csrc/robust_k.cu, robust_k_cross_dmma)
TP64 = 64               # P rows of a block
TG64 = 16               # grid points a chunk
MAX_WIDTH = 256         # mu = nu columns of one block
MAX_CLUSTER = 8         # blocks of a cluster that split mu and nu
MAX_SPLITS = 64


def robust_k_cross_plain(aoR, B, Vxi, g_chunk: int = 4096):
    """Plain torch version: C = sum over g slices of (Vxi^T * t)^T aoR."""
    ng, nao = aoR.shape
    C = torch.zeros((B.shape[0], nao), dtype=aoR.dtype, device=aoR.device)
    for g0 in range(0, ng, g_chunk):
        a = aoR[g0:g0 + g_chunk]                           # (gc, nao)
        z = (a @ B.T) * Vxi[:, g0:g0 + g_chunk].T           # (gc, nip)
        C += z.T @ a
    return C


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(tp: int, nao: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the float32 kernel."""
    lda = nao | 1
    return (tp * lda + TG * lda + TG * (tp + 1)) * itemsize


def plan_f32(ng: int, nao: int, nip: int, n_sm: int):
    """(tp, nsplit) of the float32 kernel: the largest P tile whose block
    fits shared memory, and enough g slices for about eight blocks per SM."""
    for tp in (32, 16):
        if smem_bytes(tp, nao, 4) <= SMEM_LIMIT:
            break
    else:
        raise NotImplementedError(
            f"robust-K kernel: nao={nao} does not fit shared memory")
    tiles = _cdiv(nip, tp) * _cdiv(nao, PASS_COLS)
    nsplit = max(1, min(_cdiv(ng, TG), _cdiv(8 * n_sm, tiles)))
    return tp, nsplit


def smem_bytes_f64(stages: int, width: int, cs: int) -> int:
    """Dynamic shared memory of one block of the float64 kernel: B tile and
    ``stages`` aoR chunks of ``width`` columns, ``stages`` Vxi tiles, z, and
    in a cluster (``cs`` > 1) the two buffers that publish partial t^T."""
    ldk = width + 4
    n = (TP64 * ldk + stages * TG64 * ldk + stages * TP64 * TG64
         + TP64 * (TG64 + 4) + (2 * TP64 * TG64 if cs > 1 else 0))
    return 8 * n


@dataclass(frozen=True)
class PlanF64:
    stages: int         # depth of the cp.async ring
    cs: int             # blocks of a cluster, splitting mu and nu
    width: int          # mu = nu columns of a block (a multiple of 8)
    nsplit: int         # g slices
    g_per_split: int    # a multiple of TG64
    smem: int           # dynamic shared memory of a block, bytes

    def grid(self, nip: int):
        """(x, y) launch grid: (P tile, rank in the cluster), g slice."""
        return _cdiv(nip, TP64) * self.cs, self.nsplit

    def blocks(self, ng: int, nao: int, nip: int):
        """(P range, g range, nu range) each block writes, as the kernel
        computes them from blockIdx."""
        nx, ny = self.grid(nip)
        for y in range(ny):
            for x in range(nx):
                p0, c0 = x // self.cs * TP64, x % self.cs * self.width
                g0 = y * self.g_per_split
                yield ((p0, min(nip, p0 + TP64)),
                       (g0, min(ng, g0 + self.g_per_split)),
                       (c0, min(nao, c0 + self.width)))


def block_f64(nao: int):
    """(cs, stages, width, smem) of the float64 kernel's blocks: the
    smallest cluster whose blocks fit shared memory (one block while
    nao <= 216), with three stages where they fit and two otherwise; each
    block takes ``width`` <= 256 of the mu = nu columns."""
    kp = _cdiv(nao, 8) * 8
    for cs in range(1, MAX_CLUSTER + 1):
        width = _cdiv(_cdiv(kp, cs), 8) * 8
        if width > MAX_WIDTH or (cs - 1) * width >= kp:
            continue                        # too wide, or a rank left empty
        for stages in (3, 2):
            smem = smem_bytes_f64(stages, width, cs)
            if smem <= SMEM_LIMIT:
                return cs, stages, width, smem
    raise NotImplementedError(
        f"robust-K float64 kernel: nao={nao} does not fit a cluster of "
        f"{MAX_CLUSTER} blocks")


def split_g(ng: int, tiles: int, slots: int):
    """(nsplit, g_per_split): the number of g slices that minimises (waves
    of ``slots`` resident blocks over ``tiles`` blocks a slice) x (chunks a
    block walks), the smallest within 2% of the best, since each slice adds
    a partial C to write and sum; no slice is empty."""
    nchunks = _cdiv(ng, TG64)
    costs = {}
    for ns in range(1, min(nchunks, MAX_SPLITS) + 1):
        per = _cdiv(nchunks, ns)
        ns_eff = _cdiv(nchunks, per)
        costs.setdefault(ns_eff, _cdiv(tiles * ns_eff, slots) * per)
    best = min(costs.values())
    nsplit = min(ns for ns, c in costs.items() if c <= 1.02 * best)
    return nsplit, _cdiv(nchunks, nsplit) * TG64


def plan_f64(ng: int, nao: int, nip: int, slots: int) -> PlanF64:
    """The blocks of :func:`block_f64` and their g slices
    (:func:`split_g`), for a card that runs ``slots`` blocks at once."""
    cs, stages, width, smem = block_f64(nao)
    nsplit, g_per_split = split_g(ng, _cdiv(nip, TP64) * cs, slots)
    return PlanF64(stages=stages, cs=cs, width=width, nsplit=nsplit,
                   g_per_split=g_per_split, smem=smem)


def slots_f64(nao: int, device) -> int:
    """Blocks of the float64 kernel that the card runs at once (a cluster
    stays within one GPC, so not every SM may take one)."""
    cs, stages, width, _ = block_f64(nao)
    with torch.cuda.device(device):
        n = cuda_lib.load().robust_k_cross_f64_slots(stages, width, cs)
    if n < cs:
        raise RuntimeError(f"robust-K float64 kernel: no room for a cluster "
                           f"of {cs} blocks (occupancy query gave {n})")
    return n


def robust_k_cross(aoR, B, Vxi):
    """C[P, nu] = sum_g Vxi[P, g] (aoR B^T)[g, P] aoR[g, nu].

    Args:
        aoR: (ng, nao); B: (n_ip, nao) = aoRg @ dm; Vxi: (n_ip, ng).
    Returns (n_ip, nao).
    """
    if aoR.device.type == "cpu":
        return robust_k_cross_plain(aoR, B, Vxi)
    ng, nao = aoR.shape
    nip = B.shape[0]
    if B.shape != (nip, nao) or Vxi.shape != (nip, ng) or nip == 0:
        raise ValueError("robust-K kernel: inconsistent shapes")
    dtype = aoR.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"robust-K kernel: unsupported dtype {dtype}")
    for t in (aoR, B, Vxi):
        if t.device != aoR.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("robust-K kernel: inputs must be contiguous "
                             f"{dtype} tensors on {aoR.device}")
    lib = cuda_lib.load()
    stream = torch.cuda.current_stream(aoR.device).cuda_stream
    ptrs = (aoR.data_ptr(), B.data_ptr(), Vxi.data_ptr())
    if dtype == torch.float64:
        p = plan_f64(ng, nao, nip, slots_f64(nao, aoR.device))
        partial = torch.empty((p.nsplit, nip, nao), dtype=dtype, device=aoR.device)
        out = torch.empty((nip, nao), dtype=dtype, device=aoR.device)
        rc = lib.robust_k_cross_f64(ng, nao, nip, p.nsplit, p.g_per_split,
                                    p.stages, p.width, p.cs, *ptrs,
                                    partial.data_ptr(), out.data_ptr(), stream)
    else:
        n_sm = torch.cuda.get_device_properties(aoR.device).multi_processor_count
        tp, nsplit = plan_f32(ng, nao, nip, n_sm)
        partial = torch.empty((nsplit, nip, nao), dtype=dtype, device=aoR.device)
        out = torch.empty((nip, nao), dtype=dtype, device=aoR.device)
        rc = lib.robust_k_cross_f32(ng, nao, nip, nsplit, tp, *ptrs,
                                    partial.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(rc, "robust_k_cross")
    robust_k_cross.launches += 1
    return out


robust_k_cross.launches = 0

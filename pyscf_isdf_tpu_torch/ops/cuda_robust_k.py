"""Robust-fit ISDF exchange cross term: CUDA kernel K2 and its plain version.

Replaces the TPU Pallas kernel ``_kernel`` of
``pyscf_isdf_tpu/ops/pallas_robust_k.py`` (launched by ``robust_k_cross``).
The robust-fit K (:func:`pyscf_isdf_tpu_torch.df.isdf.get_k_robust`) needs,
on every SCF iteration,

    C[P, nu] = sum_g Vxi[P, g] * (sum_mu aoR[g, mu] B[P, mu]) * aoR[g, nu]

The unfused formulation writes two (ng, n_ip) temporaries to device memory
(t = aoR B^T and z = Vxi^T * t, 3 GB each in float64 at diamond 3x3x3).
The kernel (``csrc/robust_k.cu``) keeps t and z in shared memory: each
block owns a tile of TP rows of P and a slice of g, stages its B tile and
TG rows of aoR at a time in shared memory, and accumulates its C tile in
registers; a second pass sums the per-slice partials in a fixed order
(deterministic, no atomics). What bounds it on the card is arithmetic:
4 ng n_ip nao flops (3.3e11 at the main-path shape) against 3 GB of Vxi
traffic, so it is compute-bound; this first version is a plain SIMT FMA
tiling (no tensor cores), and aoR is re-read once per P tile.

On a CPU tensor :func:`robust_k_cross` runs :func:`robust_k_cross_plain`;
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from pyscf_isdf_tpu_torch.ops import cuda_lib

TG = 16                 # csrc/robust_k.cu: grid points staged per step
PASS_COLS = 256         # nu columns per column pass
SMEM_LIMIT = 232448     # shared memory a block can use on Hopper


def robust_k_cross_plain(aoR, B, Vxi, g_chunk: int = 4096):
    """Plain torch version: C = sum over g slices of (Vxi^T * t)^T aoR."""
    ng, nao = aoR.shape
    C = torch.zeros((B.shape[0], nao), dtype=aoR.dtype, device=aoR.device)
    for g0 in range(0, ng, g_chunk):
        a = aoR[g0:g0 + g_chunk]                           # (gc, nao)
        z = (a @ B.T) * Vxi[:, g0:g0 + g_chunk].T           # (gc, nip)
        C += z.T @ a
    return C


def smem_bytes(tp: int, nao: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (mirrors csrc/robust_k.cu)."""
    lda = nao | 1
    return (tp * lda + TG * lda + TG * (tp + 1)) * itemsize


def plan(ng: int, nao: int, nip: int, itemsize: int, n_sm: int):
    """(tp, nsplit): the largest P tile whose block fits shared memory, and
    enough g slices for about eight blocks per SM."""
    for tp in (32, 16):
        if smem_bytes(tp, nao, itemsize) <= SMEM_LIMIT:
            break
    else:
        raise NotImplementedError(
            f"robust-K kernel: nao={nao} does not fit shared memory")
    tiles = -(-nip // tp) * -(-nao // PASS_COLS)
    nsplit = max(1, min(-(-ng // TG), -(-8 * n_sm // tiles)))
    return tp, nsplit


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
    n_sm = torch.cuda.get_device_properties(aoR.device).multi_processor_count
    tp, nsplit = plan(ng, nao, nip, aoR.element_size(), n_sm)
    partial = torch.empty((nsplit, nip, nao), dtype=dtype, device=aoR.device)
    out = torch.empty((nip, nao), dtype=dtype, device=aoR.device)
    lib = cuda_lib.load()
    fn = lib.robust_k_cross_f64 if dtype == torch.float64 \
        else lib.robust_k_cross_f32
    stream = torch.cuda.current_stream(aoR.device).cuda_stream
    rc = fn(ng, nao, nip, nsplit, tp, aoR.data_ptr(), B.data_ptr(),
            Vxi.data_ptr(), partial.data_ptr(), out.data_ptr(), stream)
    cuda_lib.check(rc, "robust_k_cross")
    robust_k_cross.launches += 1
    return out


robust_k_cross.launches = 0

"""Peaks of the card and the work of the robust-fit ISDF exchange,
counted from shapes, independent of what implements the call.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit (a card set lower is slower; the run reports its limit beside the
share).
"""
from __future__ import annotations

FP64_TENSOR_FLOP_PER_S = 67e12
HBM_BYTE_PER_S = 3.35e12
ITEMSIZE = 8            # float64, the configurations' type


def robust_k_work(ng, nao, nip):
    """(flops, bytes) that one K = T1 + T1^T - K_isdf call needs.

    Flops, an FMA counted as two: the cross term C = ((aoR B^T) o Vxi^T)^T
    aoR, 4 ng nao nip (its elementwise product, ng nip, is left out as
    the usual count does); B = aoRg D and T1 = aoRg^T C, 2 nip nao^2 each;
    K_isdf = aoRg^T (W o (B aoRg^T)) aoRg, with B counted once above,
    2 nip^2 nao for M and 2 nip^2 nao + 2 nip nao^2 for K. Bytes: aoR,
    Vxi, aoRg, W and D read once, K written once."""
    flops = 4 * ng * nao * nip + 6 * nip * nao * nao + 4 * nip * nip * nao
    nbytes = ITEMSIZE * (ng * nao + nip * ng + nip * nao + nip * nip + 2 * nao * nao)
    return flops, nbytes


def least_seconds(flops, nbytes):
    """(seconds, 'operations' or 'bytes'): the larger of the two bounds,
    operations at the FP64 tensor-core peak, bytes at HBM bandwidth."""
    t_ops = flops / FP64_TENSOR_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTE_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

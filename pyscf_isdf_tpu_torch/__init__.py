"""PyTorch/CUDA port of pyscf_isdf_tpu: Gamma-point SCF with ISDF exchange.

Plain tensor code is PyTorch; the two TPU Pallas kernels of the reference
package are hand-written CUDA kernels (``csrc/``) with plain PyTorch
versions beside them (``ops/cuda_ao.py``, ``ops/cuda_robust_k.py``).
Entry points run on the GPU unless the caller passes ``device="cpu"``.

TF32 is switched off for every float32 product: reduced-precision
matmuls turn the interpolation-point selection downdates into
near-random pivots.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from pyscf_isdf_tpu_torch.cell import Cell, build_cell  # noqa: E402,F401
from pyscf_isdf_tpu_torch.device import resolve_device  # noqa: E402,F401

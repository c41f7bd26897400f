"""PyTorch/CUDA port of pyscf_isdf_tpu: periodic DFT/HF with ISDF exchange.

Plain tensor code is PyTorch; the two TPU Pallas kernels of the reference
package are hand-written CUDA kernels (``csrc/``) with plain PyTorch
versions beside them (``ops/cuda_ao.py``, ``ops/cuda_robust_k.py``).
Entry points run on the GPU unless the caller passes ``device="cpu"``.
The object API (``RKS(cell).density_fit('isdf').kernel()``, ...) is
``frontend.py``; the multi-rank layer on ``torch.distributed`` is
``parallel/``.

TF32 is switched off for every float32 product: reduced-precision
matmuls turn the interpolation-point selection downdates into
near-random pivots.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from pyscf_isdf_tpu_torch.cell import Cell, build_cell  # noqa: E402,F401
from pyscf_isdf_tpu_torch.device import resolve_device  # noqa: E402,F401
from pyscf_isdf_tpu_torch.frontend import (  # noqa: E402,F401
    RHF, RKS, UHF, UKS, ROHF, KRHF, KRKS, KUHF, KUKS, KROHF, KGHF, KRKSpU,
    MP2, KMP2, KMP2_stagger, CCSD, KCCSD, EOMCCSD, KEOMCCSD, Gradients,
    Stress, TDA, TDDFT,
    GW, RPA,
)

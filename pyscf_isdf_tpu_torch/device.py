"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without CUDA that raises instead of
    silently running on the CPU (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)

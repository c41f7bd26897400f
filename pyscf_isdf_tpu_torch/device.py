"""Device selection shared by the port's entry points."""
from __future__ import annotations

import numpy as np
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


def require_device(tensor: torch.Tensor, device=None) -> torch.device:
    """Resolve ``device`` as :func:`resolve_device` does and raise unless
    ``tensor`` (a built system's or factorization's data) lives there."""
    device = resolve_device(device)
    have = tensor.device
    if have.type != device.type or (device.index is not None
                                    and have.index != device.index):
        raise ValueError(f"the system lives on {have}, not on {device}: build "
                         f"it with device={str(device)!r}")
    return device


def to_host(a):
    """A tensor (or array-like) as a numpy array on the host."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

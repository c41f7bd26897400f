"""Electron-phonon coupling (Gamma point), torch.

Reference capability: pyscf/pbc/eph/eph_fd.py, as the JAX package carries
it over (``pyscf_isdf_tpu/eph/``).
"""
from pyscf_isdf_tpu_torch.eph.eph_fd import (
    eph_kernel, phonon_modes, EPHResult,
)

__all__ = ["eph_kernel", "phonon_modes", "EPHResult"]

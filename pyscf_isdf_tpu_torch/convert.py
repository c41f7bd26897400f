"""Carry a built state, given as numpy arrays, into the port's objects.

With these the port's exchange and SCF can run on a factorization or a
system built elsewhere (for example by the JAX reference package), which
sidesteps near-tied interpolation pivots that rounding can reorder.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.df.isdf import ISDF
from pyscf_isdf_tpu_torch.scf.hf import SCFSystem


def isdf_from_numpy(aoRg, W, ip_idx, Vxi=None, device=None,
                    dtype=torch.float64) -> ISDF:
    """An :class:`ISDF` from (n_ip, nao) aoRg, (n_ip, n_ip) W, (n_ip,)
    grid indices and, for the robust-fit K, (n_ip, ng) Vxi."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device).contiguous()

    return ISDF(aoRg=t(aoRg), W=t(W),
                ip_idx=torch.as_tensor(np.array(ip_idx), dtype=torch.int64,
                                       device=device),
                Vxi=None if Vxi is None else t(Vxi))


def system_from_numpy(cell, S, hcore, X, aoR, coulG, madelung, e_nuc,
                      device=None, dtype=torch.float64) -> SCFSystem:
    """An :class:`SCFSystem` from its numpy fields; mesh, grid weight,
    electron count and G vectors come from ``cell``."""
    device = resolve_device(device)

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.array(a), dtype=dt, device=device).contiguous()

    return SCFSystem(
        cell=cell, S=t(S), hcore=t(hcore), X=t(X), aoR=t(aoR, dtype),
        coulG=t(coulG, dtype), madelung=float(madelung), e_nuc=float(e_nuc),
        mesh=tuple(cell.mesh), weight=cell.grid_weight, nelec=cell.nelectron,
        Gv=t(cell.get_Gv(), dtype),
    )

"""Pulay CDIIS on the Fock matrix (float64 tensors).

Commutator-error DIIS, the same extrapolation the reference SCF driver
uses (pyscf/scf/diis.py:40-122 semantics): error vector
e = X^H (F D S - S D F) X in the orthonormal basis (complex at k-points),
B-matrix Re <e_i, e_j> solve with the constraint sum c_i = 1. The small
(n+1)^2 system is solved on the host.
"""
from __future__ import annotations

import numpy as np
import torch


class DIIS:
    def __init__(self, space: int = 8, min_space: int = 2):
        self.space = space
        self.min_space = min_space
        self._errs: list[torch.Tensor] = []
        self._focks: list[torch.Tensor] = []

    def update(self, fock: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
        self._focks.append(fock.clone())
        self._errs.append(err.reshape(-1).clone())
        if len(self._focks) > self.space:
            self._focks.pop(0)
            self._errs.pop(0)
        n = len(self._focks)
        if n < self.min_space:
            return fock
        E = torch.stack(self._errs)
        c = diis_coefficients((E.conj() @ E.T).real.cpu().numpy())
        return sum(float(ci) * fi for ci, fi in zip(c, self._focks))


def diis_coefficients(gram: np.ndarray) -> np.ndarray:
    """The extrapolation weights (summing to 1) that minimise the norm of
    the combined error, from the (n, n) Gram matrix Re <e_i, e_j>."""
    n = gram.shape[0]
    B = np.empty((n + 1, n + 1))
    B[-1, :] = -1.0
    B[:, -1] = -1.0
    B[-1, -1] = 0.0
    B[:n, :n] = gram
    rhs = np.zeros(n + 1)
    rhs[-1] = -1.0
    try:
        return np.linalg.solve(B, rhs)[:n]
    except np.linalg.LinAlgError:
        return np.linalg.lstsq(B, rhs, rcond=None)[0][:n]

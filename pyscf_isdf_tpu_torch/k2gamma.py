"""Unfold k-sampled MOs and densities onto the Gamma-point supercell.

Reference analog: pyscf/pbc/tools/k2gamma.py:82-199. A k-sampled orbital
phi_{k,n}(r) = sum_T e^{ik.T} phi_AO(r - T) C_{k,n} maps to a supercell
orbital whose AO coefficients on cell copy R carry the phase e^{ik.T_R}:

    C_sc[(R, mu), (k, n)] = e^{i k.T_R} C_k[mu, n] / sqrt(Nk)

Host numpy, float64 / complex128.
"""
from __future__ import annotations

import numpy as np

from pyscf_isdf_tpu_torch import lattice


def get_phase(cell, kpts, nrep):
    """(Ts (ncells,3) lattice translations, phase (ncells, nk) matrix)."""
    nrep = np.asarray(nrep)
    Ts_frac = lattice.cartesian_prod(*[np.arange(n) for n in nrep])
    Ts = Ts_frac @ cell.a
    kpts = np.reshape(kpts, (-1, 3))
    phase = np.exp(1j * Ts @ kpts.T) / np.sqrt(len(kpts))
    return Ts, phase


def mo_k2gamma(cell, mo_coeff_k, kpts, nrep):
    """Supercell AO coefficients of the unfolded k-MOs.

    Args:
        mo_coeff_k: per-k (nao, nmo) MO coefficients.
        nrep: the k-mesh dimensions (supercell replication).

    Returns (ncells*nao, nk*nmo) complex coefficients, columns ordered
    (k, n), AO rows ordered (cell copy, mu) — the atom ordering of
    :func:`pyscf_isdf_tpu_torch.models.diamond_supercell`.
    """
    mo = np.asarray(mo_coeff_k)                    # (nk, nao, nmo)
    nk, nao, nmo = mo.shape
    _, phase = get_phase(cell, kpts, nrep)
    C = phase[:, None, :, None] * mo.transpose(1, 0, 2)[None]   # (R, mu, k, n)
    return C.reshape(len(phase) * nao, nk * nmo)


def dm_k2gamma(cell, dm_k, kpts, nrep):
    """Supercell Gamma density matrix from per-k density matrices.

    D_sc[(R,mu),(R',nu)] = (1/Nk) sum_k e^{ik.(T_R - T_R')} D_k[mu,nu];
    real (returned as float64) when its imaginary part is below 1e-8, as
    on time-reversal-symmetric k-meshes.
    """
    kpts = np.reshape(kpts, (-1, 3))
    nk = len(kpts)
    dm_k = np.asarray(dm_k)
    nao = dm_k.shape[-1]
    Ts, _ = get_phase(cell, kpts, nrep)
    ncells = len(Ts)
    dT = Ts[:, None, :] - Ts[None, :, :]
    ph = np.exp(1j * dT @ kpts.T)                  # (nc, nc, nk)
    D = np.einsum("rsk,kuv->rusv", ph, dm_k) / nk
    D = D.reshape(ncells * nao, ncells * nao)
    if abs(D.imag).max() < 1e-8:
        D = D.real
    return D

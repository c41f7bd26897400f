"""Post-SCF analysis: Mulliken populations, gaps, density of states and
high-symmetry band paths (torch).

Reference analogs: pyscf/scf/hf.py mulliken_pop and the HOMO/LUMO
reporting of the SCF drivers. Plain functions on tensors (numpy arrays
are taken too); ``band_path`` builds host k-points.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice


def mulliken_pop(cell, dm, S):
    """Mulliken AO populations and atomic charges.

    ``dm`` (nao, nao), or (2, nao, nao) spin-resolved (summed). Returns
    (pop (nao,), charges (natm,)) float64 tensors on the device of ``S``:
    q_A = Z_A - sum_{mu in A} (D S)_mumu.
    """
    S = torch.as_tensor(S)
    dm = torch.as_tensor(dm, device=S.device)
    if dm.dim() == 3:
        dm = dm[0] + dm[1]
    pop = torch.einsum("ij,ji->i", dm.to(S.dtype), S).real.to(torch.float64)
    owner = np.repeat([sh.atom for sh in cell.shells], np.diff(cell.ao_loc))
    lost = torch.zeros(cell.natm, dtype=torch.float64, device=S.device)
    lost.index_add_(0, torch.as_tensor(owner, device=S.device), pop)
    charges = torch.as_tensor(np.asarray(cell.charges, dtype=np.float64),
                              device=S.device) - lost
    return pop, charges


def homo_lumo_gap(mo_energy, nocc):
    """(HOMO, LUMO, gap) from the orbital energies (sorted here; pass the
    k-stacked spectrum and nocc * nk for the indirect gap)."""
    if isinstance(mo_energy, (list, tuple)):
        mo_energy = torch.cat([torch.as_tensor(e).reshape(-1) for e in mo_energy])
    e = torch.sort(torch.as_tensor(mo_energy).reshape(-1)).values
    return float(e[nocc - 1]), float(e[nocc]), float(e[nocc] - e[nocc - 1])


def density_of_states(mo_energy_k, weights=None, sigma=0.01, window=None, npts=500):
    """Gaussian-broadened density of states from k-sampled eigenvalues.

    Args:
        mo_energy_k: (nk, nmo) (or flat) orbital energies.
        weights: optional (nk,) k-point weights (default uniform 1/nk).
        sigma: Gaussian broadening (Ha).
        window: (emin, emax); default spans the spectrum +- 5 sigma.
    Returns (energies (npts,), dos (npts,)) float64 tensors with
    integral dos dE = states per cell (x2 for spin-restricted).
    """
    e_k = torch.as_tensor(mo_energy_k, dtype=torch.float64)
    e_k = e_k.reshape(1, -1) if e_k.dim() < 2 else e_k
    nk = e_k.shape[0]
    w = (torch.full((nk,), 1.0 / nk, dtype=torch.float64, device=e_k.device)
         if weights is None else torch.as_tensor(weights, dtype=torch.float64,
                                                 device=e_k.device))
    if window is None:
        window = (float(e_k.min()) - 5 * sigma, float(e_k.max()) + 5 * sigma)
    grid = torch.linspace(window[0], window[1], npts, dtype=torch.float64,
                          device=e_k.device)
    d = grid[:, None, None] - e_k[None, :, :]
    g = torch.exp(-0.5 * (d / sigma) ** 2) / (sigma * np.sqrt(2 * np.pi))
    return grid, torch.einsum("k,gkm->g", w, g)


# high-symmetry points (fractional, reciprocal basis) per lattice family
_HS_POINTS = {
    "fcc": {"G": (0, 0, 0), "X": (0.5, 0, 0.5), "L": (0.5, 0.5, 0.5),
            "W": (0.5, 0.25, 0.75), "K": (0.375, 0.375, 0.75),
            "U": (0.625, 0.25, 0.625)},
    "bcc": {"G": (0, 0, 0), "H": (0.5, -0.5, 0.5), "N": (0, 0, 0.5),
            "P": (0.25, 0.25, 0.25)},
    "cubic": {"G": (0, 0, 0), "X": (0, 0.5, 0), "M": (0.5, 0.5, 0),
              "R": (0.5, 0.5, 0.5)},
    "hexagonal": {"G": (0, 0, 0), "M": (0.5, 0, 0), "K": (1 / 3, 1 / 3, 0),
                  "A": (0, 0, 0.5), "L": (0.5, 0, 0.5),
                  "H": (1 / 3, 1 / 3, 0.5)},
}


def band_path(cell, path, npoints=50, lattice_type="fcc"):
    """Cartesian k-points along a high-symmetry path, e.g. "LGXWG".

    Returns host numpy (kpts (N, 3) in 1/Bohr, xs (N,) cumulative path
    length for plotting, xticks (len(path),) node positions); the joints
    of consecutive segments appear once.
    """
    pts = _HS_POINTS[lattice_type]
    b = lattice.reciprocal_vectors(cell.a)
    nodes = [np.asarray(pts[c], dtype=np.float64) @ b for c in path]
    kpts, xs, xticks = [], [], [0.0]
    x = 0.0
    for i in range(len(nodes) - 1):
        for t in np.linspace(0.0, 1.0, npoints):
            k = (1 - t) * nodes[i] + t * nodes[i + 1]
            if kpts and np.allclose(k, kpts[-1]):
                continue
            if kpts:
                x += np.linalg.norm(k - kpts[-1])
            kpts.append(k)
            xs.append(x)
        xticks.append(x)
    return np.asarray(kpts), np.asarray(xs), np.asarray(xticks)

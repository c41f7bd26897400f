"""Lattice / plane-wave-mesh math (host-side, float64 numpy).

Pure functions over the lattice matrix ``a`` (rows are lattice vectors, Bohr).
Conventions follow the reference PBC stack so that grids, G-vectors and FFT
orderings are interchangeable:

  * G-vector ordering is the 3-D FFT frequency ordering
    (``np.fft.fftfreq`` per axis; reference: pyscf/pbc/gto/cell.py:523-607),
  * uniform real-space grid coordinates use wrap-around fractional
    coordinates (reference: pyscf/pbc/gto/cell.py:874-899),
  * ``cutoff_to_mesh`` uses the QR-based reduced reciprocal cell heights
    (reference: pyscf/pbc/tools/pbc.py:703-727).

Everything here is cheap O(ngrids) geometry setup evaluated once per cell
build; the arrays feed the device-side compute path.
"""
from __future__ import annotations

import numpy as np


def reciprocal_vectors(a: np.ndarray) -> np.ndarray:
    """Rows are reciprocal lattice vectors b_i with a_i . b_j = 2 pi delta_ij."""
    return 2 * np.pi * np.linalg.inv(np.asarray(a, dtype=np.float64).T)


def cell_volume(a: np.ndarray) -> float:
    return abs(np.linalg.det(np.asarray(a, dtype=np.float64)))


def gv_base(mesh) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Integer FFT frequencies along each axis ([0..n/2, -n/2..-1] order)."""
    return tuple(np.fft.fftfreq(n, 1.0 / n) for n in mesh)


def get_Gv(a: np.ndarray, mesh) -> np.ndarray:
    """(ngrids, 3) G-vectors in FFT ordering: G = gx*b1 + gy*b2 + gz*b3."""
    rx, ry, rz = gv_base(mesh)
    b = reciprocal_vectors(a)
    base = cartesian_prod(rx, ry, rz)
    return base @ b


def cartesian_prod(*arrays) -> np.ndarray:
    """Cartesian product with the first array varying slowest (C order)."""
    grids = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def get_SI(a: np.ndarray, coords: np.ndarray, mesh=None, Gv=None) -> np.ndarray:
    """Structure factor S_I(G) = exp(-i G . R_I), shape (natm, ngrids)."""
    if Gv is None:
        Gv = get_Gv(a, mesh)
    return np.exp(-1j * np.asarray(coords, dtype=np.float64) @ Gv.T)


def uniform_grid(a: np.ndarray, mesh, wrap_around: bool = True) -> np.ndarray:
    """(ngrids, 3) real-space uniform grid coordinates in FFT ordering.

    With wrap_around (the default, matching the reference), fractional
    coordinates run over fftfreq values in [-1/2, 1/2) rather than [0, 1).
    """
    if wrap_around:
        fracs = [np.fft.fftfreq(n) for n in mesh]
    else:
        fracs = [np.arange(n) / n for n in mesh]
    qv = cartesian_prod(*fracs)
    return qv @ np.asarray(a, dtype=np.float64)


def _reduced_heights(a: np.ndarray) -> np.ndarray:
    """|R_x|,|R_y|,|R_z|: heights of the reduced reciprocal cell (QR trick)."""
    b = reciprocal_vectors(a)
    rx = np.linalg.qr(b[[1, 2, 0]].T)[1][2, 2]
    ry = np.linalg.qr(b[[2, 0, 1]].T)[1][2, 2]
    rz = np.linalg.qr(b.T)[1][2, 2]
    return np.abs(np.array([rx, ry, rz]))


def cutoff_to_mesh(a: np.ndarray, ke_cutoff: float) -> np.ndarray:
    """Minimal odd FFT mesh resolving plane waves up to ke_cutoff (Hartree)."""
    Gmax = np.sqrt(2.0 * ke_cutoff) / _reduced_heights(a)
    return np.ceil(Gmax).astype(int) * 2 + 1


def mesh_to_cutoff(a: np.ndarray, mesh) -> np.ndarray:
    """KE cutoff per axis implied by an FFT mesh."""
    Gmax = (np.asarray(mesh) - 1) // 2 * _reduced_heights(a)
    return Gmax**2 / 2.0


def make_kpts(a: np.ndarray, nks, with_gamma_point: bool = True,
              wrap_around: bool = False, scaled_center=None) -> np.ndarray:
    """Monkhorst-Pack k-point grid in absolute units (1/Bohr).

    Same conventions as the reference (pyscf/pbc/gto/cell.py:815-872):
    Gamma-centered by default; ``with_gamma_point=False`` shifts by half a
    step; ``wrap_around`` maps points >= 0.5 back into [-0.5, 0.5).
    """
    ks_each = []
    for n in nks:
        if with_gamma_point or scaled_center is not None:
            ks = np.arange(n, dtype=np.float64) / n
        else:
            ks = (np.arange(n) + 0.5) / n - 0.5
        if wrap_around:
            ks[ks >= 0.5] -= 1
        ks_each.append(ks)
    scaled = cartesian_prod(*ks_each)
    if scaled_center is not None:
        scaled = scaled + np.asarray(scaled_center)
    return scaled @ reciprocal_vectors(a)


def lattice_images(a: np.ndarray, rcut: float, dimension: int = 3) -> np.ndarray:
    """(nimg, 3) lattice translation vectors T with images inside rcut.

    Conservative bound: includes every T whose closest point of the translated
    cell can fall within ``rcut`` of the home cell (heights-based bound + one
    extra shell), then prunes by |T| <= rcut + cell diameter.
    """
    a = np.asarray(a, dtype=np.float64)
    # heights of the real-space cell along each axis
    b = reciprocal_vectors(a)
    heights = 2 * np.pi / np.linalg.norm(b, axis=1)  # |a_i . n_i|
    nmax = np.zeros(3, dtype=int)
    nmax[:dimension] = np.ceil(rcut / heights[:dimension]).astype(int)[:dimension] + 1
    rng = [np.arange(-n, n + 1) for n in nmax]
    Ts = cartesian_prod(*rng) @ a
    # prune: keep T if the translated cell could reach within rcut
    diameter = np.linalg.norm(a.sum(axis=0))
    keep = np.linalg.norm(Ts, axis=1) <= rcut + diameter
    return Ts[keep]

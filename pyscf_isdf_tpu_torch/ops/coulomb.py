"""Coulomb kernel on the G mesh, the Ewald sum and the Madelung constant.

Host-side float64 builders for per-geometry constants (3-D cells):

  * :func:`get_coulG` — 4 pi / |G|^2 with the G=0 conventions and the
    Ewald probe-charge ('ewald') /
    spherical-cutoff ('vcut_sph') exchange-divergence corrections
    (reference semantics: pyscf/pbc/tools/pbc.py:230-420),
  * :func:`ewald` — real+reciprocal Ewald sum for the nuclear repulsion
    (reference: pyscf/pbc/gto/cell.py:648-800),
  * :func:`madelung` — probe-charge Madelung constant, = -2 x ewald energy
    of a unit point charge in the cell
    (reference: pyscf/pbc/tools/pbc.py:483-512).

Gamma point only. The k-point kernels, the low-dimensional kernels,
'vcut_ws' and range separation are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
from scipy.special import erfc

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.cell import _estimate_rcut


def get_coulG(cell, k=None, exxdiv=None, mesh=None, Gv=None) -> np.ndarray:
    """Coulomb kernel 4 pi/|G|^2 for all G on the mesh (float64, host).

    Args:
        k: momentum transfer; only Gamma (None or zero) is ported.
        exxdiv: None | 'ewald' | 'vcut_sph' — G=0 divergence treatment for
            exchange matrix elements.
    """
    if k is not None and np.abs(k).sum() > 1e-9:
        raise NotImplementedError("k-point Coulomb kernels")
    if cell.dimension != 3:
        raise NotImplementedError("low-dimensional Coulomb kernels")
    if exxdiv not in (None, "ewald", "vcut_sph"):
        raise NotImplementedError(f"exxdiv={exxdiv!r}")
    if Gv is None:
        Gv = cell.get_Gv(mesh or cell.mesh)
    absG2 = np.einsum("gi,gi->g", Gv, Gv)
    G0_idx = absG2 == 0

    if exxdiv == "vcut_sph":
        Rc = (3 * cell.vol / (4 * np.pi)) ** (1.0 / 3)
        with np.errstate(divide="ignore", invalid="ignore"):
            coulG = 4 * np.pi / absG2 * (1.0 - np.cos(np.sqrt(absG2) * Rc))
        coulG[G0_idx] = 4 * np.pi * 0.5 * Rc**2
    else:
        with np.errstate(divide="ignore"):
            coulG = 4 * np.pi / absG2
        coulG[G0_idx] = 0
        if exxdiv == "ewald" and G0_idx.any():
            coulG[G0_idx] += cell.vol * madelung(cell)
    return coulG


def ewald_params(cell, precision=None):
    """Gaussian-charge width eta and real-space cutoff for the Ewald sum."""
    precision = precision or cell.precision
    ew_eta = 1.0 / cell.vol ** (1.0 / 6)
    ew_cut = _estimate_rcut(ew_eta**2, 0, 1.0, precision)
    return ew_eta, ew_cut


def ewald(cell, ew_eta=None, ew_cut=None) -> float:
    """Nuclear repulsion: the 3-D Ewald sum."""
    if cell.natm == 0:
        return 0.0
    if cell.dimension != 3:
        raise NotImplementedError(f"ewald for dimension {cell.dimension}")
    chargs = cell.charges
    if ew_eta is None or ew_cut is None:
        ew_eta, ew_cut = ewald_params(cell)

    coords = cell.coords
    Lall = lattice.lattice_images(cell.a, ew_cut, cell.dimension)
    rLij = coords[:, None, :] - coords[None, :, :] + Lall[:, None, None, :]
    r = np.sqrt(np.einsum("Lijx,Lijx->Lij", rLij, rLij))
    r[r < 1e-16] = 1e200
    ewovrl = 0.5 * np.einsum("i,j,Lij->", chargs, chargs, erfc(ew_eta * r) / r)

    ewself = -0.5 * np.dot(chargs, chargs) * 2 * ew_eta / np.sqrt(np.pi)
    ewself += -0.5 * np.sum(chargs) ** 2 * np.pi / (ew_eta**2 * cell.vol)

    log_precision = np.log(cell.precision / (max(np.abs(chargs).sum(), 1.0) * 16 * np.pi**2))
    ke_cutoff = -2 * ew_eta**2 * log_precision
    mesh = lattice.cutoff_to_mesh(cell.a, ke_cutoff)
    Gv = lattice.get_Gv(cell.a, mesh)
    absG2 = np.einsum("gi,gi->g", Gv, Gv)
    absG2[absG2 == 0] = 1e200

    # 1/2 sum_{G!=0} |ZS(G)|^2 4pi/G^2 e^{-G^2/4eta^2} / vol
    coulG = 4 * np.pi / absG2 / cell.vol
    ZSI = np.einsum("i,ij->j", chargs, lattice.get_SI(cell.a, coords, Gv=Gv))
    ZexpG2 = ZSI * np.exp(-absG2 / (4 * ew_eta**2))
    ewg = 0.5 * np.einsum("i,i,i", ZSI.conj(), ZexpG2, coulG).real
    return float(ewovrl + ewself + ewg)


def madelung(cell) -> float:
    """Probe-charge Madelung constant for the exchange G=0 correction
    (Gamma point: the cell itself, no k-mesh scaling)."""
    return -2.0 * ewald(cell.madelung_cell())

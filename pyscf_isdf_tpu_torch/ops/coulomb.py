"""Coulomb kernel on the G mesh, the Ewald sum and the Madelung constant.

Host-side float64 builders for per-geometry constants (3-D cells):

  * :func:`get_coulG` — 4 pi / |k+G|^2 with wrap-around of high-frequency
    k+G, the G=0 conventions and the Ewald probe-charge ('ewald') /
    spherical-cutoff ('vcut_sph') exchange-divergence corrections
    (reference semantics: pyscf/pbc/tools/pbc.py:230-420),
  * :func:`ewald` — real+reciprocal Ewald sum for the nuclear repulsion
    (reference: pyscf/pbc/gto/cell.py:648-800),
  * :func:`madelung` — probe-charge Madelung constant, = -2 x ewald energy
    of a unit point charge in the (k-mesh-scaled) cell
    (reference: pyscf/pbc/tools/pbc.py:483-512),
  * :func:`madelung_omega` — the same under the long-range erf(w r)/r
    kernel (range-separated exchange).

The low-dimensional kernels and 'vcut_ws' are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.special import erfc

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.cell import _estimate_rcut


def get_coulG(cell, k=None, exxdiv=None, mesh=None, Gv=None, kpts=None,
              omega=None) -> np.ndarray:
    """Coulomb kernel 4 pi/|k+G|^2 for all G on the mesh (float64, host).

    Args:
        k: momentum transfer (3,): zero or None for J builds, k_j - k_i
            for exchange.
        exxdiv: None | 'ewald' | 'vcut_sph' — G=0 divergence treatment for
            exchange matrix elements.
        kpts: the full k-point set; 'ewald' scales the probe-charge shift
            by its size Nk, and 'vcut_sph' truncates at the radius Rc of
            the sphere of Nk cells' volume (the SCF k-mesh, also when ``k``
            is a band k-point's transfer).
        omega: range separation: > 0 the long-range erf(w r)/r kernel,
            < 0 the short-range erfc(|w| r)/r kernel.

    At a k-point, k+G beyond the FFT box is folded back into it, so Gamma
    and k-point calculations agree.
    """
    if cell.dimension != 3:
        raise NotImplementedError("low-dimensional Coulomb kernels")
    if exxdiv not in (None, "ewald", "vcut_sph"):
        raise NotImplementedError(f"exxdiv={exxdiv!r}")
    k = np.zeros(3) if k is None else np.asarray(k, dtype=np.float64)
    kpts = k.reshape(1, 3) if kpts is None else np.reshape(kpts, (-1, 3))
    at_k = np.abs(k).sum() > 1e-9
    mesh = mesh or cell.mesh
    if Gv is None:
        Gv = cell.get_Gv(mesh)

    kG = Gv + k if at_k else Gv
    equal2boundary = None
    if at_k:
        kG = kG.copy()
        equal2boundary = np.zeros(Gv.shape[0], dtype=bool)
        b = cell.reciprocal_vectors()
        box_edge = (np.asarray(mesh) // 2 + 0.5)[:, None] * b
        reduced = np.linalg.solve(box_edge.T, kG.T).T.round(9)
        on_edge = reduced.astype(int)
        for i in range(3):
            equal2boundary |= reduced[:, i] == 1
            equal2boundary |= reduced[:, i] == -1
            kG[on_edge[:, i] == 1] -= 2 * box_edge[i]
            kG[on_edge[:, i] == -1] += 2 * box_edge[i]

    absG2 = np.einsum("gi,gi->g", kG, kG)
    G0_idx = absG2 == 0

    if exxdiv == "vcut_sph":
        Rc = (3 * len(kpts) * cell.vol / (4 * np.pi)) ** (1.0 / 3)
        with np.errstate(divide="ignore", invalid="ignore"):
            coulG = 4 * np.pi / absG2 * (1.0 - np.cos(np.sqrt(absG2) * Rc))
        coulG[G0_idx] = 4 * np.pi * 0.5 * Rc**2
    else:
        with np.errstate(divide="ignore"):
            coulG = 4 * np.pi / absG2
        coulG[G0_idx] = 0
        if exxdiv == "ewald" and G0_idx.any():
            coulG[G0_idx] += len(kpts) * cell.vol * madelung(cell, kpts)
    if equal2boundary is not None:
        coulG[equal2boundary] = 0
    if omega:
        if omega > 0:
            coulG *= np.exp(-0.25 / omega**2 * absG2)
        else:
            coulG *= 1 - np.exp(-0.25 / omega**2 * absG2)
            # the short-range kernel is finite at G=0:
            # lim 4pi/G^2 (1 - e^{-G^2/4w^2}) = pi/w^2, so short-range
            # exchange needs no probe-charge correction
            if exxdiv is None:
                coulG[absG2 < 1e-12] = np.pi / omega**2
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


def madelung(cell, kpts=None) -> float:
    """Probe-charge Madelung constant for the exchange G=0 correction: the
    cell scaled by the Monkhorst-Pack size of ``kpts`` (the cell itself at
    Gamma)."""
    if kpts is None:
        Nk = np.ones(3, dtype=int)
    else:
        Nk = monkhorst_pack_size(cell, np.reshape(kpts, (-1, 3)))
    scaled = dataclasses.replace(cell.madelung_cell(), a=cell.a * Nk[:, None])
    return -2.0 * ewald(scaled)


def madelung_omega(cell, kpts, omega: float) -> float:
    """Probe-charge Madelung constant under the long-range erf(w r)/r
    kernel: the self-interaction of one probe charge in the Nk-scaled
    supercell (reference semantics: pyscf/pbc/tools/pbc.py:492-512),

        M_w = 2 w / sqrt(pi) - (1/vol) sum_{G != 0} 4 pi/G^2 e^{-G^2/4w^2},

    on the mesh of the precision-driven cutoff of the reference formula.
    """
    omega = abs(float(omega))
    if kpts is None:
        Nk = np.ones(3, dtype=int)
    else:
        Nk = monkhorst_pack_size(cell, np.reshape(kpts, (-1, 3)))
    a = cell.a * Nk[:, None]
    Ecut = 10.0
    for _ in range(2):
        Ecut = np.log(16 * np.pi**2 / (2 * omega**2 * np.sqrt(2 * Ecut))
                      / cell.precision + 1.0) * 2 * omega**2
    Gv = lattice.get_Gv(a, lattice.cutoff_to_mesh(a, Ecut))
    absG2 = np.einsum("gi,gi->g", Gv, Gv)
    with np.errstate(divide="ignore", invalid="ignore"):
        wcoul = 4 * np.pi / absG2 * np.exp(-0.25 / omega**2 * absG2)
    wcoul[absG2 < 1e-12] = 0.0
    return 2 * omega / np.sqrt(np.pi) - wcoul.sum() / abs(np.linalg.det(a))


def monkhorst_pack_size(cell, kpts, tol=1e-5):
    """Points of the k-mesh along each reciprocal axis."""
    if kpts.shape[0] == 1:
        return np.ones(3, dtype=int)
    tol = max(10 ** (-int(-np.log10(1 / kpts.shape[0])) - 2), tol)
    skpts = kpts @ np.linalg.inv(cell.reciprocal_vectors())
    return np.array(
        [np.count_nonzero(abs(sk[1:] - sk[:-1]) > tol) + 1 for sk in np.sort(skpts.T)]
    )

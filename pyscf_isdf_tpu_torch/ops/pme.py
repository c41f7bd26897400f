"""Smooth particle-mesh Ewald (B-spline PME) for the nuclear repulsion.

Reference behavior: pyscf/pbc/gto/ewald_methods.py:123 (`particle_mesh_ewald`)
— Essmann et al. smooth PME: point charges are spread onto the FFT mesh
with cardinal B-splines of order n, the screened reciprocal sum becomes
one mesh FFT against the Euler-exponential-spline influence function,
and the real-space erfc sum + self terms are unchanged. O(N log N) in
the mesh where the exact structure-factor sum is O(natm * nG).

The charge spreading is one ``index_put_(accumulate=True)`` over the
natm x order^3 stencil and the reciprocal energy one ``torch.fft`` on the
device; the real-space and self terms are host float64, as in
:func:`~pyscf_isdf_tpu_torch.ops.coulomb.ewald`.
"""
from __future__ import annotations

from math import comb, factorial

import numpy as np
import torch
from scipy.special import erfc

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.ops import coulomb


def _bspline_m(u, n: int):
    """Cardinal B-spline M_n(u) = 1/(n-1)! sum_k (-1)^k C(n,k) (u-k)_+^{n-1}
    (numpy or torch ``u``)."""
    out = 0.0 * u
    for k in range(n + 1):
        d = u - k
        out = out + ((-1) ** k) * comb(n, k) * (d * (d > 0)) ** (n - 1)
    return out / factorial(n - 1)


def _euler_spline_b(ng: int, n: int) -> np.ndarray:
    """|b(m)|^2 prefactors of the exponential Euler spline (host, once)."""
    m = np.arange(ng)
    denom = np.zeros(ng, dtype=np.complex128)
    for k in range(n - 1):
        denom += float(_bspline_m(np.array(k + 1.0), n)) \
            * np.exp(2j * np.pi * m * k / ng)
    b = np.exp(2j * np.pi * (n - 1) * m / ng) / denom
    if n % 2 > 0 and ng % 2 == 0:
        b[ng // 2] = 0.0
    return np.abs(b) ** 2


def pme_reciprocal(cell, ew_eta: float, mesh, order: int = 10,
                   device=None) -> float:
    """Reciprocal-space Ewald energy on the mesh via B-spline PME."""
    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    mesh = tuple(int(m) for m in mesh)
    # fractional coords scaled to mesh units
    b = lattice.reciprocal_vectors(cell.a) / (2 * np.pi)
    u = (cell.coords @ b.T) * np.asarray(mesh)[None, :]
    i = np.arange(order)
    ixs, Ms = [], []
    for d in range(3):
        uf = np.floor(u[:, d])
        delta = torch.as_tensor(u[:, d] - uf, **f64)
        ixs.append(torch.as_tensor((uf[:, None] - i[None, :]) % mesh[d],
                                   dtype=torch.int64, device=device))  # (natm, n)
        Ms.append(_bspline_m(delta[:, None] + torch.as_tensor(i, **f64)[None, :],
                             order))
    chargs = torch.as_tensor(cell.charges, **f64)
    stencil = (chargs[:, None, None, None] * Ms[0][:, :, None, None]
               * Ms[1][:, None, :, None] * Ms[2][:, None, None, :])
    natm = cell.natm
    idx = [ixs[0][:, :, None, None], ixs[1][:, None, :, None],
           ixs[2][:, None, None, :]]
    idx = [t.expand(natm, order, order, order).reshape(-1) for t in idx]
    Q = torch.zeros(mesh, **f64)
    Q.index_put_(tuple(idx), stencil.reshape(-1), accumulate=True)

    B = np.einsum("x,y,z->xyz", _euler_spline_b(mesh[0], order),
                  _euler_spline_b(mesh[1], order),
                  _euler_spline_b(mesh[2], order))
    Gv = lattice.get_Gv(cell.a, mesh)
    absG2 = np.einsum("gi,gi->g", Gv, Gv)
    absG2[absG2 == 0] = 1e200
    C = (4 * np.pi / absG2 / cell.vol
         * np.exp(-absG2 / (4 * ew_eta**2))).reshape(mesh)
    BC = torch.as_tensor(B * C, **f64)
    tmp = torch.fft.fftn(BC * torch.fft.ifftn(Q)).real
    return float(0.5 * np.prod(mesh) * torch.sum(Q * tmp))


def particle_mesh_ewald(cell, ew_eta=None, ew_cut=None, order: int = 10,
                        device=None) -> float:
    """Nuclear-repulsion Ewald energy with the PME reciprocal sum on
    ``device`` (default: the GPU).

    Matches :func:`pyscf_isdf_tpu_torch.ops.coulomb.ewald` (the exact
    structure-factor sum) to about cell.precision; 3-D only, like the
    reference (ewald_methods.py:125).
    """
    if cell.dimension != 3:
        raise NotImplementedError("particle-mesh Ewald is 3D only")
    if ew_eta is None or ew_cut is None:
        ew_eta, ew_cut = coulomb.ewald_params(cell)
    chargs = cell.charges
    coords = cell.coords
    Lall = lattice.lattice_images(cell.a, ew_cut, cell.dimension)
    rLij = coords[:, None, :] - coords[None, :, :] + Lall[:, None, None, :]
    r = np.sqrt(np.einsum("Lijx,Lijx->Lij", rLij, rLij))
    r[r < 1e-16] = 1e200
    ewovrl = 0.5 * np.einsum("i,j,Lij->", chargs, chargs, erfc(ew_eta * r) / r)
    ewself = -0.5 * np.dot(chargs, chargs) * 2 * ew_eta / np.sqrt(np.pi)
    ewself += -0.5 * np.sum(chargs) ** 2 * np.pi / (ew_eta**2 * cell.vol)

    log_precision = np.log(cell.precision
                           / (max(np.abs(chargs).sum(), 1.0) * 16 * np.pi**2))
    mesh = lattice.cutoff_to_mesh(cell.a, -2 * ew_eta**2 * log_precision)
    ewg = pme_reciprocal(cell, ew_eta, mesh, order=order, device=device)
    return float(ewovrl + ewself + ewg)

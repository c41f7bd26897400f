"""Distributed 3-D FFT and Poisson solve over the ranks of a process group.

Slab decomposition: grid-flat arrays (C order, x slowest) split into
contiguous x-slabs, one per rank. The 3-D transform is

    local FFT(y, z) on (nx/P, ny, nz)
    all_to_all transpose  ->  (nx, ny/P, nz)
    local FFT(x)

and the Poisson solve multiplies by the Coulomb kernel in the transposed
layout before inverting. The functions run on each rank's local slab with
the rank's :class:`~pyscf_isdf_tpu_torch.parallel.mesh.RankGroup`; slabs
carry an optional leading batch axis.
"""
from __future__ import annotations

import torch


def coulG_transposed_layout(coulG, mesh3):
    """Rearrange a (ngrids,) G-space kernel into the mid-transform layout:
    global shape (ny, nx, nz) flattened, so that rank r's x-slab of the
    result (:func:`~pyscf_isdf_tpu_torch.parallel.mesh.slab_rows`) is its
    y-slab of the transposed layout."""
    nx, ny, nz = mesh3
    return coulG.reshape(nx, ny, nz).transpose(0, 1).reshape(-1)


def _y_to_x(f, group):
    """(b..., nx/P, ny, nz) -> (b..., nx, ny/P, nz): split y, gather x."""
    P = group.world
    *batch, nxl, ny, nz = f.shape
    nb = len(batch)
    f = f.reshape(*batch, nxl, P, ny // P, nz)
    f = f.movedim(nb + 1, 0)                       # (P, b..., nxl, nyl, nz)
    f = group.all_to_all(f)                        # chunk s from rank s
    f = f.movedim(0, nb)                           # (b..., P, nxl, nyl, nz)
    return f.reshape(*batch, P * nxl, ny // P, nz)


def _x_to_y(f, group):
    """(b..., nx, ny/P, nz) -> (b..., nx/P, ny, nz): split x, gather y."""
    P = group.world
    *batch, nx, nyl, nz = f.shape
    nb = len(batch)
    f = f.reshape(*batch, P, nx // P, nyl, nz)
    f = f.movedim(nb, 0)                           # (P, b..., nxl, nyl, nz)
    f = group.all_to_all(f)
    f = f.movedim(0, nb + 1)                       # (b..., nxl, P, nyl, nz)
    return f.reshape(*batch, nx // P, P * nyl, nz)


def fft3_slab(f_slab, mesh3, group):
    """Forward 3-D FFT of x-slab data; returns the (x-full, y-split) layout.

    Args:
        f_slab: (..., nx/P * ny * nz) complex, this rank's x-slab, flat.
    Returns:
        (..., nx, ny/P, nz): the transposed layout [x, y_local, z].
    """
    nx, ny, nz = mesh3
    batch = f_slab.shape[:-1]
    nxl = f_slab.shape[-1] // (ny * nz)
    f = torch.fft.fftn(f_slab.reshape(*batch, nxl, ny, nz), dim=(-2, -1))
    f = _y_to_x(f, group)
    return torch.fft.fft(f, dim=len(batch))        # over the full x


def ifft3_slab(fG_t, mesh3, group):
    """Inverse of :func:`fft3_slab`: (..., nx, ny/P, nz) back to flat x-slabs."""
    nb = fG_t.dim() - 3
    f = torch.fft.ifft(fG_t, dim=nb)
    f = _x_to_y(f, group)
    f = torch.fft.ifftn(f, dim=(-2, -1))
    return f.reshape(*fG_t.shape[:-3], -1)


def _kernel_slab(coulG_t_slab, mesh3):
    nx, _, nz = mesh3
    nyl = coulG_t_slab.shape[-1] // (nx * nz)
    return coulG_t_slab.reshape(nyl, nx, nz).transpose(0, 1)   # [x, yl, z]


def poisson_slab(rho_slab, coulG_t_slab, mesh3, group):
    """V = ifft(coulG * fft(rho)) with every array in x-slab layout (real).

    ``coulG_t_slab`` is this rank's slab of :func:`coulG_transposed_layout`.
    """
    cdtype = torch.complex128 if rho_slab.dtype == torch.float64 else torch.complex64
    fG = fft3_slab(rho_slab.to(cdtype), mesh3, group)
    fG = fG * _kernel_slab(coulG_t_slab, mesh3)
    return ifft3_slab(fG, mesh3, group).real.to(rho_slab.dtype)


def poisson_slab_c(f_slab, coulG_t_slab, mesh3, group):
    """Complex Poisson solve V = ifft(coulG * fft(f)) in x-slab layout.

    Unlike :func:`poisson_slab` the result keeps its imaginary part: the
    q != 0 kernels of the k-point ISDF W build, where coulG(q+G) is not
    inversion-symmetric, need it."""
    fG = fft3_slab(f_slab, mesh3, group)
    fG = fG * _kernel_slab(coulG_t_slab, mesh3)
    return ifft3_slab(fG, mesh3, group)

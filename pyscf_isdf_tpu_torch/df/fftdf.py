"""FFT-based density fitting: plane-wave Poisson J and K builds (torch).

The numerics oracle of the framework and the J engine of the SCF loop
(algorithmic contract per the reference pyscf/pbc/df/fft_jk.py:33-109 for J
and :177-302 for K). ISDF replaces the K build; J stays O(N log N) here.

The FFT grid axis is kept flat (ngrids,) at the API and reshaped to the 3-D
mesh only around the transforms.

Conventions (reference pyscf/pbc/tools/pbc.py:149-228), the defaults of
``torch.fft``: fft is unnormalized, ifft carries 1/N;
V(r) = ifft(coulG * fft(rho)) exactly (the 1/vol of the Fourier series
cancels the vol/N of the forward-transform quadrature), and matrix
elements take one grid weight vol/ngrids.
"""
from __future__ import annotations

import torch


def _complex(f):
    return f.to(torch.complex128 if f.dtype == torch.float64 else torch.complex64)


def fft3(f, mesh):
    """3-D FFT over the flattened last axis."""
    shape = f.shape
    f3 = f.reshape(shape[:-1] + tuple(mesh))
    return torch.fft.fftn(f3, dim=(-3, -2, -1)).reshape(shape)


def ifft3(f, mesh):
    shape = f.shape
    f3 = f.reshape(shape[:-1] + tuple(mesh))
    return torch.fft.ifftn(f3, dim=(-3, -2, -1)).reshape(shape)


def get_rho(aoR, dm):
    """Electron density on the grid: rho_g = sum_{ij} D_ij ao_i(g) ao_j(g)."""
    return ((aoR @ dm) * aoR).sum(-1)


def get_j(aoR, dm, coulG, mesh, weight):
    """Coulomb matrix via one FFT Poisson solve (Gamma point).

    vj_ij = w * sum_g ao_i(g) V(g) ao_j(g),  V = ifft(coulG * fft(rho)).
    """
    rho = get_rho(aoR, dm)
    vR = ifft3(coulG * fft3(_complex(rho), mesh), mesh).real
    return weight * ((aoR.T * vR) @ aoR)


def get_k(aoR, dm, coulG, mesh, weight, chunk: int = 16):
    """Exchange matrix via pair-density FFTs (Gamma point, real AOs).

    rho1[i,l,g] = ao_i(g) ao_l(g);  vR = ifft(coulG fft(rho1));
    vk[i,j] = w sum_g (sum_l vR[i,l,g] aoD[l,g]) ao_j(g), ``chunk`` AO
    rows i at a time. This is the O(nao^2 ngrids log ngrids) cost that the
    ISDF engine amortizes away; kept as the numerics oracle.
    """
    aoT = aoR.T                                               # (nao, ng)
    aoD = dm @ aoT                                            # (nao, ng)
    rows = []
    for i0 in range(0, aoT.shape[0], chunk):
        rho1 = aoT[i0:i0 + chunk, None, :] * aoT[None, :, :]  # (b, nao, ng)
        vR = ifft3(coulG * fft3(_complex(rho1), mesh), mesh).real
        rows.append(torch.einsum("ilg,lg->ig", vR, aoD))
    return weight * (torch.cat(rows) @ aoR)


def get_k_occ(aoR, mo_w, coulG, mesh, weight, chunk: int = 16):
    """Exchange via occupied-MO pair-density FFTs (Gamma point).

    The reference's tagged-DM fast path (pyscf/pbc/df/fft_jk.py:235-259):
    nao*nocc grid FFTs per build instead of nao^2.

    Args:
        mo_w: (ng, nocc) occupied MOs on the grid, each scaled by
            sqrt(occ) — K[dm] with dm = (C*occ) C^T exactly.
    """
    aoT = aoR.T
    moT = mo_w.T                                              # (no, ng)
    rows = []
    for i0 in range(0, aoT.shape[0], chunk):
        rho1 = aoT[i0:i0 + chunk, None, :] * moT[None, :, :]  # (b, no, ng)
        vR = ifft3(coulG * fft3(_complex(rho1), mesh), mesh).real
        rows.append(torch.einsum("big,ig->bg", vR, moT))
    return weight * (torch.cat(rows) @ aoR)


def apply_ewald_exxdiv(vk, dm, ovlp, madelung):
    """Probe-charge G=0 exchange correction: vk += madelung * S D S
    (reference pyscf/pbc/df/df_jk.py:1446)."""
    return vk + madelung * (ovlp @ dm @ ovlp)

"""AFTDF: analytic-Fourier-transform density fitting J/K engine (torch).

Reference counterpart: pyscf/pbc/df/aft.py:566 + aft_jk.py:41,135. Pair
densities are represented by their analytic Fourier coefficients
(:func:`~pyscf_isdf_tpu_torch.ops.ft_ao.ft_aopair`, the Gaussian product
theorem with Hermite closed forms, host float64) instead of grid
collocation, so accuracy is set by the G cutoff alone:

    J_mn = (1/vol) sum_G conj(A[G,mn]) v(G) rho(G),  rho = sum A D
    K_mn = (1/vol) sum_G v(G) [conj(A_G) D A_G^T]_mn

with A = ft_aopair. ``exxdiv='ewald'`` rides the kernel's G=0
coefficient: A(G=0) is the overlap matrix, so the Madelung term is the
S D S shift. The pair transforms live on the device; J and K contract
them in chunks over G there.

Gamma point (:class:`AFTDF`) and k-sampled (:class:`KAFTDF`, the
reference's aft_jk.get_j_kpts/get_k_kpts through the Bloch-phased pair
transforms ``ft_aopair(kj=...)``).
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.ops import coulomb
from pyscf_isdf_tpu_torch.ops.ft_ao import ft_aopair


def _jk_chunks(A, dm, vG_j, vG_k, chunk):
    """J and K of one pair-transform tensor A (ng, nao, nao) against a
    density, kernels vG_j and vG_k (already divided by vol; None skips)."""
    vj = vk = None
    ng = A.shape[0]
    for g0 in range(0, ng, chunk):
        a = A[g0:g0 + chunk]
        if vG_j is not None:
            rho = torch.einsum("gij,ij->g", a, dm)
            t = torch.einsum("g,gij->ij", vG_j[g0:g0 + chunk] * rho, a.conj())
            vj = t if vj is None else vj + t
        if vG_k is not None:
            ad = a.conj() @ dm                                      # (g, m, s)
            t = torch.einsum("g,gms,gns->mn", vG_k[g0:g0 + chunk], ad, a)
            vk = t if vk is None else vk + t
    return vj, vk


class AFTDF:
    """Analytic-FT density fitting at Gamma. Build once per geometry; the
    pair transforms are held on ``device`` (default: the GPU)."""

    def __init__(self, cell, mesh=None, device=None):
        self.cell = cell
        self.device = resolve_device(device)
        self.mesh = tuple(mesh or cell.mesh)
        self.Gv = cell.get_Gv(self.mesh)
        self.pair = torch.as_tensor(ft_aopair(cell, self.Gv), device=self.device)

    def _kernel(self, exxdiv=None):
        g = coulomb.get_coulG(self.cell, mesh=self.mesh, Gv=self.Gv, exxdiv=exxdiv)
        return torch.as_tensor(g / self.cell.vol, dtype=torch.complex128,
                               device=self.device)

    def get_jk(self, dm, with_j=True, with_k=True, exxdiv=None,
               chunk: int = 2048):
        """(vj, vk) float64 of a real density (None for a part not asked)."""
        dm = torch.as_tensor(dm, device=self.device).to(torch.complex128)
        vj, vk = _jk_chunks(self.pair, dm, self._kernel() if with_j else None,
                            self._kernel(exxdiv) if with_k else None, chunk)
        return (vj.real if with_j else None), (vk.real if with_k else None)

    def get_eri(self, chunk: int = 2048):
        """AO ERIs (ij|kl) as an (nao^2, nao^2) matrix from analytic FTs."""
        nao = self.cell.nao
        v = self._kernel()
        out = torch.zeros((nao * nao, nao * nao), dtype=torch.complex128,
                          device=self.device)
        for g0 in range(0, self.Gv.shape[0], chunk):
            A = self.pair[g0:g0 + chunk].reshape(-1, nao * nao)
            out += A.conj().T @ (v[g0:g0 + chunk, None] * A)
        return out.real


class KAFTDF:
    """Analytic-FT J/K at sampled k-points (reference aft.py:566 +
    aft_jk.py:41,135 semantics).

    Per (k1, k2) the Bloch pair transform A[G,m,n] = int_cell
    conj(phi^{k1}_m) phi^{k2}_n e^{-i(q+G).r} dr (q = k2-k1) is built
    analytically; then

        rho(G)    = (1/nk) sum_k tr(A^{kk}[G] D^k)          (q = 0)
        J^k_mn    = (1/vol) sum_G v(G) rho(G) conj(A^{kk}[G,n,m])
        K^{k1}_mn = (1/(nk vol)) sum_{k2,G} v_q(G)
                      [A^{k1k2}[G] D^{k2} A^{k1k2}[G]^H]_mn

    with v_q = get_coulG(k=q, exxdiv, kpts) (wrap-around included).
    """

    def __init__(self, cell, kpts, mesh=None, device=None):
        self.cell = cell
        self.device = resolve_device(device)
        self.kpts = np.reshape(np.asarray(kpts, dtype=np.float64), (-1, 3))
        self.mesh = tuple(mesh or cell.mesh)
        self.Gv = cell.get_Gv(self.mesh)
        self._pair = {}

    def _A(self, k1, k2):
        if (k1, k2) not in self._pair:
            q = self.kpts[k2] - self.kpts[k1]
            self._pair[k1, k2] = torch.as_tensor(
                ft_aopair(self.cell, self.Gv, q=q, kj=self.kpts[k2]),
                device=self.device)
        return self._pair[k1, k2]

    def get_jk(self, dm_k, with_j=True, with_k=True, exxdiv=None, omega=None,
               chunk: int = 2048):
        """(vj, vk) (nk, nao, nao) complex128 (None for a part not asked)."""
        cell = self.cell
        nk = len(self.kpts)
        dm_k = torch.as_tensor(dm_k, device=self.device).to(torch.complex128)
        vj = vk = None
        if with_j:
            v = torch.as_tensor(coulomb.get_coulG(cell, mesh=self.mesh, Gv=self.Gv)
                                / cell.vol, dtype=torch.complex128, device=self.device)
            rho = sum(torch.einsum("gmn,nm->g", self._A(k, k), dm_k[k])
                      for k in range(nk)) / nk
            vrho = v * rho
            vj = torch.stack([torch.einsum("g,gnm->mn", vrho, self._A(k, k).conj())
                              for k in range(nk)])
        if with_k:
            vk = torch.zeros_like(dm_k)
            for k1 in range(nk):
                for k2 in range(nk):
                    q = self.kpts[k2] - self.kpts[k1]
                    vq = torch.as_tensor(
                        coulomb.get_coulG(cell, k=q, exxdiv=exxdiv, mesh=self.mesh,
                                          Gv=self.Gv, kpts=self.kpts, omega=omega)
                        / cell.vol, dtype=torch.complex128, device=self.device)
                    A = self._A(k1, k2)
                    for g0 in range(0, A.shape[0], chunk):
                        a = A[g0:g0 + chunk]
                        t = a @ dm_k[k2]                              # (g, m, s)
                        vk[k1] += torch.einsum("g,gms,gns->mn", vq[g0:g0 + chunk],
                                               t, a.conj()) / nk
        return vj, vk

"""ERIs and integral transforms on the FFT grid (torch).

Algorithmic contract per the reference pyscf/pbc/df/fft_ao2mo.py:45-342:
pair densities on the grid, one Poisson solve per pair, grid quadrature
for the second pair. The exact oracle of the MP2 energies.

    (pq|rs) = w * sum_g V_pq(g) rho_rs(g),
    V_pq = ifft(coulG * fft(rho_pq)),  rho_pq(g) = p(g) q(g)

Only the second pair block is formed whole: the first one is built
``chunk`` pairs at a time inside the loop, so at diamond 3x3x3
(110592 points, 108 x 108 MO pairs) the working set is the (ng, n3 n4)
block and the output instead of two 10 GB pair tables.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.kpts_helper import get_kconserv
from pyscf_isdf_tpu_torch.ops import coulomb
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def _pair_rows(m1T, m2T, p0, p1):
    """Rows p0:p1 of the (n1 n2, ng) pair table m1T[i] * m2T[j], p = i n2 + j."""
    p = torch.arange(p0, p1, device=m1T.device)
    n2 = m2T.shape[0]
    return m1T[p // n2] * m2T[p % n2]


def general(moR1, moR2, moR3, moR4, coulG, mesh, weight, chunk: int = 32,
            timer=None):
    """MO ERIs (12|34) for four real Gamma-point MO blocks on the grid.

    Args:
        moR1..4: (ng, n1..n4) MO values (moR = aoR @ C).
        timer: optional StageTimer; records each chunk's pair formation and
            FFT round trip as 'ao2mo fft' and its product with the second
            pair block as 'ao2mo gemm'.
    Returns the (n1*n2, n3*n4) ERI matrix.
    """
    timer = timer or null_timer
    ng = moR1.shape[0]
    n1, n2 = moR1.shape[1], moR2.shape[1]
    n3, n4 = moR3.shape[1], moR4.shape[1]
    cd = torch.complex128 if moR1.dtype == torch.float64 else torch.complex64
    rho34 = (moR3[:, :, None] * moR4[:, None, :]).reshape(ng, n3 * n4)
    m1T, m2T = moR1.T, moR2.T
    out = torch.empty((n1 * n2, n3 * n4), dtype=moR1.dtype, device=moR1.device)
    for p0 in range(0, n1 * n2, chunk):
        p1 = min(p0 + chunk, n1 * n2)
        with timer("ao2mo fft"):
            blk = _pair_rows(m1T, m2T, p0, p1)
            vR = ifft3(coulG * fft3(blk.to(cd), mesh), mesh).real
        with timer("ao2mo gemm"):
            out[p0:p1] = weight * (vR @ rho34)
    return out


def get_eri(aoR, coulG, mesh, weight, chunk: int = 32):
    """AO ERIs (ij|kl) as an (nao^2, nao^2) matrix (Gamma, real)."""
    return general(aoR, aoR, aoR, aoR, coulG, mesh, weight, chunk=chunk)


def general_kpts(moR_p, moR_q, moR_r, moR_s, coulG_q, expmiqr, mesh, weight,
                 chunk: int = 16):
    """k-point MO ERIs (p ki, q ka | r kj, s kb) with momentum transfer
    q = ka - ki (and kb fixed by conservation).

    Args:
        moR_p..s: (ng, n*) complex Bloch MO values at their k-points.
        coulG_q: (ng,) Coulomb kernel at q (wrap-around applied).
        expmiqr: (ng,) phases e^{-i q.r}.
    Returns (n1*n2, n3*n4) complex ERIs:
        w sum_g ifft(coulG_q fft(conj(p) q e^{-iqr}))(g) conj(r) s e^{+iqr}.
    """
    ng = moR_p.shape[0]
    n1, n2 = moR_p.shape[1], moR_q.shape[1]
    n3, n4 = moR_r.shape[1], moR_s.shape[1]
    rho2 = ((moR_r.conj()[:, :, None] * moR_s[:, None, :]).reshape(ng, n3 * n4)
            * expmiqr.conj()[:, None])
    m1T, m2T = moR_p.conj().T * expmiqr, moR_q.T
    out = torch.empty((n1 * n2, n3 * n4), dtype=rho2.dtype, device=rho2.device)
    for p0 in range(0, n1 * n2, chunk):
        p1 = min(p0 + chunk, n1 * n2)
        vR = ifft3(coulG_q * fft3(_pair_rows(m1T, m2T, p0, p1), mesh), mesh)
        out[p0:p1] = weight * (vR @ rho2)
    return out


class QKernels:
    """Per momentum transfer q = k_a - k_i: the Coulomb kernel coulG(q)
    (exxdiv=None, wrap-around) and the phases e^{-iq.r}, built on the host
    once per distinct q (125 for a 3x3x3 mesh, against 729 (ki, ka) pairs)
    and kept on the device."""

    def __init__(self, cell, kpts, device):
        self.cell = cell
        self.kpts = np.reshape(np.asarray(kpts, dtype=np.float64), (-1, 3))
        self.device = device
        self.coords = cell.uniform_grid()
        self._cache = {}

    def __call__(self, ki, ka):
        q = self.kpts[ka] - self.kpts[ki]
        key = tuple(np.round(q, 10))
        if key not in self._cache:
            coulG_q = coulomb.get_coulG(self.cell, k=q, exxdiv=None, kpts=self.kpts)
            self._cache[key] = (
                torch.as_tensor(coulG_q, dtype=torch.float64, device=self.device),
                torch.as_tensor(np.exp(-1j * self.coords @ q), device=self.device))
        return self._cache[key]


def get_eri_kpts(system, kpts_idx, chunk: int = 16, device=None):
    """Public 4-k-point AO ERIs (p k1, q k2 | r k3, s k4) on ``device``
    (default: the GPU), where ``system`` must live.

    The reference's FFTDF.get_eri k-point cases (pyscf/pbc/df/fft_ao2mo.py
    :45-99 — 0000/0011/0110/0123): momentum conservation
    k2 - k1 + k4 - k3 = G is required (ValueError otherwise). A nonzero G
    needs no explicit phase: both screened pair densities are periodic
    and the grid quadrature pairs every Fourier component.

    Returns the (nao^2, nao^2) complex ERI matrix in (12|34) chemist order.
    """
    require_device(system.aoR_k, device)
    k1, k2, k3, k4 = kpts_idx
    kpts, cell = system.kpts, system.cell
    cons = kpts[k4] - kpts[k3] + kpts[k2] - kpts[k1]
    frac = cons @ np.linalg.inv(lattice.reciprocal_vectors(cell.a))
    if not np.allclose(frac - np.round(frac), 0, atol=1e-8):
        raise ValueError("momentum conservation violated: k2-k1+k4-k3 != G")
    coulG_q, expmiqr = QKernels(cell, kpts, system.aoR_k.device)(k1, k2)
    ao = system.aoR_k
    return general_kpts(ao[k1], ao[k2], ao[k3], ao[k4], coulG_q, expmiqr,
                        tuple(system.mesh), system.weight, chunk=chunk)


def ao2mo_7d(system, mo_coeff_kpts, chunk: int = 16, device=None):
    """Full k-conserving MO ERI tensor (reference fft_ao2mo.py:342) on
    ``device`` (default: the GPU), where ``system`` must live.

    Args:
        mo_coeff_kpts: (nk, nao, nmo) MO coefficients at every k.
    Returns the (nk, nk, nk, nmo, nmo, nmo, nmo) complex tensor
    out[kp, kq, kr] = (p kp, q kq | r kr, s ks), ks fixed by momentum
    conservation.
    """
    dev = require_device(system.aoR_k, device)
    kpts = system.kpts
    nk = len(kpts)
    mo = [torch.as_tensor(m, device=dev).to(system.aoR_k.dtype) for m in mo_coeff_kpts]
    nmo = mo[0].shape[1]
    moR = [system.aoR_k[k] @ mo[k] for k in range(nk)]
    kconserv = get_kconserv(system.cell.a, kpts)
    qk = QKernels(system.cell, kpts, dev)
    out = torch.empty((nk, nk, nk, nmo, nmo, nmo, nmo), dtype=torch.complex128,
                      device=dev)
    for kp in range(nk):
        for kq in range(nk):
            coulG_q, expmiqr = qk(kp, kq)
            for kr in range(nk):
                ks = kconserv[kp, kq, kr]
                out[kp, kq, kr] = general_kpts(
                    moR[kp], moR[kq], moR[kr], moR[ks], coulG_q, expmiqr,
                    tuple(system.mesh), system.weight, chunk=chunk,
                ).reshape(nmo, nmo, nmo, nmo)
    return out

"""Exact-frequency-integration G0W0 oracle (dense dRPA diagonalization),
torch.

Reference contract: pyscf/gw/gw_exact.py, as the JAX package carries it
over (``pyscf_isdf_tpu/gw/gw_exact.py``): G0W0 with the screened
interaction expanded over the exact direct-RPA excitation spectrum
(Lehmann representation), so the frequency integral is analytic. It is
the oracle the production GW-AC path (gw/rgw.py) is held against.

Closed-shell spin-adapted dRPA:

    A = diag(d) + 2 K,   B = 2 K,   d_ia = e_a - e_i,
    K_ia,jb = (ia|jb)  (from the same whitened DF tensor as rgw.py)

Casida reduction: C = d^1/2 (d + 4K) d^1/2, Omega_v^2 = eig(C), (X+Y)_v
= d^1/2 Z_v / sqrt(Omega_v). Self-energy (eta -> 0+):

    Sigma_p(w) = sum_v [ sum_i t_{v,ip}^2 / (w - (e_i - Omega_v) - i eta)
                       + sum_a t_{v,ap}^2 / (w - (e_a + Omega_v) + i eta) ]
    t_{v,qp} = sqrt(2) sum_ia (X+Y)_{v,ia} (ia|qp).

The eigensolve, the transition densities and every Lehmann sum run on
the device of ``Lmo``; each Newton step of the QP solve reads one scalar
back.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.gw.rgw import _host, _mf_potentials, _on, build_lmo


def drpa_diagonalize(mo_energy, nocc: int, Lmo, eigvals_only: bool = False):
    """Dense direct-RPA spectrum on the device of ``Lmo``.

    Returns (omega, xpy, d, K) tensors:
        omega: (nov,) excitation energies
        xpy: (nov, nocc, nvir) X+Y with X^T X - Y^T Y = 1 (None with
            ``eigvals_only``, which takes the eigenvalues alone)
        d: (nov,) orbital-energy differences e_a - e_i
        K: (nov, nov) (ia|jb)
    """
    e = _on(mo_energy, Lmo.device)
    nmo = e.shape[0]
    nvir = nmo - nocc
    d = (e[None, nocc:] - e[:nocc, None]).reshape(-1)
    Lov = Lmo[:, :nocc, nocc:].reshape(Lmo.shape[0], -1).to(torch.float64)
    K = Lov.T @ Lov                                   # (nov, nov)
    sd = torch.sqrt(d)
    C = 4.0 * K
    C.diagonal().add_(d)
    C.mul_(sd[:, None]).mul_(sd[None, :])
    if eigvals_only:
        return torch.sqrt(torch.clamp(torch.linalg.eigvalsh(C), min=0.0)), None, d, K
    w2, Z = torch.linalg.eigh(C)
    del C
    omega = torch.sqrt(torch.clamp(w2, min=0.0))
    xpy = (sd[:, None] * Z) / torch.sqrt(omega)[None, :]   # (nov, nroots)
    return omega, xpy.T.reshape(-1, nocc, nvir), d, K


def _transition_densities(xpy, Lmo, nocc, cols):
    """t_{v,q,p} = sqrt(2) sum_ia (X+Y)_{v,ia} (ia|q p) for the columns p
    in ``cols``: (nexc, nmo, ncols)."""
    naux, nmo, _ = Lmo.shape
    Lov = Lmo[:, :nocc, nocc:].reshape(naux, -1)
    rho_v = xpy.reshape(xpy.shape[0], -1) @ Lov.T                 # (nexc, naux)
    Lc = Lmo[:, :, torch.as_tensor(cols, device=Lmo.device)].reshape(naux, -1)
    return (np.sqrt(2.0) * (rho_v @ Lc)).reshape(-1, nmo, len(cols))


def _lehmann(omega_p, e, nocc, omega, t2, eta, vir_sgn):
    evi = omega[:, None] - e[None, :nocc]             # Omega_v - e_i
    eva = omega[:, None] + e[None, nocc:]             # Omega_v + e_a
    sig = torch.sum(t2[:, :nocc] / (omega_p + evi - 1j * eta))
    sig = sig + torch.sum(t2[:, nocc:] / (omega_p - eva + vir_sgn * 1j * eta))
    return complex(sig)


def exact_sigma(omega_p, mo_energy, nocc, omega, tdm, p, eta=1e-6,
                vir_sgn=1.0):
    """Sigma_p(omega_p) from the Lehmann sum (gw_exact.py:117-126), on the
    device of ``tdm`` (nexc, nmo, nmo); a Python complex."""
    e = _on(mo_energy, tdm.device)
    t = tdm[:, :, p]
    return _lehmann(omega_p, e, nocc, _on(omega, tdm.device), t * t, eta, vir_sgn)


def gw_exact_gamma(system, res, xc=None, orbs=None, eta=1e-6, Lmo=None,
                   linearized=False, device=None):
    """Exact-frequency G0W0 QP energies (oracle; dense).

    Same inputs and Fock conventions as gw_ac_gamma, so the two paths are
    comparable orbital by orbital. Returns (qp (nmo,), converged)."""
    from scipy.optimize import newton

    require_device(system.aoR, device)
    mo_energy = _host(res["mo_energy"]).astype(np.float64)
    nmo = mo_energy.shape[0]
    nocc = system.nelec // 2
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)
    if Lmo is None:
        Lmo = build_lmo(system, res["mo_coeff"])

    omega, xpy, _, _ = drpa_diagonalize(mo_energy, nocc, Lmo)
    tdm = _transition_densities(xpy, Lmo, nocc, orbs)
    del xpy
    e = _on(mo_energy, Lmo.device)

    vx_mo, v_mf_mo = _mf_potentials(system, res, xc)

    qp = mo_energy.copy()
    conv = True
    for j, p in enumerate(orbs):
        t = tdm[:, :, j]
        t2 = t * t

        def sigma(w, t2=t2):
            return _lehmann(w, e, nocc, omega, t2, eta, 1.0).real

        def qp_eq(w, p=p, sigma=sigma):
            return w - mo_energy[p] - (sigma(w) + vx_mo[p] - v_mf_mo[p])

        if linearized:
            de = 1e-6
            s0 = sigma(mo_energy[p])
            z = 1.0 / (1.0 - (sigma(mo_energy[p] + de) - s0) / de)
            qp[p] = mo_energy[p] + z * (s0 + vx_mo[p] - v_mf_mo[p])
        else:
            try:
                qp[p] = newton(qp_eq, mo_energy[p], tol=1e-6, maxiter=100)
            except RuntimeError:
                conv = False
    return qp, conv


def rpa_ecorr_plasmon(mo_energy, nocc, Lmo) -> float:
    """Exact dRPA correlation energy by the plasmon formula
    Ec = 1/2 (sum_v Omega_v - tr A), A = diag(d) + 2K (eigenvalues
    only)."""
    omega, _, d, K = drpa_diagonalize(mo_energy, nocc, Lmo, eigvals_only=True)
    return float(0.5 * (omega.sum() - d.sum() - 2.0 * torch.trace(K)))

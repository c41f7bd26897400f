"""Gamma-point TDA / TDDFT (linear response) for closed-shell RHF/RKS.

Dense Casida formulation on the FFT grid (reference analog:
pyscf/pbc/tdscf/rks.py):

    A_ia,jb = d_ij d_ab (e_a - e_i) + fac (ia|jb) - hyb (ij|ab) + (ia|fxc|jb)
    B_ia,jb = fac (ia|bj) - hyb (ib|aj) + (ia|fxc|jb)

with fac = 2 (singlet) or 0 (triplet), ERIs from the grid transform
(df/fft_ao2mo) and the adiabatic LDA kernel from the second derivatives
of the spin-resolved energy density,

    fxc_singlet = f_aa + f_ab,   fxc_triplet = f_aa - f_ab,
    f_ss' = d^2 (rho exc(rho_a, rho_b)) / d rho_s d rho_s'  at rho/2,

the GGA kernel from the directional derivatives of the Vxc matrix
(:func:`~pyscf_isdf_tpu_torch.tdscf.response.linear_jvp`). TDA
diagonalizes A; full TDDFT solves Omega^2 = (A-B)^{1/2} (A+B) (A-B)^{1/2}.
The matrices and their eigensolves stay on the system's device.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import to_host as _host
from pyscf_isdf_tpu_torch.df import fft_ao2mo, fftdf
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.ops.xc import XCSpec, _max
from pyscf_isdf_tpu_torch.tdscf.response import xc_kernel

KXC_CHUNK = 16384   # grid points per chunk of the dense LDA kernel


def _fxc_lda(xcspec: XCSpec, rho):
    """(fxc_singlet(g), fxc_triplet(g)) for the adiabatic LDA kernel: the
    pointwise second derivatives of (ra + rb) exc(ra, rb) at ra = rb =
    max(rho, 1e-12)/2, by double autograd."""
    half = 0.5 * _max(rho.detach(), 1e-12)
    with torch.enable_grad():
        ra = half.clone().requires_grad_(True)
        rb = half.clone().requires_grad_(True)
        _, (va, _vb), _ = xcspec.exc_vxc_spin(ra, rb)
        faa, fab = torch.autograd.grad(va.sum(), (ra, rb))
    return faa + fab, faa - fab


def _build_matrices(system, scf_res, xc=None, singlet=True, nocc=None):
    """(A, B) (n_ov, n_ov) tensors on the system's device."""
    aoR = system.aoR
    dev, dt = aoR.device, aoR.dtype
    mo_e = torch.as_tensor(_host(scf_res["mo_energy"]), dtype=dt, device=dev)
    mo_c = torch.as_tensor(_host(scf_res["mo_coeff"]), dtype=dt, device=dev)
    if nocc is None:
        nocc = system.nelec // 2
    no, nv = nocc, mo_c.shape[1] - nocc
    xcspec = XCSpec(xc) if xc is not None else None
    hyb = 1.0 if xcspec is None else xcspec.hyb
    fac = 2.0 if singlet else 0.0

    moR = aoR @ mo_c
    moR_o, moR_v = moR[:, :no], moR[:, no:]
    coulG, mesh, w = system.coulG, system.mesh, system.weight

    iajb = fft_ao2mo.general(moR_o, moR_v, moR_o, moR_v, coulG, mesh, w) \
        .reshape(no, nv, no, nv)
    A = torch.diag((mo_e[None, no:] - mo_e[:no, None]).reshape(-1)).reshape(no, nv, no, nv)
    B = torch.zeros_like(A)
    if fac != 0.0:
        A = A + fac * iajb
        B = B + fac * iajb            # (ia|bj) == (ia|jb) for real orbitals
    if hyb > 0:
        ijab = fft_ao2mo.general(moR_o, moR_o, moR_v, moR_v, coulG, mesh, w) \
            .reshape(no, no, nv, nv)
        A = A - hyb * ijab.permute(0, 2, 1, 3)          # (ij|ab) -> ia,jb
        B = B - hyb * iajb.permute(0, 3, 2, 1)          # (ib|aj) -> ia,jb
        del ijab
    del iajb
    if xcspec is not None and xcspec.family == "lda":
        rho = fftdf.get_rho(aoR, torch.as_tensor(_host(scf_res["dm"]), dtype=dt, device=dev))
        fs, ft = _fxc_lda(xcspec, rho)
        fxc = fs if singlet else ft
        Kxc = torch.zeros((no * nv, no * nv), dtype=dt, device=dev)
        for g0 in range(0, rho.shape[0], KXC_CHUNK):
            P = (moR_o[g0:g0 + KXC_CHUNK, :, None]
                 * moR_v[g0:g0 + KXC_CHUNK, None, :]).reshape(-1, no * nv)
            Kxc += w * (P * fxc[g0:g0 + KXC_CHUNK, None]).T @ P
        A = A + Kxc.reshape(no, nv, no, nv)
        B = B + Kxc.reshape(no, nv, no, nv)
    elif xcspec is not None and xcspec.family == "gga":
        # dense GGA kernel from the directional derivatives of the Vxc
        # matrix, one per (j, b) pair: the tangent dmx + dmx^T of a unit
        # x_jb (the matrix-free path's convention, response.py)
        dm0 = torch.as_tensor(_host(scf_res["dm"]), dtype=dt, device=dev)
        kxc = xc_kernel(system, xcspec, dm0, singlet)
        Co, Cv = mo_c[:, :no], mo_c[:, no:]
        Kxc = torch.zeros((no, nv, no, nv), dtype=dt, device=dev)
        for j in range(no):
            for b in range(nv):
                dpair = torch.outer(Co[:, j], Cv[:, b])
                Kxc[:, :, j, b] = Co.T @ kxc(0.5 * (dpair + dpair.T)) @ Cv
        A = A + Kxc
        B = B + Kxc
    return A.reshape(no * nv, no * nv), B.reshape(no * nv, no * nv)


def tda_kernel(system, scf_res, xc=None, nstates=5, singlet=True):
    """TDA excitation energies (Hartree) and eigenvectors, numpy."""
    A, _ = _build_matrices(system, scf_res, xc=xc, singlet=singlet)
    e, v = torch.linalg.eigh(A)
    return e[:nstates].cpu().numpy(), v[:, :nstates].cpu().numpy()


def _dipole_states(mo_c, nocc, v, ops):
    """sqrt(2) sum_ia X_ia <i|op_x|a> per state for the AO operator
    matrices ``ops`` (3, nao, nao): (nstates, 3)."""
    Co, Cv = mo_c[:, :nocc], mo_c[:, nocc:]
    r_mo = torch.stack([Co.T @ op @ Cv for op in ops])             # (3, no, nv)
    X = torch.as_tensor(np.asarray(v), dtype=r_mo.dtype, device=r_mo.device)
    X = X.T.reshape(-1, nocc, Cv.shape[1])                         # (ns, no, nv)
    return (2.0 ** 0.5 * torch.einsum("nia,xia->nx", X, r_mo)).cpu().numpy()


def tda_oscillator_strengths(system, scf_res, e, v):
    """Length-gauge transition dipoles and oscillator strengths for TDA
    states. Needs a dimension-0 cell: the position operator is ill-defined
    along periodic dimensions (the velocity gauge is the periodic route).

    Returns (f (nstates,), mu (nstates, 3)):
        mu_n = sqrt(2) sum_ia X_ia <i|r - r_c|a>,   f_n = 2/3 E_n |mu_n|^2.
    """
    cell = system.cell
    if getattr(cell, "dimension", 3) != 0:
        raise NotImplementedError("length-gauge dipoles need dimension=0 cells")
    aoR = system.aoR.to(torch.float64)
    mo_c = torch.as_tensor(_host(scf_res["mo_coeff"]), dtype=aoR.dtype, device=aoR.device)
    nocc = system.nelec // 2
    coords = cell.uniform_grid()
    charges = np.asarray(cell.charges)
    center = charges @ cell.coords / charges.sum()
    # minimum-image coordinates about the charge center: AO tails wrap
    # across the box on the periodic grid (valid while the molecule fits
    # in half the box)
    frac = (coords - center) @ np.linalg.inv(cell.a)
    rel = torch.as_tensor((frac - np.round(frac)) @ cell.a, dtype=aoR.dtype,
                          device=aoR.device)
    ops = [(aoR.T * (system.weight * rel[:, x])) @ aoR for x in range(3)]
    mu = _dipole_states(mo_c, nocc, v, ops)
    f = 2.0 / 3.0 * np.asarray(e) * np.sum(mu * mu, axis=1)
    return f, mu


def tda_oscillator_strengths_velocity(system, scf_res, e, v):
    """Velocity-gauge transition moments and oscillator strengths for TDA
    states, the gauge that is well-defined for periodic cells (-i grad is
    lattice-periodic, unlike r):

        P_n = sqrt(2) sum_ia X_ia <i| -i grad |a>,   f_n = 2/(3 E_n) |P_n|^2.

    Returns (f (nstates,), P (nstates, 3) with the -i factored out: the
    stored P is real and the physical moment is -i P).
    """
    aoR = system.aoR.to(torch.float64)
    mo_c = torch.as_tensor(_host(scf_res["mo_coeff"]), dtype=aoR.dtype, device=aoR.device)
    nocc = system.nelec // 2
    Gv = torch.as_tensor(system.cell.get_Gv(system.mesh), dtype=aoR.dtype,
                         device=aoR.device)
    ao_grad = ao_gradient_fft(aoR, tuple(system.mesh), Gv)             # (3, ng, nao)
    ops = [system.weight * (aoR.T @ ao_grad[x]) for x in range(3)]
    P = _dipole_states(mo_c, nocc, v, ops)
    f = 2.0 / 3.0 / np.maximum(np.asarray(e), 1e-12) * np.sum(P * P, axis=1)
    return f, P


def tddft_kernel(system, scf_res, xc=None, nstates=5, singlet=True):
    """Full linear-response (Casida) excitation energies (Hartree), numpy."""
    A, B = _build_matrices(system, scf_res, xc=xc, singlet=singlet)
    w_, u = torch.linalg.eigh(A - B)
    # (A-B)^(1/2) from the symmetric eigendecomposition
    sq = (u * torch.sqrt(torch.clamp(w_, min=1e-14))) @ u.T
    del u
    om2 = torch.linalg.eigvalsh(sq @ (A + B) @ sq)
    return torch.sqrt(torch.clamp(om2, min=0.0))[:nstates].cpu().numpy()

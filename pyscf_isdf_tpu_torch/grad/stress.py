"""Stress tensor by strain autograd (Gamma point).

sigma_ab = (1/vol) dE/d eps_ab at the SCF stationary point, with the whole
energy functional re-parameterized by a symmetric strain eps: positions,
grid points and lattice images scale as (1+eps) r, reciprocal vectors as
(1+eps)^-T G, the volume as det(1+eps) vol0, so every lattice-derived
constant (Coulomb kernels, S/T quadrature, GTH form factors, Ewald) is a
traced function of eps and one backward pass gives the 3x3 tensor. The AO
values take the strain through
:func:`~pyscf_isdf_tpu_torch.ops.ao_eval.eval_ao_positions`, whose
backward pulls the cotangent back onto the points, the images and the
positions (the image-resolved first moment of the lattice sum).
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.device import require_device, to_host as _host
from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.grad.rhf import (ST_CHUNK, _ft_factors, _tensor, _vnl_energy,
                                           _vnl_tables, chunked_sum, pair_exchange,
                                           value_and_grad_at)
from pyscf_isdf_tpu_torch.ops import coulomb, pp as pp_ops
from pyscf_isdf_tpu_torch.ops.ao_eval import (PackedBasis, ao_gradient_fft,
                                              eval_ao_positions, shell_rcut)
from pyscf_isdf_tpu_torch.ops.ft_ao import converged_st_mesh
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.hf import rsh_coeffs


def _ft_ao_torch(cell, Gv, positions):
    """Analytic AO FTs with both the G vectors and the positions traced,
    (ng, nao) complex."""
    f, ao_atom = _ft_factors(cell, Gv)
    ph = torch.exp(-1j * (Gv @ positions.T))
    return f * ph[:, torch.as_tensor(ao_atom, device=Gv.device)]


def _gth_vlocG_torch(cell, G2):
    """(natm, ng) local GTH v_loc(G) with G2 traced (3D branch of
    ops/pp.gth_vlocG)."""
    if cell.dimension != 3:
        raise NotImplementedError("strained local PP: 3D cells only")
    small = G2 < 1e-12
    coulG = torch.where(small, 0.0, 4 * np.pi / torch.where(small, 1.0, G2))
    rows = []
    for ia in range(cell.natm):
        Z = cell.charges[ia]
        pp = cell.pseudos.get(cell.symbols[ia])
        if pp is None:
            rows.append(Z * coulG)
            continue
        rloc = pp.rloc
        v = Z * coulG * torch.exp(-0.5 * rloc**2 * G2)
        v = torch.where(small, -2 * np.pi * Z * rloc**2, v)
        G2r = G2 * rloc**2
        cexp = pp.cexp
        cf = 0.0
        if len(cexp) >= 1:
            cf = cf + cexp[0]
        if len(cexp) >= 2:
            cf = cf + cexp[1] * (3 - G2r)
        if len(cexp) >= 3:
            cf = cf + cexp[2] * (15 - 10 * G2r + G2r**2)
        if len(cexp) >= 4:
            cf = cf + cexp[3] * (105 - 105 * G2r + 21 * G2r**2 - G2r**3)
        rows.append(v - (2 * np.pi) ** 1.5 * rloc**3 * torch.exp(-0.5 * G2r) * cf)
    return torch.stack(rows)


def _vppnl_energy_torch(cell, Gv, aokG, SI, dm, vol):
    """Tr(D vppnl) with traced G vectors (the torch form of
    ops/pp.get_vppnl)."""
    return _vnl_energy(_vnl_tables(cell, Gv), SI, aokG, dm, vol)


def _madelung_lr_mesh(a, omega_abs, precision):
    """Nonzero G vectors (host) of the madelung_omega sum of the lattice
    ``a`` (the precision-driven mesh of ops/coulomb.madelung_omega, padded
    by 10% for the strain)."""
    ecut = 10.0
    for _ in range(2):
        ecut = np.log(16 * np.pi**2 / (2 * omega_abs**2 * np.sqrt(2 * ecut))
                      / precision + 1.0) * 2 * omega_abs**2
    Gv = lattice.get_Gv(a, lattice.cutoff_to_mesh(a, ecut * 1.1))
    return Gv[np.einsum("gi,gi->g", Gv, Gv) > 1e-12]


def _madelung_lr(Gml, omega_abs, vol):
    """Traced madelung_omega: 2w/sqrt(pi) - (1/vol) sum_{G!=0} 4pi/G^2
    e^{-G^2/4w^2} on the (strained) G vectors ``Gml``."""
    G2 = (Gml * Gml).sum(1)
    return 2 * omega_abs / np.sqrt(np.pi) \
        - (4 * np.pi / G2 * torch.exp(-0.25 / omega_abs**2 * G2)).sum() / vol


class _StrainEwald:
    """Ewald statics of the unstrained cell (eta and the image and G
    sets, padded for the strain: any valid eta gives the same total) and
    the traced nuclear and probe-charge energies."""

    def __init__(self, cell, device):
        f64 = dict(dtype=torch.float64, device=device)
        self.eta, ew_cut = coulomb.ewald_params(cell)
        self.L0 = torch.as_tensor(lattice.lattice_images(cell.a, 1.06 * ew_cut, 3), **f64)
        log_prec = np.log(cell.precision / (max(np.abs(cell.charges).sum(), 1.0)
                                            * 16 * np.pi**2))
        mesh_e = lattice.cutoff_to_mesh(cell.a, -2 * self.eta**2 * log_prec * 1.1)
        Gv = lattice.get_Gv(cell.a, mesh_e)
        self.G0 = torch.as_tensor(Gv[np.einsum("gi,gi->g", Gv, Gv) > 1e-12], **f64)
        self.charges = torch.as_tensor(cell.charges, **f64)
        self.self_q = -0.5 * float(cell.charges @ cell.charges) * 2 * self.eta / np.sqrt(np.pi)
        self.sumq2 = float(cell.charges.sum()) ** 2

    def energy(self, pos, F, Finv, vol):
        q, eta = self.charges, self.eta
        d = pos[None, :, None, :] - pos[None, None, :, :] + (self.L0 @ F.T)[:, None, None, :]
        r2 = (d * d).sum(-1)
        tiny = r2 < 1e-16
        r = torch.sqrt(torch.where(tiny, 1.0, r2))
        ovrl = 0.5 * (q[:, None] * q[None, :]
                      * torch.where(tiny, 0.0, torch.special.erfc(eta * r) / r)).sum()
        G = self.G0 @ Finv
        G2 = (G * G).sum(1)
        ZSI = (q[None, :] * torch.exp(-1j * (G @ pos.T))).sum(1)
        ewg = 0.5 * ((ZSI.real ** 2 + ZSI.imag ** 2) * torch.exp(-G2 / (4 * eta**2))
                     * 4 * np.pi / G2).sum() / vol
        return ovrl + ewg + self.self_q - 0.5 * self.sumq2 * np.pi / (eta**2 * vol)

    def madelung(self, F, Finv, vol):
        """-2x the Ewald energy of one unit probe charge on the strained
        lattice (exact for an anisotropic strain)."""
        eta = self.eta
        L = self.L0 @ F.T
        r2 = (L * L).sum(-1)
        ok = r2 > 1e-16
        r = torch.sqrt(torch.where(ok, r2, 1.0))
        ovrl = 0.5 * torch.where(ok, torch.special.erfc(eta * r) / r, 0.0).sum()
        G = self.G0 @ Finv
        G2 = (G * G).sum(1)
        ewg = 0.5 * (torch.exp(-G2 / (4 * eta**2)) * 4 * np.pi / G2).sum() / vol
        return -2.0 * (ovrl + ewg - eta / np.sqrt(np.pi) - 0.5 * np.pi / (eta**2 * vol))


def make_strain_energy_fn(system, xc=None, exxdiv="ewald", spin=False):
    """Strain-traced total-energy functional.

    The returned function is spin-resolved,
    ``energy(eps, dm_a, dm_b, w_mat, mo_a, mo_b)``: closed-shell callers
    pass dm/2 twice and the (unit-weight) occupied orbitals twice, and the
    per-spin exchange then reduces exactly to the restricted expression.
    ``spin=True`` switches the XC to the spin-resolved functional
    (UKS/ROKS); with ``spin=False`` the restricted one is kept.
    """
    cell = system.cell
    if cell.dimension != 3:
        raise NotImplementedError("stress: 3D cells")
    dev = system.aoR.device
    f64 = dict(dtype=torch.float64, device=dev)
    mesh = tuple(system.mesh)
    ngrids = float(np.prod(mesh))
    xcspec = XCSpec(xc) if xc is not None else None
    if xcspec is not None and xcspec.family == "hf":
        xcspec = None
    if xcspec is not None and xcspec.family == "mgga":
        raise NotImplementedError("stress of a meta-GGA")
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    omega_abs = abs(float(omega))
    if rsh:
        Gml0 = torch.as_tensor(_madelung_lr_mesh(cell.a, omega_abs,
                                                 getattr(cell, "precision", 1e-8)), **f64)

    packed = PackedBasis.from_cell(cell)
    rcut = max(shell_rcut(sh) for sh in cell.shells)
    L0 = torch.as_tensor(lattice.lattice_images(cell.a, 1.06 * rcut, 3), **f64)
    coords0 = torch.as_tensor(cell.uniform_grid(), **f64)
    R0 = torch.as_tensor(cell.coords, **f64)
    Gv0 = torch.as_tensor(cell.get_Gv(cell.mesh), **f64)
    Gv_st0 = torch.as_tensor(lattice.get_Gv(cell.a, converged_st_mesh(cell)), **f64)
    n_st = -(-Gv_st0.shape[0] // ST_CHUNK)
    vol0 = cell.vol
    has_pp = bool(cell.pseudos)
    if has_pp:
        alpha0 = torch.as_tensor([float(np.sum(pp_ops.gth_alphas(cell)))],
                                 dtype=torch.complex128, device=dev)
    charges = torch.as_tensor(cell.charges, **f64)
    ewald = _StrainEwald(cell, dev)

    def st_chunk(c, pos, Finv, vol):
        G = Gv_st0[c * ST_CHUNK:(c + 1) * ST_CHUNK] @ Finv
        aoG = _ft_ao_torch(cell, G, pos)
        S = (aoG.conj().T @ aoG).real / vol
        T = ((aoG.conj() * (0.5 * (G * G).sum(1))[:, None]).T @ aoG).real / vol
        return S, T

    def energy(eps, dm_a, dm_b, w_mat, mo_a, mo_b):
        dm = dm_a + dm_b
        F = torch.eye(3, **f64) + eps
        Finv = torch.linalg.inv(F)
        vol = vol0 * torch.linalg.det(F)
        weight = vol / ngrids
        pos = R0 @ F.T
        Gv = Gv0 @ Finv                       # rows G -> F^-T G
        G2 = (Gv * Gv).sum(1)
        small = G2 < 1e-12
        coulG = torch.where(small, 0.0, 4 * np.pi / torch.where(small, 1.0, G2))

        cell_e = replace(cell, a=cell.a @ F.detach().cpu().numpy().T)
        aoR = eval_ao_positions(packed, coords0 @ F.T, L0 @ F.T, pos, cell=cell_e)
        S, T = chunked_sum(st_chunk, n_st, pos, Finv, vol)

        t = aoR @ dm
        rho = (t * aoR).sum(-1)
        e1 = (dm * T).sum()
        SI = torch.exp(-1j * (Gv @ pos.T)).T                # (natm, ng)
        if has_pp:
            vpplocG = -(SI * _gth_vlocG_torch(cell, G2)).sum(0)
            vpplocG = torch.cat([alpha0, vpplocG[1:]])
            # matrix elements carry w N/vol = 1: the ifft's 1/N and the
            # quadrature weight cancel at any strain, no explicit vol
            vR = ifft3(vpplocG, mesh).real
            e1 = e1 + (rho * vR).sum()
            aokG = _ft_ao_torch(cell, Gv, pos) / torch.sqrt(vol)
            e1 = e1 + _vppnl_energy_torch(cell, Gv, aokG, SI, dm, vol)
        else:
            vneR = ifft3(-(charges.to(SI.dtype) @ SI) * coulG, mesh).real
            e1 = e1 + (rho * vneR).sum()

        vR_h = ifft3(coulG * fft3(rho.to(torch.complex128), mesh), mesh).real
        e_coul = 0.5 * weight * (rho * vR_h).sum()

        e_xc = 0.0
        if xcspec is not None:
            if spin:
                ta, tb = aoR @ dm_a, aoR @ dm_b
                rho_a, rho_b = (ta * aoR).sum(-1), (tb * aoR).sum(-1)
            if xcspec.family == "gga":
                # spectral gradient with the strained G vectors
                grad_ao = ao_gradient_fft(aoR, mesh, Gv)      # (3, ng, nao)
                if spin:
                    ga = 2.0 * torch.einsum("gi,xgi->xg", ta, grad_ao)
                    gb = 2.0 * torch.einsum("gi,xgi->xg", tb, grad_ao)
                    exc, _, _ = xcspec.exc_vxc_spin(rho_a, rho_b, (ga * ga).sum(0),
                                                    (ga * gb).sum(0), (gb * gb).sum(0))
                else:
                    grad_rho = 2.0 * torch.einsum("gi,xgi->xg", t, grad_ao)
                    exc, _, _ = xcspec.exc_vxc(rho, (grad_rho * grad_rho).sum(0))
            elif spin:
                exc, _, _ = xcspec.exc_vxc_spin(rho_a, rho_b)
            else:
                exc, _, _ = xcspec.exc_vxc(rho)
            e_xc = weight * (rho * exc).sum()

        e_k = 0.0
        if need_k:
            kern = hyb * coulG
            if rsh:
                kern = kern + (alpha - hyb) * coulG * torch.exp(-0.25 / omega_abs**2 * G2)
            ex = 0.0
            for mo_s in (mo_a, mo_b):
                if mo_s.shape[1]:
                    ex = ex + weight * pair_exchange(aoR @ mo_s, kern, mesh)
            if exxdiv == "ewald":
                mad_eps = hyb * ewald.madelung(F, Finv, vol)
                if rsh:
                    mad_eps = mad_eps + (alpha - hyb) * _madelung_lr(Gml0 @ Finv,
                                                                     omega_abs, vol)
                for dm_s in (dm_a, dm_b):
                    dms = dm_s @ S
                    ex = ex + mad_eps * (dms * dms.T).sum()
            e_k = -0.5 * ex

        e_pulay = -(w_mat * S).sum()
        return e1 + e_coul + e_xc + e_k + ewald.energy(pos, F, Finv, vol) + e_pulay

    return energy


def _stress_from_spin_state(system, xc, exxdiv, dm_a, dm_b, w_mat, mo_a, mo_b,
                            return_energy, spin):
    e_fn = make_strain_energy_fn(system, xc=xc, exxdiv=exxdiv, spin=spin)
    g, e_tot = value_and_grad_at(e_fn, torch.zeros((3, 3), dtype=torch.float64,
                                                   device=w_mat.device),
                                 (dm_a, dm_b, w_mat, mo_a, mo_b), float((w_mat * system.S).sum()))
    sigma = 0.5 * (g + g.T) / system.cell.vol
    return (sigma, e_tot, g) if return_energy else sigma


def stress_tensor(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                  device=None):
    """3x3 stress tensor sigma = (1/vol) dE/d eps (symmetrized) for a
    converged Gamma closed-shell SCF; with ``return_energy`` (sigma,
    e_tot, dE/d eps). Runs on ``device`` (default: the GPU)."""
    dev = require_device(system.aoR, device)
    mo_e = _host(scf_res["mo_energy"])
    mo_c = _host(scf_res["mo_coeff"])
    nocc = system.nelec // 2
    dm = _tensor(_host(scf_res["dm"]), dev)
    c_occ = _tensor(mo_c[:, :nocc], dev)
    w_mat = _tensor(2.0 * (mo_c[:, :nocc] * mo_e[:nocc]) @ mo_c[:, :nocc].T, dev)
    return _stress_from_spin_state(system, xc, exxdiv, 0.5 * dm, 0.5 * dm, w_mat,
                                   c_occ, c_occ, return_energy, spin=False)


def ustress_tensor(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                   device=None):
    """3x3 stress tensor for a converged Gamma UHF/UKS state (canonical
    per-spin Pulay weight W = sum_s C_s eps_s C_s^T over occupieds)."""
    from pyscf_isdf_tpu_torch.grad.uhf import _spin_counts

    dev = require_device(system.aoR, device)
    na, nb = _spin_counts(system)
    ea, eb = (_host(e) for e in scf_res["mo_energy"])
    ca, cb = (_host(c) for c in scf_res["mo_coeff"])
    dm_a, dm_b = (_tensor(_host(d), dev) for d in scf_res["dm"])
    w_mat = _tensor((ca[:, :na] * ea[:na]) @ ca[:, :na].T
                    + (cb[:, :nb] * eb[:nb]) @ cb[:, :nb].T, dev)
    return _stress_from_spin_state(system, xc, exxdiv, dm_a, dm_b, w_mat,
                                   _tensor(ca[:, :na], dev), _tensor(cb[:, :nb], dev),
                                   return_energy, spin=True)


def rostress_tensor(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                    device=None):
    """3x3 stress tensor for a converged Gamma ROHF/ROKS state
    (non-canonical Pulay weight W = sum_s D_s F_s D_s with the converged
    per-spin Focks, reference pyscf/grad/rohf.py:29)."""
    from pyscf_isdf_tpu_torch.grad.uhf import _spin_counts

    dev = require_device(system.aoR, device)
    na, nb = _spin_counts(system)
    C = _host(scf_res["mo_coeff"])
    dm_a, dm_b = (_tensor(_host(d), dev) for d in scf_res["dm"])
    fa, fb = (_tensor(_host(f), dev) for f in scf_res["fock"])
    w_mat = dm_a @ fa @ dm_a + dm_b @ fb @ dm_b
    return _stress_from_spin_state(system, xc, exxdiv, dm_a, dm_b, w_mat,
                                   _tensor(C[:, :na], dev), _tensor(C[:, :nb], dev),
                                   return_energy, spin=True)

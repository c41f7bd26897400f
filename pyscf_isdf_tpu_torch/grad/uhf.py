"""Spin-polarized (UHF/UKS) and ROHF/ROKS nuclear gradients by autograd.

Same construction as :mod:`~pyscf_isdf_tpu_torch.grad.rhf` with two spin
channels: the uhf_kernel energy functional (total-density Hartree,
per-spin exchange, spin-resolved XC) traced through the positions; the
Pulay term uses the per-spin energy-weighted densities.
"""
from __future__ import annotations

import torch

from pyscf_isdf_tpu_torch.device import require_device, to_host as _host
from pyscf_isdf_tpu_torch.grad.rhf import GammaTerms, _tensor, value_and_grad_at


def make_uhf_energy_fn(system, xc=None, exxdiv="ewald"):
    """E(positions; D_a, D_b, W, C_a, C_b), the spin-resolved functional."""
    t = GammaTerms(system, xc, exxdiv)
    xcspec = t.xcspec
    if xcspec is not None and xcspec.family == "mgga":
        raise NotImplementedError("spin-polarized forces of a meta-GGA")

    def energy(positions, dm_a, dm_b, w_mat, mo_a, mo_b):
        aoR = t.aoR(positions)
        S, T = t.st(positions)
        dm_t = dm_a + dm_b
        ta = aoR @ dm_a
        tb = aoR @ dm_b
        rho_a = (ta * aoR).sum(-1)
        rho_b = (tb * aoR).sum(-1)
        rho_t = rho_a + rho_b
        e1 = (dm_t * T).sum() + t.nuclear(positions, rho_t, dm_t)
        e_coul = t.hartree(rho_t)

        e_xc = 0.0
        if xcspec is not None:
            if xcspec.family == "gga":
                ao_grad = t.ao_grad(aoR)
                ga = 2.0 * torch.einsum("gi,xgi->xg", ta, ao_grad)
                gb = 2.0 * torch.einsum("gi,xgi->xg", tb, ao_grad)
                exc, _, _ = xcspec.exc_vxc_spin(rho_a, rho_b, (ga * ga).sum(0),
                                                (ga * gb).sum(0), (gb * gb).sum(0))
            else:
                exc, _, _ = xcspec.exc_vxc_spin(rho_a, rho_b)
            e_xc = t.weight * (rho_t * exc).sum()

        e_k = 0.0
        if t.need_k:
            e_k = -0.5 * (t.exchange(aoR @ mo_a, dm_a, S) + t.exchange(aoR @ mo_b, dm_b, S))
        e_pulay = -(w_mat * S).sum()
        return e1 + e_coul + e_xc + e_k + t.ewald.energy(positions) + e_pulay

    return energy


def _spin_counts(system):
    nb = (system.nelec - system.cell.spin) // 2
    return system.nelec - nb, nb


def _spin_gradient(system, xc, exxdiv, dm_a, dm_b, w_mat, mo_a, mo_b, dev):
    e_fn = make_uhf_energy_fn(system, xc=xc, exxdiv=exxdiv)
    return value_and_grad_at(e_fn, _tensor(system.cell.coords, dev),
                             (dm_a, dm_b, w_mat, mo_a, mo_b), float((w_mat * system.S).sum()))


def rohf_gradient(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                  device=None):
    """dE_tot/dR (natm, 3) for a converged Gamma ROHF/ROKS state.

    The energy functional is the UHF one at shared spatial orbitals; only
    the Pulay weight differs: Roothaan canonical orbitals satisfy no
    per-spin eigenvalue relation, and the energy-weighted density is the
    non-canonical W = D_a F_a D_a + D_b F_b D_b with the converged
    per-spin Fock matrices (reference pyscf/grad/rohf.py:29 make_rdm1e).
    """
    dev = require_device(system.aoR, device)
    na, nb = _spin_counts(system)
    C = _host(scf_res["mo_coeff"])
    dm_a, dm_b = (_tensor(_host(d), dev) for d in scf_res["dm"])
    fa, fb = (_tensor(_host(f), dev) for f in scf_res["fock"])
    w_mat = dm_a @ fa @ dm_a + dm_b @ fb @ dm_b
    grad, e_tot = _spin_gradient(system, xc, exxdiv, dm_a, dm_b, w_mat,
                                 _tensor(C[:, :na], dev), _tensor(C[:, :nb], dev), dev)
    return (grad, e_tot) if return_energy else grad


def uhf_gradient(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                 device=None):
    """dE_tot/dR (natm, 3) for a converged Gamma spin-polarized SCF, the
    spin counts from the cell's spin."""
    dev = require_device(system.aoR, device)
    na, nb = _spin_counts(system)
    ea, eb = (_host(e) for e in scf_res["mo_energy"])
    ca, cb = (_host(c) for c in scf_res["mo_coeff"])
    dm_a, dm_b = (_tensor(_host(d), dev) for d in scf_res["dm"])
    w_mat = _tensor((ca[:, :na] * ea[:na]) @ ca[:, :na].T
                    + (cb[:, :nb] * eb[:nb]) @ cb[:, :nb].T, dev)
    grad, e_tot = _spin_gradient(system, xc, exxdiv, dm_a, dm_b, w_mat,
                                 _tensor(ca[:, :na], dev), _tensor(cb[:, :nb], dev), dev)
    return (grad, e_tot) if return_energy else grad

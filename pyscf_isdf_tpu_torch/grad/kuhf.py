"""k-point spin-polarized (KUHF/KUKS) nuclear gradients by autograd.

Completes the gradient matrix: grad/rhf (Gamma R), grad/uhf (Gamma U),
grad/khf (k R) and this module (k U). Conventions of kuhf_kernel:
total-density Hartree, per-spin (k1, k2) exchange with per-spin madelung
shifts, (1/nk)-weighted spin densities for the XC.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device, to_host as _host
from pyscf_isdf_tpu_torch.grad.khf import KTerms, k_pulay
from pyscf_isdf_tpu_torch.grad.rhf import value_and_grad_at
from pyscf_isdf_tpu_torch.scf import occupations as occupations_mod


def make_kuhf_energy_fn(system, xc=None, exxdiv="ewald"):
    """E(positions; D_a,k, D_b,k, W_k, C_a,k, C_b,k), spin-resolved."""
    t = KTerms(system, xc, exxdiv)
    xcspec = t.xcspec

    def energy(positions, dm_a, dm_b, w_k, mo_a, mo_b):
        vR, SI = t.local_potential(positions)
        aoR_list = list(t.aoR(positions))
        S_list = []
        e1 = 0.0
        for k in range(t.nk):
            Sk, Tk = t.st[k](positions)
            S_list.append(Sk)
            e1 = e1 + t.one_body(positions, k, aoR_list[k], dm_a[k] + dm_b[k], Tk, vR, SI)
        e1 = e1 / t.nk
        rho_a = t.density(aoR_list, dm_a)
        rho_b = t.density(aoR_list, dm_b)
        rho_t = rho_a + rho_b
        e_coul = t.hartree(rho_t)
        e_xc = 0.0
        if xcspec is not None:
            if xcspec.family == "gga":
                ga = t.grad_density(aoR_list, dm_a)
                gb = t.grad_density(aoR_list, dm_b)
                exc, _, _ = xcspec.exc_vxc_spin(rho_a, rho_b, (ga * ga).sum(0),
                                                (ga * gb).sum(0), (gb * gb).sum(0))
            else:
                exc, _, _ = xcspec.exc_vxc_spin(rho_a, rho_b)
            e_xc = t.weight * (rho_t * exc).sum()
        e_k = 0.0
        if t.need_k:
            # per-spin exchange: e_k = -0.5 sum_spin tr(D K)/nk
            e_k = -0.5 * (t.exchange(aoR_list, mo_a, dm_a, S_list)
                          + t.exchange(aoR_list, mo_b, dm_b, S_list))
        e_pulay = 0.0
        for k in range(t.nk):
            e_pulay = e_pulay - (w_k[k] * S_list[k].T).sum().real / t.nk
        return e1 + e_coul + e_xc + e_k + t.ewald.energy(positions) + e_pulay

    return energy


def kuhf_gradient(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                  device=None):
    """dE_tot/dR (natm, 3) for a converged k-point spin-polarized SCF, the
    spin counts from the cell's spin, exactly that many spin orbitals
    filled (a stable sort over the k-stacked spectrum)."""
    dev = require_device(system.aoR_k, device)
    cell = system.cell
    nk = len(system.kpts)
    ea, eb = ([_host(e) for e in es] for es in scf_res["mo_energy"])
    ca, cb = ([_host(c) for c in cs] for cs in scf_res["mo_coeff"])
    c128 = dict(dtype=torch.complex128, device=dev)
    dm_a = [torch.as_tensor(_host(d), **c128) for d in scf_res["dm"][0]]
    dm_b = [torch.as_tensor(_host(d), **c128) for d in scf_res["dm"][1]]
    nb_tot = (cell.nelectron - cell.spin) * nk // 2
    na_tot = cell.nelectron * nk - nb_tot
    occ_a = occupations_mod.exact_count_occ(ea, na_tot, scale=1.0)
    occ_b = occupations_mod.exact_count_occ(eb, nb_tot, scale=1.0)
    w_k, mo_a, mo_b = [], [], []
    for k in range(nk):
        wa = ca[k][:, occ_a[k] > 0]
        wb = cb[k][:, occ_b[k] > 0]
        w_k.append(torch.as_tensor((wa * ea[k][occ_a[k] > 0]) @ wa.conj().T
                                   + (wb * eb[k][occ_b[k] > 0]) @ wb.conj().T, **c128))
        mo_a.append(torch.as_tensor(np.ascontiguousarray(wa), **c128))
        mo_b.append(torch.as_tensor(np.ascontiguousarray(wb), **c128))
    e_fn = make_kuhf_energy_fn(system, xc=xc, exxdiv=exxdiv)
    grad, e_tot = value_and_grad_at(e_fn, torch.as_tensor(cell.coords, device=dev),
                                    (dm_a, dm_b, w_k, mo_a, mo_b), k_pulay(w_k, system.S))
    return (grad, e_tot) if return_energy else grad

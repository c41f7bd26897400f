"""k-point nuclear gradients by autograd (KRHF/KRKS forces).

Same construction as :mod:`~pyscf_isdf_tpu_torch.grad.rhf` at every k:
the converged-density energy functional of kscf_kernel (1/nk-weighted
traces, exchange over (k1, k2) pair densities with the coulG(k2 - k1)
kernels, the Ewald madelung shift) with every position dependence traced,
differentiated in one backward pass. The AO values at each k are
:func:`~pyscf_isdf_tpu_torch.ops.ao_eval.eval_ao_positions` with ``kpt``
(the Bloch evaluator on the GPU). The functional is the SCF's at any
k-point: the nonlocal PP takes its projectors at k+G, as ``get_vppnl(kpt=)``
does, and the local potential meets the density sum phi_p D_pq
conj(phi_q) (the reference's takes the projectors at G and the transposed
density, which differ where the Bloch AOs are complex; ROADMAP queue 3
(o) and (p)).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.device import require_device, to_host as _host
from pyscf_isdf_tpu_torch.df import fftdf_k
from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.grad.rhf import (_EwaldData, _ao_atom_map, _ft_factors, _st_sums,
                                           _vnl_energy, _vnl_tables, value_and_grad_at)
from pyscf_isdf_tpu_torch.ops import coulomb, pp as pp_ops
from pyscf_isdf_tpu_torch.ops.ao_eval import (PackedBasis, ao_gradient_fft_k,
                                              eval_ao_positions, shell_rcut)
from pyscf_isdf_tpu_torch.ops.ft_ao import converged_st_mesh
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.hf import rsh_coeffs


class KTerms:
    """The position-traced pieces of the k-point energy functionals (KRHF
    and KUHF) of one system: Bloch AO values, S_k/T_k, the nuclear
    potential, Hartree, the (k1, k2) exchange and Ewald."""

    def __init__(self, system, xc=None, exxdiv="ewald"):
        cell = self.cell = system.cell
        self.device = dev = system.aoR_k.device
        f64 = dict(dtype=torch.float64, device=dev)
        self.kpts = np.asarray(system.kpts)
        self.nk = nk = len(self.kpts)
        self.mesh = tuple(system.mesh)
        self.weight = system.weight
        self.vol = cell.vol
        self.coulG = system.coulG.to(**f64)
        self.expmikr = system.expmikr
        Gv_np = cell.get_Gv(cell.mesh)
        self.Gv_mesh = torch.as_tensor(Gv_np, **f64)
        self.coords = torch.as_tensor(cell.uniform_grid(), **f64)
        xcspec = XCSpec(xc) if xc is not None else None
        if xcspec is not None and xcspec.family == "hf":
            xcspec = None
        if xcspec is not None and xcspec.family == "mgga":
            raise NotImplementedError("k-point forces of a meta-GGA")
        self.xcspec = xcspec
        hyb, alpha, omega = rsh_coeffs(xcspec)
        self.need_k = hyb > 0 or alpha > 0
        self.exxdiv = exxdiv
        mad = system.madelung if exxdiv == "ewald" else 0.0
        # hyb K_full + (alpha - hyb) K_LR: one combined kernel per (k1, k2)
        self.kern_pairs = hyb * system.coulG_pairs.to(**f64)
        self.mad_add = hyb * mad
        if omega != 0.0:
            cpl, _ = fftdf_k.make_k_kernels(cell, self.kpts, omega=omega)
            self.kern_pairs = self.kern_pairs + (alpha - hyb) * torch.as_tensor(cpl, **f64)
            mad_lr = coulomb.madelung_omega(cell, self.kpts, omega) \
                if exxdiv == "ewald" else 0.0
            self.mad_add = hyb * mad + (alpha - hyb) * mad_lr

        self.packed = PackedBasis.from_cell(cell)
        rcut = max(shell_rcut(sh) for sh in cell.shells)
        self.images = torch.as_tensor(lattice.lattice_images(cell.a, rcut, cell.dimension), **f64)
        self.kpts_all = torch.as_tensor(self.kpts, **f64)
        self.kpts_t = list(self.kpts_all)
        Gv_st = torch.as_tensor(lattice.get_Gv(cell.a, converged_st_mesh(cell)), **f64)
        self.st = [_st_sums(cell, Gv_st, k, self.vol, real=False) for k in self.kpts_t]
        self.ao_atom = torch.as_tensor(_ao_atom_map(cell), device=dev)

        self.has_pp = bool(cell.pseudos)
        if self.has_pp:
            self.vlocG = torch.as_tensor(pp_ops.gth_vlocG(cell, Gv_np), **f64)
            self.alpha0 = torch.as_tensor([float(np.sum(pp_ops.gth_alphas(cell)))],
                                          dtype=torch.complex128, device=dev)
            self.vnl_k = [_vnl_tables(cell, self.Gv_mesh + k) for k in self.kpts_t]
            self.fG_mesh_k = [_ft_factors(cell, self.Gv_mesh, k)[0] for k in self.kpts_t]
        else:
            self.charges = torch.as_tensor(cell.charges, **f64)
        self.ewald = _EwaldData(cell, dev)

    def aoR(self, positions):
        """(nk, ng, nao) Bloch AO values at every k-point."""
        return eval_ao_positions(self.packed, self.coords, self.images, positions,
                                 kpt=self.kpts_all, cell=self.cell)

    def local_potential(self, positions):
        """(the local PP or bare-nuclear potential on the grid, the
        structure factors SI (natm, ng))."""
        SI = torch.exp(-1j * (self.Gv_mesh @ positions.T)).T
        if self.has_pp:
            vpplocG = -(SI * self.vlocG).sum(0)
            vpplocG = torch.cat([self.alpha0, vpplocG[1:]])
            return ifft3(vpplocG, self.mesh).real, SI
        rhoG = -(self.charges.to(SI.dtype) @ SI)
        return ifft3(rhoG * self.coulG, self.mesh).real, SI

    def one_body(self, positions, k, aoRk, dm_k, T_k, vR, SI):
        """Re Tr(D_k (T_k + V_loc + V_nl)) at one k-point."""
        e = (dm_k * T_k.T).sum().real
        # Tr(D V) with rho = sum phi_p D_pq conj(phi_q), the SCF's density
        e = e + torch.einsum("pq,gp,g,gq->", dm_k, aoRk, vR.to(aoRk.dtype),
                             aoRk.conj()).real
        if self.has_pp:
            kG = self.Gv_mesh + self.kpts_t[k]
            phk = torch.exp(-1j * (kG @ positions.T))
            aokG = self.fG_mesh_k[k] * phk[:, self.ao_atom] / math.sqrt(self.vol)
            e = e + _vnl_energy(self.vnl_k[k], SI, aokG, dm_k, self.vol)
        return e

    def density(self, aoR_list, dms):
        rho = 0.0
        for aoRk, d in zip(aoR_list, dms):
            rho = rho + ((aoRk @ d) * aoRk.conj()).sum(-1).real
        return rho / self.nk

    def grad_density(self, aoR_list, dms):
        g = 0.0
        for k, (aoRk, d) in enumerate(zip(aoR_list, dms)):
            ao_grad = ao_gradient_fft_k(aoRk, self.mesh, self.Gv_mesh, self.kpts_t[k],
                                        self.coords)
            g = g + 2.0 * torch.einsum("gi,xgi->xg", (aoRk @ d).conj(), ao_grad).real
        return g / self.nk

    def hartree(self, rho):
        vR = ifft3(self.coulG * fft3(rho.to(torch.complex128), self.mesh), self.mesh).real
        return 0.5 * self.weight * (rho * vR).sum()

    def exchange(self, aoR_list, mo_w_k, dms, S_list):
        """sum_{k1,k2} of the periodized pair exchange of one set of
        occupied orbitals (1/nk^2), with the probe-charge term (1/nk)."""
        ex = 0.0
        moR = [aoR_list[k] @ mo_w_k[k] for k in range(self.nk)]
        for k1 in range(self.nk):
            for k2 in range(self.nk):
                no1, no2 = moR[k1].shape[1], moR[k2].shape[1]
                if no1 == 0 or no2 == 0:
                    continue
                pair = (moR[k1].conj()[:, :, None] * moR[k2][:, None, :]) \
                    * self.expmikr[k2, k1][:, None, None]
                pflat = pair.reshape(-1, no1 * no2).T
                vpair = ifft3(self.kern_pairs[k2, k1][None, :] * fft3(pflat, self.mesh),
                              self.mesh)
                ex = ex + self.weight * (vpair * pflat.conj()).sum().real
        ex = ex / self.nk ** 2
        if self.exxdiv == "ewald":
            for k in range(self.nk):
                t1 = dms[k] @ S_list[k]
                ex = ex + self.mad_add * (t1 * t1.T).sum().real / self.nk
        return ex


def _k_state(scf_res, nk, dev):
    """(dm_k, W_k, C_occ sqrt(occ)) per k from a k-point SCF result."""
    mo_e = [_host(e) for e in scf_res["mo_energy"]]
    mo_c = [_host(c) for c in scf_res["mo_coeff"]]
    mo_occ = [_host(o) for o in scf_res["mo_occ"]]
    dm_k = [torch.as_tensor(_host(d), dtype=torch.complex128, device=dev)
            for d in scf_res["dm"]]
    w_k, mo_w_k = [], []
    for k in range(nk):
        sel = mo_occ[k] > 0
        c = mo_c[k][:, sel]
        occ = mo_occ[k][sel]
        w_k.append(torch.as_tensor((c * (mo_e[k][sel] * occ)) @ c.conj().T,
                                   dtype=torch.complex128, device=dev))
        mo_w_k.append(torch.as_tensor(c * np.sqrt(occ), dtype=torch.complex128, device=dev))
    return dm_k, w_k, mo_w_k


def make_kenergy_fn(system, xc=None, exxdiv="ewald"):
    """E(positions; D_k, W_k, C_k sqrt(occ)) of the closed-shell k-point
    SCF, every position dependence traced."""
    t = KTerms(system, xc, exxdiv)
    xcspec = t.xcspec

    def energy(positions, dm_k, w_k, mo_w_k):
        vR, SI = t.local_potential(positions)
        aoR_list = list(t.aoR(positions))
        S_list = []
        e1 = 0.0
        for k in range(t.nk):
            Sk, Tk = t.st[k](positions)
            S_list.append(Sk)
            e1 = e1 + t.one_body(positions, k, aoR_list[k], dm_k[k], Tk, vR, SI)
        e1 = e1 / t.nk
        rho = t.density(aoR_list, dm_k)
        e_coul = t.hartree(rho)
        e_xc = 0.0
        if xcspec is not None:
            if xcspec.family == "gga":
                grho = t.grad_density(aoR_list, dm_k)
                exc, _, _ = xcspec.exc_vxc(rho, (grho * grho).sum(0))
            else:
                exc, _, _ = xcspec.exc_vxc(rho)
            e_xc = t.weight * (rho * exc).sum()
        e_k = -0.25 * t.exchange(aoR_list, mo_w_k, dm_k, S_list) if t.need_k else 0.0
        e_pulay = 0.0
        for k in range(t.nk):
            e_pulay = e_pulay - (w_k[k] * S_list[k].T).sum().real / t.nk
        return e1 + e_coul + e_xc + e_k + t.ewald.energy(positions) + e_pulay

    return energy


def k_pulay(w_k, S):
    """1/nk sum_k Re Tr(W_k S_k), the Pulay offset of the k functionals'
    value."""
    return sum(float((w * S[k].T).sum().real) for k, w in enumerate(w_k)) / len(w_k)


def krhf_gradient(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                  device=None):
    """dE_tot/dR (natm, 3) for a converged k-point closed-shell SCF, with
    the per-k occupations of ``scf_res['mo_occ']``. Runs on ``device``
    (default: the GPU), where the system must live."""
    dev = require_device(system.aoR_k, device)
    nk = len(system.kpts)
    dm_k, w_k, mo_w_k = _k_state(scf_res, nk, dev)
    e_fn = make_kenergy_fn(system, xc=xc, exxdiv=exxdiv)
    grad, e_tot = value_and_grad_at(e_fn, torch.as_tensor(system.cell.coords, device=dev),
                                    (dm_k, w_k, mo_w_k), k_pulay(w_k, system.S))
    return (grad, e_tot) if return_energy else grad

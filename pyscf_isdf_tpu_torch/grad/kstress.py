"""k-point stress tensor by strain autograd (KRHF/KRKS).

Extends :mod:`~pyscf_isdf_tpu_torch.grad.stress` to k-sampled SCF. Under
strain eps the k-points transform contragradiently (k' = (1+eps)^-T k,
they live on the reciprocal lattice), which makes the Bloch phase k.T and
the exchange phase q.r strain-invariant: those phase tables stay static
while the kernels |G+q|^2, the volumes and the collocation scale. The
probe-charge madelung of the Nk-scaled supercell is traced as at Gamma.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.cell import _estimate_rcut
from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.grad.khf import _k_state, k_pulay
from pyscf_isdf_tpu_torch.grad.rhf import ST_CHUNK, chunked_sum, value_and_grad_at
from pyscf_isdf_tpu_torch.grad.stress import (_StrainEwald, _ft_ao_torch, _gth_vlocG_torch,
                                              _madelung_lr, _madelung_lr_mesh,
                                              _vppnl_energy_torch)
from pyscf_isdf_tpu_torch.ops import coulomb, pp as pp_ops
from pyscf_isdf_tpu_torch.ops.ao_eval import (PackedBasis, ao_gradient_fft_k,
                                              eval_ao_positions, shell_rcut)
from pyscf_isdf_tpu_torch.ops.ft_ao import converged_st_mesh
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.hf import rsh_coeffs


class _ProbeEwald:
    """Traced Ewald energy of one unit probe charge on a (possibly
    Nk-scaled) lattice ``a``: the madelung constant is -2x this."""

    def __init__(self, a, precision, device):
        f64 = dict(dtype=torch.float64, device=device)
        ew_eta = 1.0 / abs(np.linalg.det(a)) ** (1.0 / 6)
        ew_cut = _estimate_rcut(ew_eta**2, 0, 1.0, precision)
        self.eta = ew_eta
        self.L0 = torch.as_tensor(lattice.lattice_images(a, 1.06 * ew_cut, 3), **f64)
        log_prec = np.log(precision / (16 * np.pi**2))
        Gv = lattice.get_Gv(a, lattice.cutoff_to_mesh(a, -2 * ew_eta**2 * log_prec * 1.1))
        self.Gv0 = torch.as_tensor(Gv[np.einsum("gi,gi->g", Gv, Gv) > 1e-12], **f64)
        self.vol0 = abs(np.linalg.det(a))

    def madelung(self, F, Finv, detF):
        L = self.L0 @ F.T
        r2 = (L * L).sum(-1)
        ok = r2 > 1e-16
        r = torch.sqrt(torch.where(ok, r2, 1.0))
        ovrl = 0.5 * torch.where(ok, torch.special.erfc(self.eta * r) / r, 0.0).sum()
        G = self.Gv0 @ Finv
        G2 = (G * G).sum(1)
        vol = self.vol0 * detF
        ewg = 0.5 * (torch.exp(-G2 / (4 * self.eta**2)) * 4 * np.pi / G2).sum() / vol
        e = ovrl + ewg - self.eta / np.sqrt(np.pi) - 0.5 * np.pi / (self.eta**2 * vol)
        return -2.0 * e


def _wrapped_kG(cell, q, mesh):
    """Host: wrap-around effective G+q vectors and the boundary-kill mask
    (ops/coulomb.get_coulG's wrap). The wrap choice is a discrete
    reciprocal-lattice shift, strain-independent, so the unstrained
    vectors transform as kG @ F^-1 under strain."""
    Gv = cell.get_Gv(mesh)
    kG = Gv + q[None, :]
    boundary = np.zeros(Gv.shape[0], dtype=bool)
    if np.abs(q).sum() > 1e-9:
        b = cell.reciprocal_vectors()
        box_edge = (np.asarray(mesh) // 2 + 0.5)[:, None] * b
        reduced = np.linalg.solve(box_edge.T, kG.T).T.round(9)
        on_edge = reduced.astype(int)
        for i in range(cell.dimension):
            boundary |= reduced[:, i] == 1
            boundary |= reduced[:, i] == -1
            kG[on_edge[:, i] == 1] -= 2 * box_edge[i]
            kG[on_edge[:, i] == -1] += 2 * box_edge[i]
    return kG, boundary


def make_kstrain_energy_fn(system, xc=None, exxdiv="ewald"):
    """E(eps; D_k, W_k, C_k sqrt(occ)) of the closed-shell k-point SCF
    with the strain traced."""
    cell = system.cell
    if cell.dimension != 3:
        raise NotImplementedError("k-stress: 3D cells")
    dev = system.aoR_k.device
    f64 = dict(dtype=torch.float64, device=dev)
    kpts0 = np.asarray(system.kpts)
    nk = len(kpts0)
    mesh = tuple(system.mesh)
    ngrids = float(np.prod(mesh))
    xcspec = XCSpec(xc) if xc is not None else None
    if xcspec is not None and xcspec.family == "hf":
        xcspec = None
    if xcspec is not None and xcspec.family == "mgga":
        raise NotImplementedError("k-stress of a meta-GGA")
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    omega_abs = abs(float(omega))
    if exxdiv not in (None, "ewald"):
        # the SCF can minimize e.g. a vcut_sph functional; differentiating
        # another functional silently would be wrong
        raise NotImplementedError(f"k-stress: exxdiv={exxdiv!r}")

    packed = PackedBasis.from_cell(cell)
    rcut = max(shell_rcut(sh) for sh in cell.shells)
    L0 = torch.as_tensor(lattice.lattice_images(cell.a, 1.06 * rcut, 3), **f64)
    coords0 = torch.as_tensor(cell.uniform_grid(), **f64)
    R0 = torch.as_tensor(cell.coords, **f64)
    Gv0 = torch.as_tensor(cell.get_Gv(cell.mesh), **f64)
    Gv_st0 = torch.as_tensor(lattice.get_Gv(cell.a, converged_st_mesh(cell)), **f64)
    n_st = -(-Gv_st0.shape[0] // ST_CHUNK)
    vol0 = cell.vol
    kpts0_t = torch.as_tensor(kpts0, **f64)
    # strain-invariant exchange phases e^{-i q.r} (q.r = q0.r0)
    expmikr0 = system.expmikr
    has_pp = bool(cell.pseudos)
    if has_pp:
        alpha0 = torch.as_tensor([float(np.sum(pp_ops.gth_alphas(cell)))],
                                 dtype=torch.complex128, device=dev)
    charges = torch.as_tensor(cell.charges, **f64)
    ewald = _StrainEwald(cell, dev)

    # wrap-around exchange kernel vectors per (k1, k2), on the host
    kGq0, bnd_q = {}, {}
    if need_k:
        for k1 in range(nk):
            for k2 in range(nk):
                kg, bnd = _wrapped_kG(cell, kpts0[k2] - kpts0[k1], cell.mesh)
                kGq0[k1, k2] = torch.as_tensor(kg, **f64)
                bnd_q[k1, k2] = torch.as_tensor(bnd, device=dev)

    probe, mad_shift = None, 0.0
    Nk = coulomb.monkhorst_pack_size(cell, kpts0)
    if exxdiv == "ewald" and need_k:
        probe = _ProbeEwald(cell.a * Nk[:, None], cell.precision, dev)
        # pin the eps=0 value to the SCF's own madelung constant (the two
        # Ewald sums differ at cell.precision; a constant shift keeps the
        # gradient)
        eye = torch.eye(3, **f64)
        mad_shift = system.madelung - float(probe.madelung(eye, eye, 1.0))

    # LR madelung of the Nk-scaled supercell for RSH, pinned at eps=0 to
    # the SCF's own host constant
    Gml0, mad_lr_shift, vol_sc0 = None, 0.0, None
    if rsh and exxdiv == "ewald" and need_k:
        a_sc = cell.a * Nk[:, None]
        vol_sc0 = abs(np.linalg.det(a_sc))
        Gml0 = torch.as_tensor(_madelung_lr_mesh(a_sc, omega_abs,
                                                 getattr(cell, "precision", 1e-8)), **f64)
        mad_lr_shift = coulomb.madelung_omega(cell, kpts0, omega) \
            - float(_madelung_lr(Gml0, omega_abs, vol_sc0))

    def st_chunk(c, kv, pos, Finv, vol):
        G = Gv_st0[c * ST_CHUNK:(c + 1) * ST_CHUNK] @ Finv + kv
        aoG = _ft_ao_torch(cell, G, pos)
        S = (aoG.conj().T @ aoG) / vol
        T = ((aoG.conj() * (0.5 * (G * G).sum(1))[:, None]).T @ aoG) / vol
        return S, T

    def energy(eps, dm_k, w_k, mo_w_k):
        F = torch.eye(3, **f64) + eps
        Finv = torch.linalg.inv(F)
        detF = torch.linalg.det(F)
        vol = vol0 * detF
        weight = vol / ngrids
        pos = R0 @ F.T
        coords = coords0 @ F.T
        images = L0 @ F.T
        kpts = kpts0_t @ Finv
        Gv = Gv0 @ Finv
        G2 = (Gv * Gv).sum(1)
        small = G2 < 1e-12
        coulG = torch.where(small, 0.0, 4 * np.pi / torch.where(small, 1.0, G2))
        SI = torch.exp(-1j * (Gv @ pos.T)).T
        cell_e = replace(cell, a=cell.a @ F.detach().cpu().numpy().T)

        if has_pp:
            vpplocG = -(SI * _gth_vlocG_torch(cell, G2)).sum(0)
            vR_loc = ifft3(torch.cat([alpha0, vpplocG[1:]]), mesh).real
        else:
            vR_loc = ifft3(-(charges.to(SI.dtype) @ SI) * coulG, mesh).real
        e1 = 0.0
        S_list = []
        aoR_list = list(eval_ao_positions(packed, coords, images, pos, kpt=kpts, cell=cell_e))
        for k in range(nk):
            kv = kpts[k]
            aoRk = aoR_list[k]
            Sk, Tk = chunked_sum(st_chunk, n_st, kv, pos, Finv, vol)
            S_list.append(Sk)
            e1 = e1 + (dm_k[k] * Tk.T).sum().real
            # Tr(D V) with rho = sum phi_p D_pq conj(phi_q), the SCF's density
            e1 = e1 + torch.einsum("pq,gp,g,gq->", dm_k[k], aoRk, vR_loc.to(aoRk.dtype),
                                   aoRk.conj()).real
            if has_pp:
                kG = Gv + kv
                aokG = _ft_ao_torch(cell, kG, pos) / torch.sqrt(vol)
                e1 = e1 + _vppnl_energy_torch(cell, kG, aokG, SI, dm_k[k], vol)
        e1 = e1 / nk

        rho = 0.0
        for k in range(nk):
            rho = rho + ((aoR_list[k] @ dm_k[k]) * aoR_list[k].conj()).sum(-1).real
        rho = rho / nk
        vR_h = ifft3(coulG * fft3(rho.to(torch.complex128), mesh), mesh).real
        e_coul = 0.5 * weight * (rho * vR_h).sum()

        e_xc = 0.0
        if xcspec is not None:
            if xcspec.family == "gga":
                grho = 0.0
                for k in range(nk):
                    ao_grad = ao_gradient_fft_k(aoR_list[k], mesh, Gv, kpts[k], coords)
                    grho = grho + 2.0 * torch.einsum(
                        "gi,xgi->xg", (aoR_list[k] @ dm_k[k]).conj(), ao_grad).real
                grho = grho / nk
                exc, _, _ = xcspec.exc_vxc(rho, (grho * grho).sum(0))
            else:
                exc, _, _ = xcspec.exc_vxc(rho)
            e_xc = weight * (rho * exc).sum()

        e_k = 0.0
        if need_k:
            ex = 0.0
            moR_k = [aoR_list[k] @ mo_w_k[k] for k in range(nk)]
            for k1 in range(nk):
                for k2 in range(nk):
                    Gq = kGq0[k1, k2] @ Finv
                    G2q = (Gq * Gq).sum(1)
                    kill = bnd_q[k1, k2] | (G2q < 1e-12)
                    kern = torch.where(kill, 0.0, 4 * np.pi / torch.where(kill, 1.0, G2q))
                    kern = hyb * kern + ((alpha - hyb) * kern
                                         * torch.exp(-0.25 / omega_abs**2 * G2q)
                                         if rsh else 0.0)
                    mo1, mo2 = moR_k[k1], moR_k[k2]
                    pair = (mo1.conj()[:, :, None] * mo2[:, None, :]) \
                        * expmikr0[k2, k1][:, None, None]
                    pflat = pair.reshape(-1, mo1.shape[1] * mo2.shape[1]).T
                    vpair = ifft3(kern[None, :] * fft3(pflat, mesh), mesh)
                    ex = ex + weight * (vpair * pflat.conj()).sum().real
            ex = ex / nk**2
            if exxdiv == "ewald":
                mad_eps = hyb * (probe.madelung(F, Finv, detF) + mad_shift)
                if rsh:
                    mad_eps = mad_eps + (alpha - hyb) * (
                        _madelung_lr(Gml0 @ Finv, omega_abs, vol_sc0 * detF) + mad_lr_shift)
                for k in range(nk):
                    t1 = dm_k[k] @ S_list[k]
                    ex = ex + mad_eps * (t1 * t1.T).sum().real / nk
            e_k = -0.25 * ex

        e_pulay = 0.0
        for k in range(nk):
            e_pulay = e_pulay - (w_k[k] * S_list[k].T).sum().real / nk
        return e1 + e_coul + e_xc + e_k + ewald.energy(pos, F, Finv, vol) + e_pulay

    return energy


def kstress_tensor(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                   device=None):
    """3x3 stress sigma = (1/vol) dE/d eps for a converged k-point SCF;
    with ``return_energy`` (sigma, e_tot, dE/d eps). Runs on ``device``
    (default: the GPU), where the system must live."""
    dev = require_device(system.aoR_k, device)
    nk = len(system.kpts)
    dm_k, w_k, mo_w_k = _k_state(scf_res, nk, dev)
    e_fn = make_kstrain_energy_fn(system, xc=xc, exxdiv=exxdiv)
    g, e_tot = value_and_grad_at(e_fn, torch.zeros((3, 3), dtype=torch.float64, device=dev),
                                 (dm_k, w_k, mo_w_k), k_pulay(w_k, system.S))
    sigma = 0.5 * (g + g.T) / system.cell.vol
    return (sigma, e_tot, g) if return_energy else sigma

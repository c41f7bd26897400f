"""Finite-difference electron-phonon coupling at the Gamma point (torch).

Reference contract: pyscf/pbc/eph/eph_fd.py, as the JAX package carries
it over (``pyscf_isdf_tpu/eph/eph_fd.py``): SCFs at +-disp/2
displacements of every (atom, axis), the finite difference of the
self-consistent potential V = vloc + vnl + vH + vxc (- exchange) for the
coupling matrices and of the analytic forces (grad/rhf.py) for the
dynamical matrix, then the projection onto mass-weighted phonon modes
(pyscf/eph/rhf.py solve_hmat / _freq_mass_weighted_vec semantics).

The finite difference of the AO-basis potential matrices carries
basis-movement terms <d mu/dR|V|nu> + <mu|V|d nu/dR>. They are removed as
the finite difference of the frozen central potential in the displaced
basis, B(R) = <mu(R)| V0 |nu(R)>: the central grid potentials (local PP,
Hartree), the frozen-(vrho, vsigma, grad rho) XC operator, the nonlocal
projectors pinned at the central atoms (``ops/pp.get_vppnl(pp_coords=)``)
and, for hybrids, the exchange with the central occupied orbitals frozen
on the grid (one ``fftdf.get_k_occ`` with the bra AOs displaced). Every
displaced SCF, potential and force runs on the device; the eigensolve of
the (3 natm)^2 dynamical matrix and the mode projections are host numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import resolve_device, to_host
from pyscf_isdf_tpu_torch.df import fftdf
from pyscf_isdf_tpu_torch.grad.rhf import rhf_gradient
from pyscf_isdf_tpu_torch.ops import pp as pp_mod
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.hf import build_scf_system, scf_kernel

# standard atomic weights (CIAAW 2021, amu) for elements the GTH tables
# cover; converted with the proton-mass ratio below
ATOMIC_MASS = {
    "H": 1.008, "He": 4.0026, "Li": 6.94, "Be": 9.0122, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "Ne": 20.180,
    "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085, "P": 30.974,
    "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.098, "Ca": 40.078,
    "Ga": 69.723, "Ge": 72.630, "As": 74.922, "Se": 78.971, "Br": 79.904,
}
AMU_TO_ME = 1822.888486209           # m_u / m_e


@dataclass
class EPHResult:
    omega: np.ndarray        # (nmodes,) phonon frequencies (a.u.)
    modes: np.ndarray        # (3*natm, nmodes) mass-weighted eigenvectors
    vmat: np.ndarray         # (3*natm, nao, nao) corrected dV/dR
    g: np.ndarray            # (nmodes, n, n) e-ph couplings (AO or MO)
    hessian: np.ndarray      # (natm, 3, natm, 3)
    mo_rep: bool
    niter: Optional[list] = None   # SCF iterations, the central SCF first


def _xc_frozen(aoR, ao_grad, frozen, weight, family):
    """XC-operator matrix with frozen potential grids in a (possibly
    displaced) basis: the contractions of scf/hf.py _vxc_lda/_vxc_gga."""
    vrho = frozen["vrho"]
    if family == "lda":
        return weight * ((aoR.T * vrho) @ aoR)
    aow = 0.5 * vrho[:, None] * aoR + 2.0 * torch.einsum(
        "xg,g,xgi->gi", frozen["grho"], frozen["vsigma"], ao_grad)
    half = weight * (aoR.T @ aow)
    return half + half.T


def _occupied_on_grid(system, res, aoR):
    """The occupied orbitals on the grid scaled by sqrt(occ), (ng, nocc)
    (aufbau double occupation when the result has no mo_occ)."""
    C = to_host(res["mo_coeff"])
    occ = res.get("mo_occ")
    if occ is None:
        occ = np.zeros(C.shape[1])
        occ[: system.nelec // 2] = 2.0
    occ = to_host(occ)
    keep = occ > 1e-8
    return aoR @ torch.as_tensor(C[:, keep] * np.sqrt(occ[keep]), dtype=aoR.dtype,
                                 device=aoR.device)


def _v_and_frozen(cell, system, res, xcspec):
    """Potential matrix V = vloc + vnl + vH + vxc (- exchange) at this
    geometry from its converged density, (nao, nao) tensor on the system's
    device, plus the frozen-potential grids and the XC family."""
    from pyscf_isdf_tpu_torch.ops import coulomb

    aoR = system.aoR
    dev = aoR.device
    mesh, weight = system.mesh, system.weight
    dm = torch.as_tensor(to_host(res["dm"]), dtype=aoR.dtype, device=dev)

    vloc_mat, vlocR = pp_mod.get_vpploc(cell, aoR)
    vnl_mat = pp_mod.get_vppnl(cell, device=dev)

    rho = fftdf.get_rho(aoR, dm)
    vHR = fftdf.ifft3(system.coulG * fftdf.fft3(rho.to(torch.complex128), mesh),
                      mesh).real
    V = vloc_mat + vnl_mat + weight * ((aoR.T * vHR) @ aoR)
    frozen = {"vlocR": torch.as_tensor(vlocR, device=dev), "vHR": vHR}

    # hybrid/RSH exchange, with the occupied orbitals on the grid frozen
    # for the basis-movement correction (the grid does not move with the
    # atoms, so mo0(r_g) is displacement-invariant data)
    hyb = 1.0 if xcspec is None else xcspec.hyb
    alpha = hyb if xcspec is None else xcspec.alpha
    omega_rs = 0.0 if xcspec is None else xcspec.omega
    if hyb > 0 or alpha > 0:
        mo_w = _occupied_on_grid(system, res, aoR)
        SdS = system.S @ dm @ system.S
        k_eff = hyb * (fftdf.get_k_occ(aoR, mo_w, system.coulG, mesh, weight)
                       + system.madelung * SdS)
        if omega_rs != 0.0:
            coulG_lr = torch.as_tensor(coulomb.get_coulG(cell, exxdiv=None,
                                                         omega=omega_rs),
                                       dtype=aoR.dtype, device=dev)
            mad_lr = coulomb.madelung_omega(cell, None, omega_rs)
            k_eff = k_eff + (alpha - hyb) * (
                fftdf.get_k_occ(aoR, mo_w, coulG_lr, mesh, weight) + mad_lr * SdS)
            frozen.update(coulG_lr=coulG_lr, mad_lr=mad_lr)
        V = V - 0.5 * k_eff
        frozen.update(mo_w_grid=mo_w, hyb=hyb, alpha=alpha, omega_rs=omega_rs,
                      dm0=dm, mad=system.madelung)
    family = None
    if xcspec is not None:
        family = xcspec.family
        if family == "mgga":
            raise NotImplementedError("eph: meta-GGA frozen operator")
        if family == "gga":
            ao_grad = ao_gradient_fft(aoR, mesh, system.Gv)
            grho = 2.0 * torch.einsum("gi,xgi->xg", aoR @ dm, ao_grad)
            _, vrho, vsigma = xcspec.exc_vxc(rho, (grho * grho).sum(0))
            frozen.update(vrho=vrho, vsigma=vsigma, grho=grho)
            V = V + _xc_frozen(aoR, ao_grad, frozen, weight, "gga")
        elif family == "lda":
            _, vrho, _ = xcspec.exc_vxc(rho)
            frozen.update(vrho=vrho)
            V = V + _xc_frozen(aoR, None, frozen, weight, "lda")
        else:
            family = None                          # 'hf': no XC operator
    return V, frozen, family


def _frozen_matrix(cell_d, system_d, frozen, family, pp_coords):
    """Matrix of the frozen central potential in the displaced basis,
    (nao, nao) tensor on the system's device."""
    aoR = system_d.aoR
    mesh, weight = system_d.mesh, system_d.weight
    # vloc quadrature carries the 1/N of the ifft (ops/pp.py convention)
    B = (aoR.T * frozen["vlocR"]) @ aoR
    B = B + weight * ((aoR.T * frozen["vHR"]) @ aoR)
    B = B + pp_mod.get_vppnl(cell_d, device=aoR.device, pp_coords=pp_coords)
    if family is not None:
        ao_grad = (ao_gradient_fft(aoR, mesh, system_d.Gv) if family == "gga"
                   else None)
        B = B + _xc_frozen(aoR, ao_grad, frozen, weight, family)
    if frozen.get("mo_w_grid") is not None:
        # frozen exchange in the displaced basis: one mixed get_k_occ
        # (displaced bra AOs x frozen central occupied grid factors); the
        # Madelung shift with the frozen density and the displaced S
        mo_w = frozen["mo_w_grid"]
        hyb, alpha = frozen["hyb"], frozen["alpha"]
        SdS = system_d.S @ frozen["dm0"] @ system_d.S
        k_eff = hyb * (fftdf.get_k_occ(aoR, mo_w, system_d.coulG, mesh, weight)
                       + frozen["mad"] * SdS)
        if frozen.get("coulG_lr") is not None:
            k_eff = k_eff + (alpha - hyb) * (
                fftdf.get_k_occ(aoR, mo_w, frozen["coulG_lr"], mesh, weight)
                + frozen["mad_lr"] * SdS)
        B = B - 0.5 * k_eff
    return B


def phonon_modes(cell, hessian):
    """Mass-weighted dynamical matrix eigensolve.

    Returns (omega (3N,), vec (3N, 3N)) sorted descending in omega
    (imaginary frequencies reported as negative), reference
    pyscf/eph/rhf.py:52-68 semantics."""
    masses = np.array([ATOMIC_MASS[s] for s in cell.symbols]) * AMU_TO_ME
    natm = cell.natm
    h = np.asarray(hessian) / np.sqrt(masses[:, None, None, None]
                                      * masses[None, None, :, None])
    fm = h.reshape(3 * natm, 3 * natm)
    fm = 0.5 * (fm + fm.T)
    w2, vec = np.linalg.eigh(fm)
    order = np.argsort(w2)[::-1]
    w2, vec = w2[order], vec[:, order]
    omega = np.sign(w2) * np.sqrt(np.abs(w2))
    return omega, vec


def eph_kernel(cell, xc: Optional[str] = "lda,vwn", disp: float = 1e-3,
               mo_rep: bool = True, conv_tol: float = 1e-12,
               cutoff_au: float = 1e-4, device=None, timer=None) -> EPHResult:
    """Electron-phonon coupling matrices at Gamma (reference
    eph_fd.kernel): 6 natm displaced SCFs and forces on ``device``
    (default: the GPU).

    g_J,pq = sum_ax modes[ax,J] / sqrt(2 m_a omega_J) * vmat[ax,pq]
    for modes with omega > cutoff_au (acoustic/imaginary filtered).
    ``timer`` (a StageTimer) records 'scf', 'potential' and 'gradient'
    for every displaced step."""
    from pyscf_isdf_tpu_torch.utils.timing import null_timer

    dev = resolve_device(device)
    timer = timer or null_timer
    xcspec = XCSpec(xc) if xc is not None else None

    system0 = build_scf_system(cell, device=dev)
    res0 = scf_kernel(system0, xc=xc, conv_tol=conv_tol)
    if not res0["converged"]:
        raise RuntimeError("central SCF not converged")
    niter = [int(res0["niter"])]
    coords0 = np.asarray(cell.coords)
    natm = cell.natm

    # frozen central potential (for the basis-movement correction)
    _, frozen, family = _v_and_frozen(cell, system0, res0, xcspec)

    vmat, grads_p, grads_m = [], [], []
    for ia in range(natm):
        for x in range(3):
            out = []
            for sgn in (+1.0, -1.0):
                c = coords0.copy()
                c[ia, x] += sgn * disp / 2.0
                cell_d = replace(cell, coords=c)
                with timer("scf"):
                    sys_d = build_scf_system(cell_d, device=dev)
                    res_d = scf_kernel(sys_d, xc=xc, conv_tol=conv_tol, dm0=res0["dm"])
                if not res_d["converged"]:
                    raise RuntimeError(f"displaced SCF ({ia},{x},{sgn}) "
                                       "not converged")
                niter.append(int(res_d["niter"]))
                with timer("potential"):
                    V, _, _ = _v_and_frozen(cell_d, sys_d, res_d, xcspec)
                    B = _frozen_matrix(cell_d, sys_d, frozen, family, coords0)
                with timer("gradient"):
                    g = rhf_gradient(sys_d, res_d, xc=xc, device=dev)
                out.append((to_host(V - B), to_host(g)))
            (Vp, gp), (Vm, gm) = out
            vmat.append((Vp - Vm) / disp)
            grads_p.append(gp)
            grads_m.append(gm)
    vmat = np.asarray(vmat)                          # (3N, nao, nao)

    hess = np.asarray([(gp - gm) / disp for gp, gm in zip(grads_p, grads_m)])
    hess = hess.reshape(natm, 3, natm, 3)

    omega, vec = phonon_modes(cell, hess)

    # freq-mass weighting (reference _freq_mass_weighted_vec)
    masses = np.array([ATOMIC_MASS[s] for s in cell.symbols]) * AMU_TO_ME
    keep = omega > cutoff_au
    om_k = omega[keep]
    vec_k = vec[:, keep].reshape(natm, 3, -1)
    wvec = vec_k / np.sqrt(2.0 * masses[:, None, None] * om_k[None, None, :])
    wvec = wvec.reshape(3 * natm, -1)

    gmat = np.einsum("xJ,xpq->Jpq", wvec, vmat)
    if mo_rep:
        C = to_host(res0["mo_coeff"])
        gmat = np.einsum("Jpq,pi,qj->Jij", gmat, C, C)
    return EPHResult(omega=omega, modes=vec, vmat=vmat, g=gmat, hessian=hess,
                     mo_rep=mo_rep, niter=niter)

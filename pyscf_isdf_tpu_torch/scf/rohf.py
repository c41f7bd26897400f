"""Restricted open-shell SCF (ROHF / ROKS) at the Gamma point (torch).

Roothaan single-Fock construction (reference semantics: pyscf/scf/rohf.py):
alpha and beta Fock matrices from the UHF-style veff, combined into the
effective Fock

    R = 1/2 (Pc^T Fc Pc + Po^T Fc Po + Pv^T Fc Pv)
        + Po^T Fb Pc + Po^T Fa Pv + Pv^T Fc Pc + h.c.,   Fc = (Fa + Fb)/2,

with the projectors Pc = D_b S, Po = (D_a - D_b) S, Pv = 1 - D_a S, so the
doubly occupied, singly occupied and virtual spaces share one orbital set.
The energy is the UHF expression evaluated with the shared orbitals. J,
K, Vxc, the eigensolves and DIIS's extrapolation run on the system's
device; only DIIS's small linear solve is on the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df import fftdf
from pyscf_isdf_tpu_torch.ops import coulomb
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.diis import DIIS
from pyscf_isdf_tpu_torch.scf.hf import SCFSystem, exchange_engines, rsh_coeffs
from pyscf_isdf_tpu_torch.ops import becke as becke_mod
from pyscf_isdf_tpu_torch.scf.uhf import _spin_vxc, xc_quadrature
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def roothaan_fock(Fa, Fb, dm_a, dm_b, S):
    """The Roothaan effective Fock of (Fa, Fb) at the densities (D_a, D_b),
    batched over any leading axes (k-points); Hermitian."""
    eye = torch.eye(S.shape[-1], dtype=S.dtype, device=S.device)
    Fc = 0.5 * (Fa + Fb)
    Pc = dm_b @ S
    Po = (dm_a - dm_b) @ S
    Pv = eye - dm_a @ S

    def h(a):
        return a.conj().transpose(-1, -2)

    R = (0.5 * (h(Pc) @ Fc @ Pc + h(Po) @ Fc @ Po + h(Pv) @ Fc @ Pv)
         + h(Po) @ Fb @ Pc + h(Po) @ Fa @ Pv + h(Pv) @ Fc @ Pc)
    return R + h(R)


def rohf_kernel(
    system: SCFSystem,
    xc: Optional[str] = None,
    exxdiv: str = "ewald",
    nelec: Optional[tuple] = None,
    max_cycle: int = 100,
    conv_tol: float = 1e-10,
    diis_space: int = 8,
    df: str = "fftdf",
    isdf_c: float = 8.0,
    verbose: bool = False,
    xc_grids: str = "uniform",
    device=None,
    timer=None,
):
    """Run ROHF (xc=None or 'hf') or ROKS to convergence on ``device``
    (default: the GPU), where ``system`` must have been built.

    Args:
        nelec: (n_alpha, n_beta), n_alpha >= n_beta; default from the
            cell's electron count and spin.
        df: 'fftdf' (exact pair-density FFT exchange) or 'isdf' (the plain
            ISDF factorization built here, GEMM-cost exchange per spin); a
            range-separated hybrid builds the full-range and long-range
            exchange of the engine (ISDF: one shared fit).
        xc_grids: 'uniform' or 'becke[:n_rad,n_theta]' (the Becke
            atomic-grid XC quadrature).
        timer: optional StageTimer; records the ISDF and Becke build stages
            and, per iteration, 'cycle' and within it 'J', 'K', 'XC' and
            'eigh'.

    Returns a dict with e_tot, mo_energy, mo_coeff, dm (D_alpha, D_beta),
    fock (Fa, Fb) — the converged per-spin Fock matrices, not the Roothaan
    one —, nelec, converged and niter.
    """
    becke_mod.parse_xc_grids(xc_grids)
    if df not in ("fftdf", "isdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'fftdf' or 'isdf'")
    device = require_device(system.aoR, device)
    timer = timer or null_timer
    cell = system.cell
    xcspec = XCSpec(xc) if xc is not None else None
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    is_dft = xcspec is not None and xcspec.family != "hf"
    if nelec is None:
        na = (cell.nelectron + cell.spin) // 2
        nb = cell.nelectron - na
    else:
        na, nb = nelec
    if na < nb:
        raise ValueError(f"nelec {nelec}: ROHF needs n_alpha >= n_beta")

    aoR = system.aoR
    dtype = aoR.dtype
    mesh, weight, coulG = system.mesh, system.weight, system.coulG
    # K_eff = hyb K_full + (alpha - hyb) K_LR, each part with its own
    # probe-charge Madelung shift (reference scf/rohf.py:93-121)
    mad_add = hyb * system.madelung
    get_k = None
    if need_k:
        coulGs = [coulG]
        if rsh:
            coulGs.append(torch.as_tensor(coulomb.get_coulG(cell, exxdiv=None, omega=omega),
                                          dtype=dtype, device=device))
            mad_add = mad_add + (alpha - hyb) * coulomb.madelung_omega(cell, None, omega)
        fns = exchange_engines(system, df, coulGs, isdf_c, timer)[0]

        def get_k(dm):
            vk = hyb * fns[0](dm)
            if rsh:
                vk = vk + (alpha - hyb) * fns[1](dm)
            return vk

    xc_ao, xc_grad, xc_w = xc_quadrature(system, xcspec, xc_grids, timer)

    S, hcore, X = system.S, system.hcore, system.X

    def eig(F):
        with timer("eigh"):
            e, u = torch.linalg.eigh(X.T @ F @ X)
            return e, X @ u

    mo_e, mo_c = eig(hcore)
    diis = DIIS(space=diis_space)
    e_last = 0.0
    conv = False
    for it in range(max_cycle):
        with timer("cycle"):
            dm = torch.stack([mo_c[:, :na] @ mo_c[:, :na].T, mo_c[:, :nb] @ mo_c[:, :nb].T])
            dm_t = dm[0] + dm[1]
            with timer("J"):
                vj = fftdf.get_j(aoR, dm_t.to(dtype), coulG, mesh, weight).to(torch.float64)
            veff = vj.expand(2, -1, -1).clone()
            e_xc = 0.0
            if is_dft:
                with timer("XC"):
                    e_xc_t, vxc_a, vxc_b = _spin_vxc(xc_ao, xc_grad, dm[0].to(dtype),
                                                     dm[1].to(dtype), xc_w, xcspec)
                    e_xc = float(e_xc_t)
                veff += torch.stack([vxc_a, vxc_b]).to(torch.float64)
            e_k = 0.0
            if need_k:
                with timer("K"):
                    vk = torch.stack([get_k(dm[0].to(dtype)), get_k(dm[1].to(dtype))]
                                     ).to(torch.float64)
                if exxdiv == "ewald":
                    vk = vk + mad_add * (S @ dm @ S)
                veff -= vk
                e_k = -0.5 * float(torch.einsum("sij,sji->", dm, vk))

            Fa, Fb = hcore + veff[0], hcore + veff[1]
            R = roothaan_fock(Fa, Fb, dm[0], dm[1], S)
            err = X.T @ (S @ dm_t @ R - R @ dm_t @ S) @ X
            R = diis.update(R, err)
            mo_e, mo_c = eig(R)

            e_elec = float(torch.einsum("ij,ji->", dm_t, hcore)
                           + 0.5 * torch.einsum("ij,ji->", dm_t, vj)) + e_xc + e_k
            e_tot = e_elec + system.e_nuc
            de = abs(e_tot - e_last)
            err_norm = float(torch.linalg.norm(err)) / err.numel() ** 0.5
            if verbose:
                print(f"cycle {it:3d}  E = {e_tot:.12f}  dE = {de:.2e}  |err| = {err_norm:.2e}")
            if de < conv_tol and err_norm < conv_tol ** 0.5:
                conv = True
                break
            e_last = e_tot

    return {
        "e_tot": e_tot,
        "mo_energy": mo_e,
        "mo_coeff": mo_c,
        "dm": (dm[0], dm[1]),
        "fock": (Fa, Fb),
        "nelec": (na, nb),
        "converged": conv,
        "niter": it + 1,
    }

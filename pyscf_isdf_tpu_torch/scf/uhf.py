"""Spin-polarised Gamma-point SCF (UHF / UKS, torch).

Spin-resolved version of :mod:`pyscf_isdf_tpu_torch.scf.hf` (reference
semantics: pyscf/pbc/scf/uhf.py + pyscf/pbc/dft/uks.py): separate alpha
and beta density matrices and Fock builds, Coulomb from the total density,
exchange per spin, spin-polarised XC with potentials from autograd. J, K,
Vxc, both eigensolves and the DIIS extrapolation of the stacked (Fa, Fb)
run on the system's device; only DIIS's small linear solve is on the host.

Energy:
    E = sum_s Tr(D_s h) + 1/2 Tr(D_tot J) - 1/2 hyb sum_s Tr(D_s K_s)
        + Exc + E_ewald
"""
from __future__ import annotations

from typing import Optional

import torch

from pyscf_isdf_tpu_torch.df import fftdf
from pyscf_isdf_tpu_torch.ops import becke as becke_mod, coulomb
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.diis import DIIS
from pyscf_isdf_tpu_torch.scf.hf import SCFSystem, exchange_engines, rsh_coeffs
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def _spin_vxc(aoR, ao_grad, dm_a, dm_b, weight, xcspec):
    """(Exc as a device scalar, Vxc_a, Vxc_b) for an LDA, GGA or meta-GGA.
    The GGA potential is the symmetrised 1/2 vrho ao + (2 vs_ss grad rho_s
    + vs_ab grad rho_t) . grad ao form, plus 1/2 w grad ao^T (vtau_s grad
    ao) for a meta-GGA. ``weight`` is the uniform grid's scalar or a
    per-point (ng,) tensor (Becke grids)."""
    ta = aoR @ dm_a
    tb = aoR @ dm_b
    rho_a = torch.clamp((ta * aoR).sum(-1), min=0.0)
    rho_b = torch.clamp((tb * aoR).sum(-1), min=0.0)
    per_point = torch.is_tensor(weight)

    def wsum(x):
        return (weight * x).sum() if per_point else weight * x.sum()

    def wmat(a, v, w=None):
        """w sum_g a_g^T v_g a_g over the rows g of ``a`` (``w``: the
        per-row weights when the rows are not the grid's points)."""
        if not per_point:
            return weight * ((a.T * v) @ a)
        return (a.T * ((weight if w is None else w) * v)) @ a

    if xcspec.family == "lda":
        exc, (va, vb), _ = xcspec.exc_vxc_spin(rho_a, rho_b)
        return wsum((rho_a + rho_b) * exc), wmat(aoR, va), wmat(aoR, vb)
    ga = 2.0 * torch.einsum("gi,xgi->xg", ta, ao_grad)
    gb = 2.0 * torch.einsum("gi,xgi->xg", tb, ao_grad)
    s_aa, s_ab, s_bb = (ga * ga).sum(0), (ga * gb).sum(0), (gb * gb).sum(0)
    vtau = (None, None)
    if xcspec.family == "mgga":
        tau_a = 0.5 * ((ao_grad @ dm_a) * ao_grad).sum((0, 2))
        tau_b = 0.5 * ((ao_grad @ dm_b) * ao_grad).sum((0, 2))
        exc, (va, vb), (vsaa, vsab, vsbb), vtau = xcspec.exc_vxc_mgga_spin(
            rho_a, rho_b, s_aa, s_ab, s_bb, tau_a, tau_b)
    else:
        exc, (va, vb), (vsaa, vsab, vsbb) = xcspec.exc_vxc_spin(
            rho_a, rho_b, s_aa, s_ab, s_bb)
    nao = aoR.shape[1]
    g2 = ao_grad.reshape(-1, nao)

    def vmat(vrho, vs_ss, g_s, g_t, vt):
        aow = 0.5 * vrho[:, None] * aoR + torch.einsum(
            "xg,xgi->gi", 2.0 * vs_ss * g_s + vsab * g_t, ao_grad)
        half = aoR.T @ (weight[:, None] * aow) if per_point else weight * (aoR.T @ aow)
        out = half + half.T
        if vt is not None:
            out = out + 0.5 * wmat(g2, vt.repeat(3), weight.repeat(3) if per_point else None)
        return out

    return (wsum((rho_a + rho_b) * exc),
            vmat(va, vsaa, ga, gb, vtau[0]), vmat(vb, vsbb, gb, ga, vtau[1]))


def xc_quadrature(system, xcspec, xc_grids, timer=None):
    """(AO values, AO gradients or None, weight) of the XC quadrature of a
    Gamma driver: the uniform grid (spectral gradients, scalar weight) or
    the Becke cloud (per-point weights) of ``xc_grids``."""
    is_dft = xcspec is not None and xcspec.family != "hf"
    need_grad = is_dft and xcspec.family in ("gga", "mgga")
    aoR = system.aoR
    becke = becke_mod.becke_xc_inputs(system.cell, xc_grids, need_grad,
                                      device=aoR.device, timer=timer) \
        if is_dft else None
    if becke is not None:
        return becke[:3]
    grad = ao_gradient_fft(aoR, system.mesh, system.Gv) if need_grad else None
    return aoR, grad, system.weight


def _spin_square(dm_a, dm_b, S, na, nb) -> float:
    """<S^2> = Sz (Sz + 1) + nb - tr(D_a S D_b S) of a UHF determinant."""
    cross = float(torch.einsum("ij,jk,kl,li->", dm_a, S, dm_b, S))
    sz = (na - nb) * 0.5
    return sz * (sz + 1) + nb - cross


def uhf_kernel(
    system: SCFSystem,
    xc: Optional[str] = None,
    exxdiv: str = "ewald",
    nelec: Optional[tuple] = None,
    max_cycle: int = 100,
    conv_tol: float = 1e-10,
    diis_space: int = 8,
    dm0=None,
    breaksym: bool = False,
    get_jk=None,
    df: str = "fftdf",
    isdf_c: float = 8.0,
    isdf_precision: Optional[str] = None,
    verbose: bool = False,
    xc_grids: str = "uniform",
    timer=None,
):
    """Run the spin-polarised SCF on the system's device. xc=None (or
    'hf') -> UHF; else UKS.

    Args:
        nelec: (n_alpha, n_beta); default from the cell's electron count
            and spin.
        dm0: optional (D_alpha, D_beta) start; default the core
            Hamiltonian's aufbau filling, with ``breaksym`` scaling
            D_beta by 0.9 when n_alpha == n_beta.
        get_jk: optional override ``(dm_spin (2, nao, nao), with_k) ->
            (vj, (vk_alpha, vk_beta))``, vj from the total density.
        df: 'fftdf' (exact pair-density FFT exchange) or 'isdf' (ISDF
            factorization built here, GEMM-cost exchange); a
            range-separated hybrid builds the full-range and long-range
            exchange of the engine (ISDF: one shared fit). J is the exact
            FFT Poisson solve. 'aegdf' (a system built with ``ae=True``)
            takes J from the total density and K per spin from the
            analytic all-electron fit tensor.
        xc_grids: 'uniform' or 'becke[:n_rad,n_theta]' (the Becke
            atomic-grid XC quadrature).
        timer: optional StageTimer; records the ISDF and Becke build stages
            and, per iteration, 'cycle' and within it 'J', 'K' (internal
            engines), 'XC' and 'eigh'.

    ``isdf_precision='dd'`` is not ported and raises ``NotImplementedError``.

    Returns a dict with e_tot, mo_energy and mo_coeff ((alpha, beta)
    tensors), dm (D_alpha, D_beta), nelec, converged, niter and s_squared.
    """
    becke_mod.parse_xc_grids(xc_grids)
    if df not in ("fftdf", "isdf", "aegdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'fftdf', 'isdf' "
                         "or 'aegdf'")
    if isdf_precision is not None:
        raise NotImplementedError(f"isdf precision {isdf_precision!r}: the "
                                  "port solves in the working dtype (float64)")
    timer = timer or null_timer
    cell = system.cell
    xcspec = XCSpec(xc) if xc is not None else None
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    is_dft = xcspec is not None and xcspec.family != "hf"
    k_scale = 1.0 if rsh else hyb
    mad_add = system.madelung
    if rsh:
        mad_add = hyb * system.madelung \
            + (alpha - hyb) * coulomb.madelung_omega(cell, None, omega)
    if nelec is None:
        na = (cell.nelectron + cell.spin) // 2
        nb = cell.nelectron - na
    else:
        na, nb = nelec

    aoR = system.aoR
    dtype, device = aoR.dtype, aoR.device
    mesh, weight, coulG = system.mesh, system.weight, system.coulG

    if get_jk is None and df == "aegdf":
        from pyscf_isdf_tpu_torch.df.aegdf import build_ae_gdf
        from pyscf_isdf_tpu_torch.df.gdf import get_jk_cd

        if not system.ae:
            raise ValueError("df='aegdf' needs build_scf_system(ae=True)")
        if rsh:
            raise NotImplementedError("aegdf with range-separated exchange")
        cderi = build_ae_gdf(cell, omega=system.ae_omega, device=device).cderi

        def get_jk(dm_spin, with_k):
            vj = get_jk_cd(cderi, dm_spin[0] + dm_spin[1])[0]
            if not with_k:
                return vj, None
            return vj, (get_jk_cd(cderi, dm_spin[0])[1],
                        get_jk_cd(cderi, dm_spin[1])[1])

    if get_jk is None:
        get_k_fn = None
        if need_k:
            coulG_k = coulG
            if exxdiv not in (None, "ewald"):
                coulG_k = torch.as_tensor(coulomb.get_coulG(cell, exxdiv=exxdiv),
                                          dtype=dtype, device=device)
            coulGs = [coulG_k]
            if rsh:
                coulGs.append(torch.as_tensor(
                    coulomb.get_coulG(cell, exxdiv=None, omega=omega),
                    dtype=dtype, device=device))
            fns = exchange_engines(system, df, coulGs, isdf_c, timer)[0]
            if rsh:
                def get_k_fn(dmj):
                    return hyb * fns[0](dmj) + (alpha - hyb) * fns[1](dmj)
            else:
                get_k_fn = fns[0]

        def get_jk(dm_spin, with_k):
            dmj = dm_spin.to(dtype)
            with timer("J"):
                vj = fftdf.get_j(aoR, dmj[0] + dmj[1], coulG, mesh, weight)
            if not with_k:
                return vj, None
            with timer("K"):
                return vj, (get_k_fn(dmj[0]), get_k_fn(dmj[1]))

    xc_ao, xc_grad, xc_w = xc_quadrature(system, xcspec, xc_grids, timer)
    S, hcore, X = system.S, system.hcore, system.X

    def eig(F):
        with timer("eigh"):
            e, u = torch.linalg.eigh(X.T @ F @ X)
            return e, X @ u

    def fill(c, n):
        return c[:, :n] @ c[:, :n].T

    if dm0 is None:
        _, mo_c = eig(hcore)
        dm = torch.stack([fill(mo_c, na), fill(mo_c, nb)])
        if breaksym and na == nb:
            dm[1] *= 0.9                      # let the beta channel break symmetry
    else:
        dm = torch.stack([torch.as_tensor(d, dtype=torch.float64, device=device)
                          for d in dm0])

    diis = DIIS(space=diis_space)
    e_last = 0.0
    conv = False
    for it in range(max_cycle):
        with timer("cycle"):
            dm_t = dm[0] + dm[1]
            vj, vk = get_jk(dm, need_k)
            vj = torch.as_tensor(vj, device=device).to(torch.float64)
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
                vk = torch.stack([torch.as_tensor(v, device=device) for v in vk]
                                 ).to(torch.float64)
                if exxdiv == "ewald":
                    vk = vk + mad_add * (S @ dm @ S)
                veff -= k_scale * vk
                e_k = -0.5 * k_scale * float(torch.einsum("sij,sji->", dm, vk))

            F = hcore + veff
            err = X.T @ (S @ dm @ F - F @ dm @ S) @ X
            F = diis.update(F, err)
            mo_e, mo_c = eig(F)
            dm_new = torch.stack([fill(mo_c[0], na), fill(mo_c[1], nb)])

            e_elec = float(torch.einsum("ij,ji->", dm_t, hcore)
                           + 0.5 * torch.einsum("ij,ji->", dm_t, vj)) + e_xc + e_k
            e_tot = e_elec + system.e_nuc
            de = abs(e_tot - e_last)
            err_norm = float(torch.linalg.norm(err)) / max(1, err.numel()) ** 0.5
            if verbose:
                print(f"cycle {it:3d}  E = {e_tot:.12f}  dE = {de:.2e}  |err| = {err_norm:.2e}")
            dm = dm_new
            if de < conv_tol and err_norm < conv_tol ** 0.5:
                conv = True
                break
            e_last = e_tot

    return {
        "e_tot": e_tot,
        "mo_energy": (mo_e[0], mo_e[1]),
        "mo_coeff": (mo_c[0], mo_c[1]),
        "dm": (dm[0], dm[1]),
        "nelec": (na, nb),
        "converged": conv,
        "niter": it + 1,
        "s_squared": _spin_square(dm[0], dm[1], S, na, nb),
    }

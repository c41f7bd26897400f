"""Periodic closed-shell SCF driver (Gamma point, torch).

Once-per-geometry setup (:func:`build_scf_system` — AO collocation through
the culled-image kernel, lattice-sum overlap/kinetic, GTH pseudopotential
or all-electron nuclear matrices, Coulomb kernel, Ewald and Madelung
constants), then a host-orchestrated iteration whose J, K, Vxc and
eigensolves run on the system's device.

Energy contract matches the reference SCF
(pyscf/scf/hf.py:46-235 loop; pyscf/pbc/scf/hf.py:490-795 PBC pieces):
  RHF:  E = Tr(D h) + 1/2 Tr(D J) - 1/4 Tr(D K) + E_ewald
  RKS:  E = Tr(D h) + 1/2 Tr(D J) + Exc - 1/4 hyb Tr(D K) + E_ewald
with exxdiv='ewald' applying the madelung S D S shift to K.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from pyscf_isdf_tpu_torch.cell import Cell
from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.df import fftdf
from pyscf_isdf_tpu_torch.ops import becke as becke_mod, coulomb, pp as pp_ops
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.ops.cuda_ao import make_ao_evaluator
from pyscf_isdf_tpu_torch.ops.ft_ao import overlap_and_kinetic
from pyscf_isdf_tpu_torch.utils.timing import null_timer
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.diis import DIIS
from pyscf_isdf_tpu_torch.scf.occupations import smearing_occ_rhf


@dataclass(frozen=True, eq=False)
class SCFSystem:
    """Per-geometry constants for the SCF loop (tensors on one device)."""

    cell: Cell
    S: torch.Tensor          # (nao, nao) float64 overlap
    hcore: torch.Tensor      # (nao, nao) float64 core Hamiltonian
    X: torch.Tensor          # (nao, nao') S^{-1/2} canonical orthogonalizer
    aoR: torch.Tensor        # (ngrids, nao) AO values
    coulG: torch.Tensor      # (ngrids,) Coulomb kernel, G=0 -> 0
    madelung: float
    e_nuc: float
    mesh: tuple
    weight: float            # vol / ngrids
    nelec: int
    Gv: torch.Tensor         # (ngrids, 3) for spectral gradients
    ae: bool = False         # analytic all-electron S/hcore (df/aegdf.py)
    ae_omega: float = 0.4    # SR/LR split of the analytic build


def orthogonalizer(S: torch.Tensor) -> torch.Tensor:
    """Canonical S^{-1/2}, dropping eigenvalues below 1e-12."""
    w, v = torch.linalg.eigh(S)
    keep = w > 1e-12
    return v[:, keep] / torch.sqrt(w[keep])


def build_scf_system(cell: Cell, device=None, dtype=torch.float64, aoR=None,
                     timer=None, ae: bool = False,
                     ae_omega: float = 0.4) -> SCFSystem:
    """One-time setup on ``device`` (default: the GPU).

    ``aoR`` (optional) skips the collocation. The hcore build always uses
    float64 AO values; the system's ``aoR`` is cast to ``dtype``.
    ``ae=True`` builds the all-electron system: S and hcore from the
    analytic mesh-free engines (:func:`~pyscf_isdf_tpu_torch.df.aegdf.ae_hcore`,
    range split ``ae_omega``) instead of the uniform-mesh quadrature; aoR
    is still collocated for the XC quadrature and the FFT engines. An
    isolated cell (dimension 0) takes the bare nuclear repulsion and no
    probe-charge shift.
    ``timer`` (a :class:`~pyscf_isdf_tpu_torch.utils.timing.StageTimer`)
    records the stages 'ao_plan', 'aoR', 'S/T', 'pp' and 'coulomb'.
    """
    device = resolve_device(device)
    timer = timer or null_timer
    f64 = dict(dtype=torch.float64, device=device)
    if aoR is None:
        with timer("ao_plan"):
            evaluate = make_ao_evaluator(cell, dtype=torch.float64, device=device)
        with timer("aoR"):
            aoR64 = evaluate()
    else:
        aoR64 = torch.as_tensor(aoR, **f64)

    if ae:
        from pyscf_isdf_tpu_torch.df.aegdf import ae_hcore

        with timer("S/T"):
            S, hcore = ae_hcore(cell, ae_omega, device=device)
    else:
        with timer("S/T"):
            S, T = overlap_and_kinetic(cell, device=device)
        with timer("pp"):
            if cell.pseudos:
                vpp = pp_ops.get_pp(cell, aoR64)
            else:
                vpp = pp_ops.get_nuc(cell, aoR64)
        hcore = T + vpp
    X = orthogonalizer(S)

    with timer("coulomb"):
        coulG = coulomb.get_coulG(cell)  # G=0 -> 0 (3-D), truncated below
        if cell.dimension != 0:
            mad = coulomb.madelung(cell)
            e_nuc = coulomb.ewald(cell)
        else:
            from pyscf_isdf_tpu_torch.df.aegdf import _e_nuc_molecular

            mad, e_nuc = 0.0, _e_nuc_molecular(cell)

    return SCFSystem(
        cell=cell, S=S, hcore=hcore, X=X,
        aoR=aoR64.to(dtype),
        coulG=torch.as_tensor(coulG, dtype=dtype, device=device),
        madelung=mad, e_nuc=e_nuc, mesh=tuple(cell.mesh),
        weight=cell.grid_weight, nelec=cell.nelectron,
        Gv=torch.as_tensor(cell.get_Gv(), dtype=dtype, device=device),
        ae=ae, ae_omega=ae_omega,
    )


# ------------------------------------------------------------------ KS pieces
def _vxc_lda(aoR, dm, weight, xc: XCSpec):
    rho = fftdf.get_rho(aoR, dm)
    exc, vrho, _ = xc.exc_vxc(rho)
    e_xc = weight * torch.sum(rho * exc)
    vmat = weight * ((aoR.T * vrho) @ aoR)
    n_elec = weight * torch.sum(rho)
    return e_xc, vmat, n_elec


def _vxc_gga(aoR, ao_grad, dm, weight, xc: XCSpec):
    t = aoR @ dm                                    # (ng, nao)
    rho = (t * aoR).sum(-1)
    grad_rho = 2.0 * torch.einsum("gi,xgi->xg", t, ao_grad)
    sigma = (grad_rho * grad_rho).sum(0)
    exc, vrho, vsigma = xc.exc_vxc(rho, sigma)
    e_xc = weight * torch.sum(rho * exc)
    # V = ao^T (1/2 vrho ao + 2 vsigma grad_rho . grad_ao) + h.c.
    aow = 0.5 * vrho[:, None] * aoR + 2.0 * torch.einsum(
        "xg,xgi->gi", grad_rho * vsigma, ao_grad)
    half = weight * (aoR.T @ aow)
    vmat = half + half.T
    n_elec = weight * torch.sum(rho)
    return e_xc, vmat, n_elec


def _vxc_mgga(aoR, ao_grad, dm, weight, xc: XCSpec):
    """tau-rung quadrature: rho, sigma and tau = 1/2 sum_x (grad_x ao D)
    . grad_x ao from the spectral AO gradients of the GGA path; the
    potential gains the tau term 1/2 w grad_ao^T (vtau grad_ao)."""
    t = aoR @ dm                                    # (ng, nao)
    rho = (t * aoR).sum(-1)
    grad_rho = 2.0 * torch.einsum("gi,xgi->xg", t, ao_grad)
    sigma = (grad_rho * grad_rho).sum(0)
    tau = 0.5 * ((ao_grad @ dm) * ao_grad).sum((0, 2))
    exc, vrho, vsigma, vtau = xc.exc_vxc_mgga(rho, sigma, tau)
    e_xc = weight * torch.sum(rho * exc)
    aow = 0.5 * vrho[:, None] * aoR + 2.0 * torch.einsum(
        "xg,xgi->gi", grad_rho * vsigma, ao_grad)
    half = weight * (aoR.T @ aow)
    nao = aoR.shape[1]
    vtau_term = 0.5 * weight * ((ao_grad * vtau[:, None]).reshape(-1, nao).T
                                @ ao_grad.reshape(-1, nao))
    vmat = half + half.T + vtau_term
    n_elec = weight * torch.sum(rho)
    return e_xc, vmat, n_elec


def _vxc(aoR, ao_grad, dm, weight, xc: XCSpec):
    """(e_xc, vxc, n_elec) on the uniform grid for an LDA, GGA or meta-GGA
    (e_xc and n_elec as device scalars)."""
    if xc.family == "mgga":
        return _vxc_mgga(aoR, ao_grad, dm, weight, xc)
    if xc.family == "gga":
        return _vxc_gga(aoR, ao_grad, dm, weight, xc)
    return _vxc_lda(aoR, dm, weight, xc)


def rsh_coeffs(xcspec) -> tuple:
    """(hyb, alpha, omega) of a functional, (1, 1, 0) for RHF (None).

    K_eff = hyb K_full + (alpha - hyb) K_LR(omega) for a range-separated
    hybrid (omega != 0), hyb K_full otherwise."""
    if xcspec is None:
        return 1.0, 1.0, 0.0
    return xcspec.hyb, xcspec.alpha, xcspec.omega


def exchange_engines(system, df, coulGs, isdf_c, timer=None):
    """Exchange functions ``dm -> K`` of one engine, one per Coulomb kernel
    in ``coulGs``, and the factorizations they use.

    'isdf' and 'isdf-robust' share one IP selection and xi fit across the
    kernels (:func:`~pyscf_isdf_tpu_torch.df.isdf.build_isdf_multi`);
    'fftdf' is the exact pair-density FFT build. Returns (functions,
    factorizations), the latter empty for 'fftdf'.
    """
    aoR, mesh, weight = system.aoR, system.mesh, system.weight
    if df == "fftdf":
        return [lambda dm, g=g: fftdf.get_k(aoR, dm, g, mesh, weight)
                for g in coulGs], ()
    from pyscf_isdf_tpu_torch.df import isdf as isdf_mod

    robust = df == "isdf-robust"
    facs = isdf_mod.build_isdf_multi(aoR, coulGs, mesh, weight, c=isdf_c,
                                     keep_v=robust, timer=timer)
    if robust:
        return [lambda dm, f=f: isdf_mod.get_k_robust(f, aoR, dm, weight)
                for f in facs], facs
    return [lambda dm, f=f: isdf_mod.get_k(f, dm) for f in facs], facs


def fitted_jk(system, df, hyb, alpha, omega, timer=None):
    """The fit and the ``get_jk(dm, with_k, C_w=None)`` of the fitted
    engines: 'gdf' (a second fit in the long-range metric for a
    range-separated hybrid, combined as hyb K_full + (alpha - hyb) K_LR)
    or 'aegdf' (a system built with ``ae=True``; no range separation)."""
    from pyscf_isdf_tpu_torch.df import gdf as gdf_mod

    timer = timer or null_timer
    cell, aoR = system.cell, system.aoR
    rsh = omega != 0.0
    fits = []
    if df == "aegdf":
        from pyscf_isdf_tpu_torch.df.aegdf import build_ae_gdf

        if not system.ae:
            raise ValueError("df='aegdf' needs build_scf_system(ae=True) "
                             "(analytic S/hcore)")
        if rsh:
            raise NotImplementedError("aegdf with range-separated exchange")
        fits.append(build_ae_gdf(cell, omega=system.ae_omega, device=aoR.device))
    else:
        # one collocation of the auxiliary basis serves both metrics
        aux = gdf_mod.collocate_aux(cell, gdf_mod.make_auxcell(cell), aoR.device, timer)
        coulGs = [system.coulG]
        if rsh:
            coulGs.append(coulomb.get_coulG(cell, exxdiv=None, omega=omega))
        for coulG in coulGs:
            fits.append(gdf_mod.build_gdf(cell, aoR, coulG, system.mesh, system.weight,
                                          aoR_aux=aux, timer=timer))
        del aux

    def get_jk(dm, with_k, C_w=None):
        with timer("JK"):
            vj, vk = gdf_mod.get_jk(fits[0], dm)
            if not with_k:
                return vj, None
            if rsh:
                vk = hyb * vk + (alpha - hyb) * gdf_mod.get_jk(fits[1], dm)[1]
            return vj, vk

    return fits[0], get_jk


def make_rdm1(mo_coeff: torch.Tensor, nocc: int) -> torch.Tensor:
    c = mo_coeff[:, :nocc]
    return 2.0 * c @ c.T


def _trace(a, b) -> float:
    return float(torch.einsum("ij,ji->", a, b))


def scf_kernel(
    system: SCFSystem,
    xc: Optional[str] = None,
    exxdiv: str = "ewald",
    max_cycle: int = 60,
    conv_tol: float = 1e-10,
    diis_space: int = 8,
    dm0=None,
    get_jk=None,
    df: str = "fftdf",
    isdf_c: float = 8.0,
    isdf_precision: Optional[str] = None,
    level_shift: float = 0.0,
    damping: float = 0.0,
    sigma: float = 0.0,
    smearing_method: str = "fermi",
    v_ext=None,
    xc_grids: str = "uniform",
    verbose: bool = False,
    timer=None,
):
    """Run the SCF to convergence on the system's device.

    Args:
        xc: None for RHF, else a functional name of
            :class:`~pyscf_isdf_tpu_torch.ops.xc.XCSpec` ('lda,vwn', 'pbe',
            'pbe0', 'b3lyp', 'hse06', 'scan', 'hf', ...).
        get_jk: optional override ``(dm, with_k) -> (vj, vk)``.
        df: 'fftdf' (exact pair-density FFT exchange), 'isdf' (ISDF
            factorization built here, GEMM-cost exchange) or 'isdf-robust'
            (robust-fit ISDF exchange through the cross-term kernel), with
            J the exact FFT Poisson solve; 'gdf' (Gaussian density fitting
            on the grid, :mod:`~pyscf_isdf_tpu_torch.df.gdf`) or 'aegdf'
            (the analytic all-electron fit of a system built with
            ``ae=True``, :mod:`~pyscf_isdf_tpu_torch.df.aegdf`), J and K
            from the whitened fit tensor. A range-separated hybrid builds
            the full-range and the long-range exchange of the engine (the
            ISDF engines from one shared fit, 'gdf' from a second fit in
            the long-range metric), combined as hyb K_full + (alpha - hyb)
            K_LR, each with its own probe-charge Madelung shift; 'aegdf'
            takes none.
        sigma: smearing width (Ha); ``sigma > 0`` gives finite-temperature
            occupations (:func:`~pyscf_isdf_tpu_torch.scf.occupations.smearing_occ_rhf`,
            ``smearing_method`` 'fermi' or Gaussian) and turns the
            occupied-MO exchange off.
        v_ext: optional (nao, nao) external one-body potential added to the
            Fock operator each cycle but not to the reported energy.
        xc_grids: 'uniform' (the FFT grid) or 'becke[:n_rad,n_theta]', the
            Becke atomic-grid XC quadrature
            (:func:`~pyscf_isdf_tpu_torch.ops.becke.becke_xc_inputs`); J and
            K stay on their engine.
        timer: optional StageTimer; records the ISDF, GDF and Becke build
            stages and, per iteration, 'cycle' and within it 'J', 'K' (or
            'JK' for the fitted engines), 'XC' and 'eigh'.

    ``isdf_precision='dd'`` is not ported (float64 replaces it) and raises
    ``NotImplementedError``.

    Returns a dict with e_tot, mo_energy, mo_coeff, mo_occ (None unless
    smeared), dm, converged, niter (tensors on the system's device),
    entropy, mu and e_free = e_tot - sigma * entropy (0, None and e_tot
    without smearing), isdf, the factorization the ISDF engines built
    (None otherwise), isdf_lr, the long-range one of a range-separated
    hybrid (None otherwise), gdf, the fit of 'gdf' or 'aegdf' (None
    otherwise), and becke, the Becke grid (None on the uniform grid).
    """
    becke_mod.parse_xc_grids(xc_grids)
    if get_jk is None and df not in ("fftdf", "isdf", "isdf-robust", "gdf",
                                     "aegdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'fftdf', 'isdf', "
                         "'isdf-robust', 'gdf' or 'aegdf'")
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
    # range separation (reference pbc/dft/rks.py:108-121): get_k returns
    # the combined hyb K_full + (alpha - hyb) K_LR, the loop's scale is 1,
    # and each part carries its own probe-charge Madelung constant
    k_scale = 1.0 if rsh else hyb
    mad_add = system.madelung
    if rsh:
        mad_add = hyb * system.madelung \
            + (alpha - hyb) * coulomb.madelung_omega(cell, None, omega)

    aoR = system.aoR
    dtype, device = aoR.dtype, aoR.device
    mesh = system.mesh
    weight = system.weight
    coulG = system.coulG
    nocc = system.nelec // 2

    need_grad = is_dft and xcspec.family in ("gga", "mgga")
    becke = becke_mod.becke_xc_inputs(cell, xc_grids, need_grad, device=device,
                                      timer=timer) if is_dft else None
    ao_grad = None
    if need_grad and becke is None:
        ao_grad = ao_gradient_fft(aoR, mesh, system.Gv)

    internal_jk = get_jk is None
    facs = ()
    fit = None
    if get_jk is None and df in ("gdf", "aegdf"):
        fit, get_jk = fitted_jk(system, df, hyb, alpha, omega, timer)
    if get_jk is None:
        coulG_k = coulG
        if need_k and exxdiv not in (None, "ewald"):
            coulG_k = torch.as_tensor(coulomb.get_coulG(cell, exxdiv=exxdiv),
                                      dtype=dtype, device=device)
        if need_k:
            coulGs = [coulG_k]
            if rsh:
                coulGs.append(torch.as_tensor(
                    coulomb.get_coulG(cell, exxdiv=None, omega=omega),
                    dtype=dtype, device=device))
            fns, facs = exchange_engines(system, df, coulGs, isdf_c, timer)
            if rsh:
                def get_k_fn(dmj):
                    return hyb * fns[0](dmj) + (alpha - hyb) * fns[1](dmj)
            else:
                get_k_fn = fns[0]

        occ_k_capable = df == "fftdf" and not rsh

        def get_jk(dm, with_k, C_w=None):
            dmj = dm.to(dtype)
            with timer("J"):
                vj = fftdf.get_j(aoR, dmj, coulG, mesh, weight)
            if not with_k:
                return vj, None
            with timer("K"):
                if C_w is not None and occ_k_capable:
                    # occupied-MO exchange (reference's tagged-DM path)
                    vk = fftdf.get_k_occ(aoR, aoR @ C_w.to(dtype), coulG_k,
                                         mesh, weight)
                else:
                    vk = get_k_fn(dmj)
            return vj, vk

    S, hcore, X = system.S, system.hcore, system.X

    def eig(F):
        with timer("eigh"):
            e, u = torch.linalg.eigh(X.T @ F @ X)
            return e, X @ u

    smeared = sigma > 0
    entropy, mu = 0.0, None

    def make_dm(mo_e, mo_c):
        """(density, occupations or None) of the eigenpairs."""
        nonlocal entropy, mu
        if not smeared:
            return make_rdm1(mo_c, nocc), None
        occs, entropy, mu = smearing_occ_rhf([mo_e.cpu().numpy()], system.nelec,
                                             sigma, smearing_method)
        occ = torch.as_tensor(occs[0], device=device)
        return (mo_c * occ) @ mo_c.T, occ

    mo_occ = None
    if dm0 is None:
        mo_e, mo_c = eig(hcore)
        dm, mo_occ = make_dm(mo_e, mo_c)
    else:
        # Gamma-point densities are real
        dm0 = torch.as_tensor(dm0, device=device)
        dm = (dm0.real if dm0.is_complex() else dm0).to(torch.float64)
    if v_ext is not None:
        v_ext = torch.as_tensor(v_ext, dtype=torch.float64, device=device)

    diis = DIIS(space=diis_space)
    e_last = 0.0
    conv = False
    C_w = None
    F_last = None
    for it in range(max_cycle):
        with timer("cycle"):
            if internal_jk:
                vj, vk = get_jk(dm, need_k, C_w)
            else:
                vj, vk = get_jk(dm, need_k)
            vj = torch.as_tensor(vj, device=device).to(torch.float64)
            veff = vj.clone()
            e_xc = 0.0
            if is_dft:
                with timer("XC"):
                    if becke is None:
                        e_xc_t, vxc, _ = _vxc(aoR, ao_grad, dm.to(dtype), weight,
                                              xcspec)
                    else:
                        b_ao, b_grad, b_w, _ = becke
                        e_xc_t, vxc, _ = becke_mod.vxc(b_ao, b_grad, dm, b_w, xcspec)
                    e_xc = float(e_xc_t)
                veff += vxc.to(torch.float64)
            e_k = 0.0
            if need_k:
                vk = torch.as_tensor(vk, device=device).to(torch.float64)
                if exxdiv == "ewald":
                    vk = fftdf.apply_ewald_exxdiv(vk, dm, S, mad_add)
                veff -= 0.5 * k_scale * vk
                e_k = -0.25 * k_scale * _trace(dm, vk)

            F = hcore + veff
            if v_ext is not None:
                F = F + v_ext
            if level_shift > 0:
                # shift virtual levels up: F += shift (S - S D/2 S)
                F = F + level_shift * (S - S @ (0.5 * dm) @ S)
            if damping > 0 and it > 0:
                F = (1 - damping) * F + damping * F_last
            F_last = F
            # DIIS extrapolation on the Fock matrix
            sds = S @ dm @ F - F @ dm @ S
            err = X.T @ sds @ X
            F = diis.update(F, err)

            mo_e, mo_c = eig(F)
            dm_new, mo_occ = make_dm(mo_e, mo_c)
            # integer occupations -> occupied-MO exchange next cycle
            C_w = None if smeared else mo_c[:, :nocc] * 2.0 ** 0.5

            e_elec = _trace(dm, hcore) + 0.5 * _trace(dm, vj) + e_xc + e_k
            e_tot = float(e_elec + system.e_nuc)
            de = abs(e_tot - e_last)
            err_norm = float(torch.linalg.norm(err)) / max(1, err.numel()) ** 0.5
            if verbose:
                print(f"cycle {it:3d}  E = {e_tot:.12f}  dE = {de:.2e}  |err| = {err_norm:.2e}")
            if de < conv_tol and err_norm < conv_tol ** 0.5:
                conv = True
                dm = dm_new
                break
            dm = dm_new
            e_last = e_tot

    return {
        "e_tot": e_tot,
        "mo_energy": mo_e,
        "mo_coeff": mo_c,
        "mo_occ": mo_occ,
        "dm": dm,
        "converged": conv,
        "niter": it + 1,
        "entropy": entropy,
        "mu": mu,
        "e_free": e_tot - sigma * entropy if smeared else e_tot,
        "isdf": facs[0] if facs else None,
        "isdf_lr": facs[1] if len(facs) > 1 else None,
        "gdf": fit,
        "becke": None if becke is None else becke[3],
    }

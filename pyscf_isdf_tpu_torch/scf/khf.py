"""k-point sampled closed-shell SCF (KRHF / KRKS, torch).

Complex Bloch-orbital version of :mod:`pyscf_isdf_tpu_torch.scf.hf`
(reference semantics: pyscf/pbc/scf/khf.py:409-757 — global Fermi filling
across k-points, 1/nk-weighted energy traces, per-k Fock eigensolves).
Float64 / complex128 setup per k-point and every per-cycle J/K/Vxc and
eigensolve on the system's device; only the DIIS coefficients and the
occupation sort touch the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pyscf_isdf_tpu_torch import symm
from pyscf_isdf_tpu_torch.cell import Cell
from pyscf_isdf_tpu_torch.device import require_device, resolve_device
from pyscf_isdf_tpu_torch.df import fftdf_k
from pyscf_isdf_tpu_torch.ops import becke as becke_mod, coulomb, pp as pp_ops
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft_k, eval_ao_kpts
from pyscf_isdf_tpu_torch.ops.ft_ao import overlap_and_kinetic
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.dftu import HubbardU
from pyscf_isdf_tpu_torch.scf.diis import DIIS
from pyscf_isdf_tpu_torch.scf.hf import rsh_coeffs
from pyscf_isdf_tpu_torch.scf.occupations import (
    exact_count_occ, smearing_occ_ibz, smearing_occ_rhf,
)
from pyscf_isdf_tpu_torch.utils.timing import null_timer


@dataclass(frozen=True, eq=False)
class KSCFSystem:
    """Per-geometry constants of the k-point SCF (tensors on one device)."""

    cell: Cell
    kpts: np.ndarray           # (nk, 3)
    S: torch.Tensor            # (nk, nao, nao) complex128
    hcore: torch.Tensor        # (nk, nao, nao) complex128
    X: tuple                   # nk orthogonalizers (nao, nrank_k), ranks may differ
    aoR_k: torch.Tensor        # (nk, ng, nao) complex Bloch AOs
    coulG: torch.Tensor        # (ng,) q=0 kernel
    coulG_pairs: torch.Tensor  # (nk, nk, ng)
    expmikr: torch.Tensor      # (nk, nk, ng) complex, exp(-i (k2-k1).r)
    madelung: float
    e_nuc: float
    mesh: tuple
    weight: float
    nelec_tot: int             # electrons in the full k-sampled supercell
    ae: bool = False           # analytic all-electron S/hcore (df/aegdf.py)
    ae_omega: float = 0.4      # SR/LR split of the analytic build


def orthogonalizers(S: torch.Tensor) -> tuple:
    """Canonical S_k^{-1/2} per k, dropping eigenvalues below 1e-12 (the
    kept rank may differ between k-points)."""
    w, v = torch.linalg.eigh(S)
    keep = w > 1e-12
    return tuple(v[k][:, keep[k]] / torch.sqrt(w[k][keep[k]])
                 for k in range(S.shape[0]))


def build_kscf_system(cell: Cell, kpts, device=None, ae: bool = False,
                      ae_omega: float = 0.4, timer=None) -> KSCFSystem:
    """One-time k-point setup on ``device`` (default: the GPU), float64.

    ``ae=True`` builds the all-electron system: per-k S and hcore from the
    analytic mesh-free engines
    (:func:`~pyscf_isdf_tpu_torch.df.aegdf.ae_hcore_kpts`, range split
    ``ae_omega``); the Bloch AOs are still collocated for the XC quadrature
    and the FFT engines. ``timer`` (a
    :class:`~pyscf_isdf_tpu_torch.utils.timing.StageTimer`) records the
    stages 'aoR_k', 'S/T', 'pp' and 'coulomb'.
    """
    device = resolve_device(device)
    timer = timer or null_timer
    kpts = np.reshape(np.asarray(kpts, dtype=np.float64), (-1, 3))
    nk = len(kpts)
    with timer("aoR_k"):
        aoR_k = eval_ao_kpts(cell, kpts, device=device)
    if ae:
        from pyscf_isdf_tpu_torch.df.aegdf import ae_hcore_kpts

        with timer("S/T"):
            S, hcore = ae_hcore_kpts(cell, kpts, ae_omega, device=device)
    else:
        S_k, h_k = [], []
        for ik, k in enumerate(kpts):
            with timer("S/T"):
                S, T = overlap_and_kinetic(cell, kpt=k, device=device)
            with timer("pp"):
                if cell.pseudos:
                    vloc, _ = pp_ops.get_vpploc(cell, aoR_k[ik])
                    vpp = vloc + pp_ops.get_vppnl(cell, kpt=k, device=device)
                else:
                    vpp = pp_ops.get_nuc(cell, aoR_k[ik])
            S_k.append(S.to(torch.complex128))
            h_k.append(T.to(torch.complex128) + vpp)
        S, hcore = torch.stack(S_k), torch.stack(h_k)
    with timer("coulomb"):
        coulG = coulomb.get_coulG(cell)
        coulG_pairs, expmikr = fftdf_k.make_k_kernels(cell, kpts)
        mad = coulomb.madelung(cell, kpts)
        e_nuc = coulomb.ewald(cell)
    f64 = dict(dtype=torch.float64, device=device)
    return KSCFSystem(
        cell=cell, kpts=kpts, S=S, hcore=hcore,
        X=orthogonalizers(S), aoR_k=aoR_k,
        coulG=torch.as_tensor(coulG, **f64),
        coulG_pairs=torch.as_tensor(coulG_pairs, **f64),
        expmikr=torch.as_tensor(expmikr, dtype=torch.complex128, device=device),
        madelung=mad, e_nuc=e_nuc, mesh=tuple(cell.mesh),
        weight=cell.grid_weight, nelec_tot=cell.nelectron * nk,
        ae=ae, ae_omega=ae_omega,
    )


def _vxc_k(aoR_k, ao_grad_k, dm, weight, xcspec):
    """k-averaged XC quadrature: (e_xc as a device scalar, vxc_k (nk, nao,
    nao) complex).

    The density is the k-average rho = (1/nk) sum_k Re tr(D_k ao ao^*),
    clamped at 1e-30; GGA and meta-GGA rungs add the AO gradients
    ``ao_grad_k`` (nk, 3, ng, nao), meta-GGAs the kinetic-energy density
    tau = (1/2nk) sum_k Re tr(D_k grad ao^* . grad ao) and its potential
    term 1/2 w grad ao^H (vtau grad ao). ``weight`` is the uniform grid's
    scalar or a per-point (ng,) tensor (Becke grids).
    """
    nk = aoR_k.shape[0]
    per_point = torch.is_tensor(weight)

    def wsum(x):
        return torch.sum(weight * x) if per_point else weight * torch.sum(x)

    t = aoR_k @ dm                                           # (nk, ng, nao)
    rho = torch.clamp((t * aoR_k.conj()).sum((0, 2)).real / nk, min=1e-30)
    ao_h = aoR_k.conj().transpose(1, 2)
    if xcspec.family not in ("gga", "mgga"):
        exc, vrho, _ = xcspec.exc_vxc(rho)
        if per_point:
            return wsum(rho * exc), (ao_h * (weight * vrho)) @ aoR_k
        return wsum(rho * exc), weight * ((ao_h * vrho) @ aoR_k)
    # grad rho = (2/nk) Re sum_k conj(t) . grad(ao)
    grho = 2.0 / nk * torch.einsum("kgj,kxgj->xg", t.conj(), ao_grad_k).real
    sigma = torch.clamp((grho * grho).sum(0), min=1e-30)
    vtau = None
    if xcspec.family == "mgga":
        tau = torch.clamp(0.5 / nk * ((ao_grad_k @ dm[:, None])
                                      * ao_grad_k.conj()).sum((0, 1, 3)).real,
                          min=1e-30)
        exc, vrho, vsigma, vtau = xcspec.exc_vxc_mgga(rho, sigma, tau)
    else:
        exc, vrho, vsigma = xcspec.exc_vxc(rho, sigma)
    # V_k = w [conj(ao)^T (vrho/2 ao + 2 vsigma grad_rho.grad_ao) + h.c.]
    aow = 0.5 * vrho[:, None] * aoR_k + 2.0 * torch.einsum(
        "xg,kxgi->kgi", (grho * vsigma).to(aoR_k.dtype), ao_grad_k)
    half = ao_h @ (weight[:, None] * aow) if per_point else weight * (ao_h @ aow)
    vxc = half + half.conj().transpose(1, 2)
    if vtau is not None:
        nk, _, ng, nao = ao_grad_k.shape
        g = ao_grad_k.reshape(nk, 3 * ng, nao)
        if per_point:
            gw = (ao_grad_k * (weight * vtau)[:, None]).reshape(nk, 3 * ng, nao)
            vxc = vxc + 0.5 * (gw.conj().transpose(1, 2) @ g)
        else:
            gw = (ao_grad_k * vtau[:, None]).reshape(nk, 3 * ng, nao)
            vxc = vxc + 0.5 * weight * (gw.conj().transpose(1, 2) @ g)
    return wsum(rho * exc), vxc


def vxc_kpts(aoR_k, ao_grad_k, dm, weight, xcspec):
    """k-averaged XC quadrature: (e_xc, vxc_k (nk, nao, nao) complex), the
    energy as a Python float (see :func:`_vxc_k`)."""
    e_xc, vxc = _vxc_k(aoR_k, ao_grad_k, dm, weight, xcspec)
    return float(e_xc), vxc


def bloch_ao_gradients(system: KSCFSystem) -> torch.Tensor:
    """Spectral gradients of the Bloch AOs, (nk, 3, ng, nao)."""
    f64 = dict(dtype=torch.float64, device=system.aoR_k.device)
    coords = torch.as_tensor(system.cell.uniform_grid(), **f64)
    Gv = torch.as_tensor(system.cell.get_Gv(), **f64)
    kt = torch.as_tensor(system.kpts, **f64)
    return torch.stack([ao_gradient_fft_k(system.aoR_k[k], system.mesh, Gv, kt[k],
                                          coords)
                        for k in range(len(system.kpts))])


def exchange_engines_k(system: KSCFSystem, df, isdf_c, omega=None, k1_idx=None,
                       exxdiv=None):
    """Exchange functions ``dm_k -> K_k`` of one k-point engine: the
    full-range one and, with ``omega``, the long-range one.

    'isdf' builds the shared-xi factorization (one per kernel, each with
    its own IP selection), 'isdf_q' the q-resolved one with robust-fit
    exchange, 'fftdf' uses the exact pair-density FFT build on the
    system's kernels (and, with ``omega``, on the long-range ones).
    ``exxdiv`` 'vcut_sph' or 'vcut_ws' truncates the full-range kernels
    ('ewald' and None leave them plain: the loop adds the probe-charge
    shift). ``k1_idx`` (the IBZ driver's band k-points, 'isdf' and
    'fftdf') returns K at those k-points alone.
    """
    cell, aoR_k, kpts = system.cell, system.aoR_k, system.kpts
    ex = exxdiv if exxdiv not in (None, "ewald") else None
    omegas = [None] if omega is None else [None, omega]
    if df == "isdf_q":
        from pyscf_isdf_tpu_torch.df import isdf_q as isdf_q_mod

        facs = [isdf_q_mod.build_isdf_q(cell, aoR_k, kpts, c=isdf_c, keep_x=True,
                                        exxdiv=None if w else ex, omega=w or 0.0)
                for w in omegas]
        return [lambda dm, f=f: isdf_q_mod.get_k_kpts_robust(f, dm, aoR_k,
                                                             system.weight)
                for f in facs]
    if df == "isdf":
        from pyscf_isdf_tpu_torch.df import isdf_k as isdf_k_mod

        facs = [isdf_k_mod.build_isdf_k(cell, aoR_k, kpts, c=isdf_c,
                                        exxdiv=None if w else ex, omega=w or 0.0)
                for w in omegas]
        return [lambda dm, f=f: isdf_k_mod.get_k_kpts(f, dm, k1_idx=k1_idx)
                for f in facs]
    kw = dict(dtype=torch.float64, device=aoR_k.device)
    kernels = [system.coulG_pairs if ex is None else torch.as_tensor(
        fftdf_k.make_k_kernels(cell, kpts, exxdiv=ex)[0], **kw)]
    if omega is not None:
        kernels.append(torch.as_tensor(
            fftdf_k.make_k_kernels(cell, kpts, omega=omega)[0], **kw))
    kweight = system.weight / len(kpts)
    return [lambda dm, cp=cp: fftdf_k.get_k_kpts(aoR_k, dm, cp, system.expmikr,
                                                 system.mesh, kweight, k1_idx=k1_idx)
            for cp in kernels]


def fitted_jk_k(system: KSCFSystem, df, hyb, alpha, omega, timer=None):
    """``get_jk(dm_k, with_k, C_w_k=None)`` of the fitted k-point engines:
    'gdf' (a second fit in the long-range metric for a range-separated
    hybrid) or 'aegdf' (a system built with ``ae=True``; no range
    separation)."""
    from pyscf_isdf_tpu_torch.df import gdf as gdf_mod

    timer = timer or null_timer
    cell, kpts, aoR_k = system.cell, system.kpts, system.aoR_k
    rsh = omega != 0.0
    if df == "aegdf":
        from pyscf_isdf_tpu_torch.df.aegdf import build_ae_gdf_kpts

        if not system.ae:
            raise ValueError("df='aegdf' needs build_kscf_system(ae=True) "
                             "(analytic S/hcore)")
        if rsh:
            raise NotImplementedError("aegdf with range-separated exchange")
        fits = [build_ae_gdf_kpts(cell, kpts, omega=system.ae_omega,
                                  device=aoR_k.device)]
    else:
        fits = [gdf_mod.build_gdf_kpts(cell, aoR_k, kpts, system.mesh,
                                       system.weight, timer=timer)]
        if rsh:
            fits.append(gdf_mod.build_gdf_kpts(cell, aoR_k, kpts, system.mesh,
                                               system.weight, omega=omega))

    def get_jk(dm, with_k, C_w_k=None):
        with timer("JK"):
            vj, vk = gdf_mod.get_jk_kpts(fits[0], dm)
            if not with_k:
                return vj, None
            if rsh:
                vk = hyb * vk + (alpha - hyb) * gdf_mod.get_jk_kpts(fits[1], dm)[1]
            return vj, vk

    return get_jk


def _eig_all(F, X):
    """Per-k generalized eigensolve through the orthogonalizers: batched
    when every k keeps the same rank, else one k at a time."""
    if len({x.shape[1] for x in X}) == 1:
        Xs = torch.stack(X)
        e, u = torch.linalg.eigh(Xs.conj().transpose(1, 2) @ F @ Xs)
        return list(e), list(Xs @ u)
    es, cs = [], []
    for k, x in enumerate(X):
        e, u = torch.linalg.eigh(x.conj().T @ F[k] @ x)
        es.append(e)
        cs.append(x @ u)
    return es, cs


def _trace(a, b) -> float:
    """Re sum_k tr(a_k b_k)."""
    return float(torch.einsum("kij,kji->", a, b).real)


def _weighted_occ(mo_e_k, weights, nelec_tot):
    """Fermi filling across weighted IBZ k-points (2 electrons/orbital).

    Exact-count fill in sorted order (a <=fermi threshold overfills on
    a degenerate Fermi level — same guard as occupations.
    exact_count_occ; argsort tie-breaking is deterministic)."""
    e_all = np.hstack(mo_e_k)
    w_all = np.hstack([np.full(len(e), w) for e, w in zip(mo_e_k, weights)])
    order = np.argsort(e_all, kind="stable")
    cum = np.cumsum(2 * w_all[order])
    nfill = int(np.searchsorted(cum, nelec_tot - 1e-9)) + 1
    if abs(cum[nfill - 1] - nelec_tot) > 1e-9:
        # the last orbital's IBZ weight overshoots the remaining electron
        # count: a metal/fractional filling this integer-fill driver cannot
        # represent
        raise ValueError(
            f"IBZ integer filling impossible: cumulative weighted "
            f"occupancy jumps {cum[nfill - 2] if nfill > 1 else 0.0} -> "
            f"{cum[nfill - 1]} across nelec_tot={nelec_tot}; use the "
            f"full-BZ driver or smearing")
    mask = np.zeros(e_all.size)
    mask[order[:nfill]] = 2.0
    out, off = [], 0
    for e in mo_e_k:
        out.append(mask[off:off + len(e)])
        off += len(e)
    return out


def kscf_kernel(
    system: KSCFSystem,
    xc: Optional[str] = None,
    exxdiv: str = "ewald",
    max_cycle: int = 60,
    conv_tol: float = 1e-10,
    diis_space: int = 8,
    df: str = "fftdf",
    isdf_c: float = 8.0,
    isdf_precision: Optional[str] = None,
    verbose: bool = False,
    sigma: float = 0.0,
    smearing_method: str = "fermi",
    hubbard=None,
    xc_grids: str = "uniform",
    device=None,
    timer=None,
    ibz: Optional[symm.IBZInfo] = None,
    get_jk=None,
):
    """Run the k-point SCF to convergence on ``device`` (default: the GPU),
    where ``system`` must have been built. xc=None -> KRHF, else KRKS ('hf'
    is KRHF too).

    ``df='isdf'`` builds the shared-xi k-point ISDF factorization and routes
    exchange through :func:`pyscf_isdf_tpu_torch.df.isdf_k.get_k_kpts`;
    ``df='isdf_q'`` builds the q-resolved factorization and uses its
    robust-fit exchange (:mod:`pyscf_isdf_tpu_torch.df.isdf_q`). J stays on
    the exact FFT path either way. A range-separated hybrid builds the
    engine's full-range and long-range exchange, combined as
    hyb K_full + (alpha - hyb) K_LR, each with its own probe-charge
    Madelung shift.

    ``sigma > 0`` (Ha) gives finite-temperature occupations over the
    k-stacked spectrum
    (:func:`~pyscf_isdf_tpu_torch.scf.occupations.smearing_occ_rhf`,
    ``smearing_method`` 'fermi' or Gaussian).

    ``timer`` (a :class:`~pyscf_isdf_tpu_torch.utils.timing.StageTimer`)
    records each iteration as 'cycle'.

    ``ibz`` (an :class:`~pyscf_isdf_tpu_torch.symm.IBZInfo` of
    ``system.kpts``) carries the iteration state at its irreducible
    k-points with their integer weights: the density is expanded to the
    full zone once a cycle for J, Vxc and the exchange sum, whose band
    loop runs over the irreducible k-points alone ('fftdf' and 'isdf';
    see :func:`~pyscf_isdf_tpu_torch.scf.khf_ksymm.kscf_ibz_kernel`).

    ``df='gdf'`` fits J and K in the Coulomb metric of the grid
    (:func:`~pyscf_isdf_tpu_torch.df.gdf.build_gdf_kpts`; a second fit in
    the long-range metric for a range-separated hybrid), ``df='aegdf'``
    takes them from the analytic all-electron fit of a system built with
    ``ae=True`` (:func:`~pyscf_isdf_tpu_torch.df.aegdf.build_ae_gdf_kpts`).
    ``get_jk`` (optional) overrides the engine: ``(dm_k, with_k) ->
    (vj_k, vk_k)``. ``exxdiv`` 'vcut_sph' or 'vcut_ws' truncates the
    exchange kernels of 'fftdf', 'isdf' and 'isdf_q'. ``xc_grids``
    'becke[:n_rad,n_theta]' takes the XC quadrature on the Becke atomic
    grid (:func:`~pyscf_isdf_tpu_torch.ops.becke.becke_xc_inputs`, Bloch AOs
    per k-point).

    ``hubbard`` turns on DFT+U (reference pyscf/pbc/dft/krkspu.py): a list
    of (atom index or element symbol, l, U in Hartree) subspaces, whose
    E_U joins the energy and V_U the Fock matrix
    (:class:`~pyscf_isdf_tpu_torch.scf.dftu.HubbardU`); it does not combine
    with ``ibz`` (``ValueError``).

    ``isdf_precision='dd'`` is not ported (float64 replaces it) and raises
    ``NotImplementedError``.

    Returns a dict with e_tot, mo_energy, mo_coeff (per-k tensor lists),
    mo_occ (per-k numpy arrays), dm (nk, nao, nao), converged, niter,
    entropy, mu and e_free = e_tot - sigma * entropy (0, None and e_tot
    without smearing). With ``ibz`` the per-k entries are at its
    irreducible k-points, and dm_full (nk, nao, nao) and ibz are added.
    """
    if isdf_precision is not None:
        raise NotImplementedError(f"isdf_precision={isdf_precision!r}: the "
                                  "port solves in float64")
    becke_mod.parse_xc_grids(xc_grids)
    if get_jk is None and df not in ("fftdf", "isdf", "isdf_q", "gdf", "aegdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'fftdf', 'isdf', "
                         "'isdf_q', 'gdf' or 'aegdf'")
    if hubbard and ibz is not None:
        raise ValueError("hubbard with ibz: the IBZ SCF takes no DFT+U")
    if ibz is not None and (df not in ("fftdf", "isdf") or get_jk is not None):
        raise ValueError(f"df={df!r}: the IBZ SCF needs the band subset of "
                         "'fftdf' or 'isdf'")
    device = require_device(system.aoR_k, device)
    timer = timer or null_timer
    cell = system.cell
    nk = len(system.kpts)
    xcspec = XCSpec(xc) if xc is not None else None
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    is_dft = xcspec is not None and xcspec.family != "hf"
    k_scale = 1.0 if rsh else hyb
    mad_add = system.madelung
    if rsh:
        mad_add = hyb * system.madelung \
            + (alpha - hyb) * coulomb.madelung_omega(cell, system.kpts, omega)

    aoR_k = system.aoR_k
    mesh = system.mesh
    weight = system.weight
    nocc_tot = system.nelec_tot // 2

    need_grad = is_dft and xcspec.family in ("gga", "mgga")
    becke = becke_mod.becke_xc_inputs(cell, xc_grids, need_grad, kpts=system.kpts,
                                      device=device, timer=timer) \
        if is_dft else None
    if becke is None:
        xc_ao, xc_w = aoR_k, weight
        xc_grad = bloch_ao_gradients(system) if need_grad else None
    else:
        xc_ao, xc_grad, xc_w, _ = becke
    # the IBZ reduction as data: the band rows the state lives on, their
    # weights and the expansion to the full zone (identity without ibz)
    if ibz is None:
        band_idx, w_band = None, None

        def expand(dm):
            return dm

        def at_bands(a):
            return a
    else:
        band_idx = [int(i) for i in ibz.ibz_idx]
        band_t = torch.as_tensor(band_idx, device=device)
        w_host = np.asarray(ibz.weights, dtype=np.float64)
        w_band = torch.as_tensor(w_host, dtype=torch.float64, device=device)
        P = symm._rotation_table(cell, ibz, device)

        def expand(dm):
            return symm.expand_dm(cell, ibz, dm, P=P)

        def at_bands(a):
            return a[band_t]

    def trace(a, b) -> float:
        """The weighted, 1/nk-normalised Re sum_k tr(a_k b_k)."""
        if w_band is None:
            return _trace(a, b) / nk
        return float(torch.einsum("k,kij,kji->", w_band.to(a.dtype), a, b).real) / nk

    internal_jk = get_jk is None
    if get_jk is None and df in ("gdf", "aegdf"):
        get_jk = fitted_jk_k(system, df, hyb, alpha, omega, timer)
    if get_jk is None:
        get_k_fn = None
        if need_k:
            fns = exchange_engines_k(system, df, isdf_c, omega if rsh else None,
                                     k1_idx=band_idx, exxdiv=exxdiv)
            if rsh:
                def get_k_fn(dm):
                    return hyb * fns[0](dm) + (alpha - hyb) * fns[1](dm)
            else:
                get_k_fn = fns[0]
        occ_k_capable = (df == "fftdf" and not rsh and ibz is None
                         and exxdiv in (None, "ewald"))

        def get_jk(dm, with_k, C_w_k=None):
            vj = at_bands(fftdf_k.get_j_kpts(aoR_k, dm, system.coulG, mesh, weight))
            if not with_k:
                return vj, None
            if C_w_k is not None and occ_k_capable:
                # occupied-MO fast exchange (reference tagged-DM path,
                # fft_jk.py:235-259): nao*nocc FFTs per (k1,k2) block
                vk = fftdf_k.get_k_kpts_occ(aoR_k, aoR_k @ C_w_k,
                                            system.coulG_pairs, system.expmikr,
                                            mesh, weight / nk)
            else:
                vk = get_k_fn(dm)
            return vj, vk

    S, hcore = at_bands(system.S), at_bands(system.hcore)
    X = system.X if ibz is None else tuple(system.X[k] for k in band_idx)
    hub = HubbardU(cell, S, hubbard) if hubbard else None

    smeared = sigma > 0
    entropy, mu = 0.0, None

    def occupations(mo_e):
        nonlocal entropy, mu
        flat = torch.cat(mo_e).cpu().numpy()
        e_host = np.split(flat, np.cumsum([len(e) for e in mo_e])[:-1])
        if smeared:
            if ibz is None:
                occs, entropy, mu = smearing_occ_rhf(e_host, system.nelec_tot, sigma,
                                                     smearing_method)
            else:
                occs, entropy, mu = smearing_occ_ibz(e_host, w_host, system.nelec_tot,
                                                     sigma, smearing_method)
            return occs
        if ibz is None:
            return exact_count_occ(e_host, nocc_tot, scale=2.0)
        return _weighted_occ(e_host, w_host, system.nelec_tot)

    def make_dm(mo_c, occs):
        return torch.stack([
            (c * torch.as_tensor(o, dtype=c.dtype, device=device)) @ c.conj().T
            for c, o in zip(mo_c, occs)])

    mo_e, mo_c = _eig_all(hcore, X)
    occs = occupations(mo_e)
    dm = make_dm(mo_c, occs)

    diis = DIIS(space=diis_space)
    e_last = 0.0
    conv = False
    C_w_k = None
    for it in range(max_cycle):
        with timer("cycle"):
            dm_full = expand(dm)
            if internal_jk:
                vj, vk = get_jk(dm_full, need_k, C_w_k)
            else:
                vj, vk = get_jk(dm_full, need_k)
            vj = torch.as_tensor(vj, device=device).to(torch.complex128)
            if need_k:
                vk = torch.as_tensor(vk, device=device).to(torch.complex128)
            veff = vj.clone()
            e_xc = 0.0
            if is_dft:
                e_xc, vxc = vxc_kpts(xc_ao, xc_grad, dm_full, xc_w, xcspec)
                veff = veff + at_bands(vxc)
            e_k = 0.0
            if need_k:
                if exxdiv == "ewald":
                    vk = vk + mad_add * (S @ dm @ S)
                veff = veff - 0.5 * k_scale * vk
                e_k = -0.25 * k_scale * trace(dm, vk)
            e_u = 0.0
            if hub is not None:
                e_u, v_u = hub.energy_and_potential(dm)
                veff = veff + v_u

            F = hcore + veff
            sds = S @ dm @ F - F @ dm @ S
            err = torch.cat([(x.conj().T @ sds[k] @ x).reshape(-1)
                             for k, x in enumerate(X)])
            F = diis.update(F, err)

            mo_e, mo_c = _eig_all(F, X)
            occs = occupations(mo_e)
            dm_new = make_dm(mo_c, occs)
            # occupied-MO exchange next cycle: only for a uniform integer fill
            counts = [int(np.sum(o > 0)) for o in occs]
            C_w_k = None
            if not smeared and len(set(counts)) == 1 and counts[0] > 0:
                no = counts[0]
                C_w_k = torch.stack([
                    c[:, :no] * torch.as_tensor(np.sqrt(o[:no]), dtype=c.dtype,
                                                device=device)
                    for c, o in zip(mo_c, occs)])

            e1 = trace(dm, hcore)
            ecoul = 0.5 * trace(dm, vj)
            e_tot = float(e1 + ecoul + e_xc + e_k + e_u + system.e_nuc)
            de = abs(e_tot - e_last)
            err_norm = float(torch.linalg.norm(err)) / max(1, err.numel()) ** 0.5
            if verbose:
                print(f"cycle {it:3d}  E = {e_tot:.12f}  dE = {de:.2e}  |err| = {err_norm:.2e}")
            if de < conv_tol and err_norm < np.sqrt(conv_tol):
                conv = True
                dm = dm_new
                break
            dm = dm_new
            e_last = e_tot

    out = {
        "e_tot": e_tot,
        "mo_energy": mo_e,
        "mo_coeff": mo_c,
        "mo_occ": occs,
        "dm": dm,
        "converged": conv,
        "niter": it + 1,
        "entropy": entropy,
        "mu": mu,
        "e_free": e_tot - sigma * entropy if smeared else e_tot,
    }
    if ibz is not None:
        out.update(dm_full=expand(dm), ibz=ibz)
    return out

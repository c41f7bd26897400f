"""Spin-unrestricted G0W0-AC and RPA (Gamma and k-point), torch.

Reference contract: pyscf/gw/ugw_ac.py and pyscf/pbc/gw/kugw_ac.py, as
the JAX package carries them over (``pyscf_isdf_tpu/gw/ugw.py``). The
density response sums both spin channels with unit occupancy,
Pi = 2 (Pi_a + Pi_b) (ugw_ac.py:172-187); each spin's self-energy uses its
own W-side tensors and Green's-function poles, the screening W is shared.

Same frequency layout as gw/rgw.py: the two spins' occupied-virtual
factors stack into one (naux, nov_a + nov_b) array, so each frequency's
polarizability is one GEMM, and each chunk's Cholesky factors of 1 - Pi
serve both spins' triangular solves. Fock conventions follow scf/uhf.py:
vx_s = -(vk_s + madelung S dm_s S), so GW@UHF cancels the exchange.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device, to_host
from pyscf_isdf_tpu_torch.df import fftdf, fftdf_k
from pyscf_isdf_tpu_torch.gw.rgw import (
    _g0, _host, _mo_diag, _on, _one_minus, _pade_fit_points, _polarizability,
    _rpa_integrand, _solve_qp_ac, _w_chol, _xcspec, build_lmo, freq_chunk,
    scaled_legendre, sigma_grid)
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.scf.uhf import _spin_vxc

C128 = torch.complex128


@dataclass
class UGWResult:
    qp_energy: tuple          # (qp_a (nmo,), qp_b (nmo,))
    mo_energy: tuple
    sigma_x: tuple
    v_mf: tuple
    converged: bool
    nocc: tuple
    sigma_iw: tuple | None = None         # per spin: Sigma_c(iw') of orbs (AC)
    omega_grid: np.ndarray | None = None  # (nw_sigma,) its w' grid


def _nelec(system, nelec, nk=1):
    """(nocc_a, nocc_b) per cell from the cell's spin when not given."""
    if nelec is not None:
        return tuple(nelec)
    ne = getattr(system, "nelec_tot", None) or system.nelec
    na = (ne + system.cell.spin * nk) // 2
    return na // nk, (ne - na) // nk


def _fermi(e_s, nocc_s, what):
    """ef between the highest occupied and lowest virtual level of either
    spin; raises for a gapless reference."""
    homo = max(e[..., n - 1].max() for e, n in zip(e_s, nocc_s) if n > 0)
    lumo = min(e[..., n].min() for e, n in zip(e_s, nocc_s))
    if lumo - homo < 1e-3:
        raise ValueError(f"{what} does not support metallic references")
    return 0.5 * (homo + lumo)


def _spin_ov(Ls, es, noccs):
    """The two spins' stacked (naux, nov_a + nov_b) factors and e_ia."""
    naux = Ls[0].shape[0]
    Lov = torch.cat([L[:, :n, n:].reshape(naux, -1) for L, n in zip(Ls, noccs)], 1)
    eia = torch.cat([(e[:n, None] - e[None, n:]).reshape(-1) for e, n in zip(es, noccs)])
    return Lov, eia


def _usigma_iw(La, Lb, ea, eb, nocc_a, nocc_b, freqs, wts, omega_grid, ef,
               orbs=None):
    """Both spins' diagonal Sigma_c(i w') of the orbitals ``orbs`` (default
    all), over frequency chunks. Returns (sigma_a, sigma_b), each
    (norb, nw_sigma) complex128 on the device of ``La``."""
    dev = La.device
    naux, nmo, _ = La.shape
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)
    es = (_on(ea, dev), _on(eb, dev))
    noccs = (nocc_a, nocc_b)
    Lov, eia = _spin_ov((La, Lb), es, noccs)
    ocols = torch.as_tensor(orbs, device=dev)
    Lw = torch.stack([L[:, :, ocols].reshape(naux, -1) for L in (La, Lb)])
    ft, wt, og = _on(freqs, dev), _on(wts, dev), _on(omega_grid, dev)
    sig = [torch.zeros((len(orbs), og.shape[0]), dtype=C128, device=dev)
           for _ in range(2)]
    nc = freq_chunk(len(freqs), naux, 2 * Lw.shape[2])
    for w0 in range(0, len(freqs), nc):
        fw = ft[w0:w0 + nc]
        R = torch.linalg.cholesky(_one_minus(_polarizability(Lov, eia, -fw ** 2, 2.0)))
        W = _w_chol(R, Lw).reshape(R.shape[0], 2, nmo, len(orbs)).to(C128)
        wc = wt[w0:w0 + nc].to(C128)
        for s in range(2):
            occ = torch.as_tensor(orbs < noccs[s], device=dev)[:, None]
            s_o = torch.einsum("w,wmn,wmu->nu", wc, W[:, s], _g0(es[s], fw, og, ef, -1.0))
            s_v = torch.einsum("w,wmn,wmu->nu", wc, W[:, s], _g0(es[s], fw, og, ef, 1.0))
            sig[s] -= torch.where(occ, s_o, s_v) / np.pi
    return sig[0], sig[1]


def _umf_potentials(system, res, xc: Optional[str]):
    """Per spin, the diagonal MO elements of the exchange vx_s and of
    v_mf (host float64)."""
    from pyscf_isdf_tpu_torch.ops import coulomb

    aoR = system.aoR
    dev = aoR.device
    mesh, weight = system.mesh, system.weight
    dm = [_on(d, dev) for d in res["dm"]]
    C = [_on(c, dev) for c in res["mo_coeff"]]
    S = system.S
    spec = _xcspec(xc)
    vxc_ab = None
    if spec is not None:
        ao_grad = (ao_gradient_fft(aoR, mesh, system.Gv)
                   if spec.family in ("gga", "mgga") else None)
        _, vxc_a, vxc_b = _spin_vxc(aoR, ao_grad, dm[0], dm[1], weight, spec)
        vxc_ab = (vxc_a, vxc_b)
    coulG_lr = None
    if spec is not None and spec.omega != 0.0:
        coulG_lr = torch.as_tensor(coulomb.get_coulG(
            system.cell, exxdiv=None, omega=spec.omega), dtype=aoR.dtype, device=dev)
        mad_lr = coulomb.madelung_omega(system.cell, None, spec.omega)
    vx, v_mf = [], []
    for s in range(2):
        SdS = S @ dm[s] @ S
        vk = fftdf.get_k(aoR, dm[s], system.coulG, mesh, weight)
        vx_ao = -(vk + system.madelung * SdS)
        if spec is None:
            v_ao = vx_ao
        else:
            v_ao = vxc_ab[s] + spec.hyb * vx_ao
            if coulG_lr is not None:
                # RSH (scf/uhf.py semantics): hyb K_full + (alpha - hyb)
                # K_LR(omega), each with its own Madelung constant
                vk_lr = fftdf.get_k(aoR, dm[s], coulG_lr, mesh, weight)
                v_ao = v_ao + (spec.alpha - spec.hyb) * -(vk_lr + mad_lr * SdS)
        vx.append(_mo_diag(C[s], vx_ao))
        v_mf.append(_mo_diag(C[s], v_ao))
    return vx, v_mf


def _spin_lmo(system, res, g=None):
    """Both spins' Lmo on one AO-basis GDF fit."""
    from pyscf_isdf_tpu_torch.df import gdf as gdf_mod

    if g is None:
        g = gdf_mod.build_gdf(system.cell, system.aoR, system.coulG, system.mesh,
                              system.weight)
    return [build_lmo(system, res["mo_coeff"][s], g=g) for s in range(2)]


def _solve_spin(sig, es, noccs, orbs, omega_grid, ef, vx, v_mf, idx=()):
    """Pade fits and QP solves of both spins: (qp_a, qp_b), converged.
    ``idx`` picks the k-point row of a k-resolved result."""
    fit = _pade_fit_points(len(omega_grid))
    qp = tuple(e.copy() for e in es)
    conv = True
    for s in range(2):
        for io, p in enumerate(orbs):
            qp[s][idx + (p,)], _, ok = _solve_qp_ac(
                sig[s][io], omega_grid, fit, ef, es[s][idx + (p,)], p < noccs[s],
                vx[s][idx + (p,)], v_mf[s][idx + (p,)], False)
            conv = conv and ok
    return qp, conv


def ugw_ac_gamma(system, res, xc: Optional[str] = None, nw: int = 100,
                 orbs=None, nelec: Optional[tuple] = None,
                 device=None) -> UGWResult:
    """Spin-unrestricted G0W0-AC on a converged uhf_kernel result."""
    require_device(system.aoR, device)
    es = tuple(_host(e).astype(np.float64) for e in res["mo_energy"])
    nmo = es[0].shape[0]
    noccs = _nelec(system, nelec)
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)
    ef = _fermi(es, noccs, "GW-AC")
    La, Lb = _spin_lmo(system, res)

    freqs, wts = scaled_legendre(nw)
    omega_grid = sigma_grid(freqs)
    sig = _usigma_iw(La, Lb, es[0], es[1], noccs[0], noccs[1], freqs, wts,
                     omega_grid, ef, orbs=orbs)
    vx, v_mf = _umf_potentials(system, res, xc)
    sig = [to_host(s) for s in sig]
    qp, conv = _solve_spin(sig, es, noccs, orbs, omega_grid, ef, vx, v_mf)
    return UGWResult(qp_energy=qp, mo_energy=es, sigma_x=tuple(vx),
                     v_mf=tuple(v_mf), converged=conv, nocc=noccs,
                     sigma_iw=tuple(sig), omega_grid=omega_grid)


# ------------------------------------------------------------------
# k-point spin-unrestricted GW (reference pbc/gw/kugw_ac.py)

def _kmf_spin(system, res, xc):
    """Per spin, (nk, nmo) diagonal MO elements of vx_s and v_mf at k."""
    from pyscf_isdf_tpu_torch.gw.krgw import _exchange_kpts
    from pyscf_isdf_tpu_torch.ops import coulomb
    from pyscf_isdf_tpu_torch.scf.khf import bloch_ao_gradients
    from pyscf_isdf_tpu_torch.scf.kuhf import vxc_spin_kpts

    dev = system.aoR_k.device
    dm = [_on(d, dev, C128) for d in res["dm"]]
    C = [_on(c, dev, C128) for c in res["mo_coeff"]]
    spec = _xcspec(xc)
    vxc_s = cpl = None
    if spec is not None:
        ao_grad_k = (bloch_ao_gradients(system)
                     if spec.family in ("gga", "mgga") else None)
        _, vxc_a, vxc_b = vxc_spin_kpts(system.aoR_k, ao_grad_k, dm[0], dm[1],
                                        system.weight, spec)
        vxc_s = (vxc_a, vxc_b)
        if spec.omega != 0.0:
            cpl, _ = fftdf_k.make_k_kernels(system.cell, system.kpts, omega=spec.omega)
            cpl = torch.as_tensor(cpl, device=dev)
            mad_lr = coulomb.madelung_omega(system.cell, system.kpts, spec.omega)
    vx_mo, v_mf_mo = [], []
    for s in range(2):
        vx_ao = _exchange_kpts(system, dm[s], system.coulG_pairs, system.madelung)
        if spec is None:
            v_ao = vx_ao
        else:
            v_ao = vxc_s[s] + spec.hyb * vx_ao
            if cpl is not None:
                v_ao = v_ao + (spec.alpha - spec.hyb) * _exchange_kpts(
                    system, dm[s], cpl, mad_lr)

        def diag(V, c=C[s]):
            return to_host(torch.einsum("kip,kij,kjp->kp", c.conj(), V, c).real)
        vx_mo.append(diag(vx_ao))
        v_mf_mo.append(diag(v_ao))
    return vx_mo, v_mf_mo


def _kspin_setup(system, res, nelec):
    from pyscf_isdf_tpu_torch.df import gdf as gdf_mod
    from pyscf_isdf_tpu_torch.gw.krgw import build_lmo_kpts

    e_s = [_host(e).astype(np.float64) for e in res["mo_energy"]]
    nk = e_s[0].shape[0]
    noccs = _nelec(system, nelec, nk)
    kg = gdf_mod.build_gdf_kpts(system.cell, system.aoR_k, system.kpts,
                                system.mesh, system.weight)
    Lmo_s = [build_lmo_kpts(system, res["mo_coeff"][s], kg=kg) for s in range(2)]
    return e_s, nk, noccs, Lmo_s


def _kspin_transfer(Lmo_s, e_s, noccs, ktab, kL, dev):
    """Both spins' stacked occupied-virtual factors of one momentum
    transfer, (naux, sum_s nk nov_s), and their e_ia."""
    from pyscf_isdf_tpu_torch.gw.krgw import _flat_ov, _transfer

    Lovs, eias = [], []
    for s in range(2):
        if noccs[s] == 0:
            continue
        _, L_stack, _, e_i, e_a = _transfer(Lmo_s[s], e_s[s], ktab, kL, noccs[s],
                                            [], dev)
        Lov, eia = _flat_ov(L_stack, e_i, e_a)
        Lovs.append(Lov)
        eias.append(eia)
    return torch.cat(Lovs, 1), torch.cat(eias)


def kugw_ac(system, res, xc=None, nw: int = 100, orbs=None, nelec=None,
            device=None) -> UGWResult:
    """Spin-unrestricted k-point G0W0-AC on a kuhf_kernel result.

    Per momentum transfer the polarizability sums both spin channels with
    unit occupancy, Pi = 2/nk sum_s sum_ki L^s f L^s*; the shared
    screening feeds per-spin W/G contractions (kugw_ac.py structure on the
    krgw engine). Closed-shell limit == restricted kgw_ac."""
    from pyscf_isdf_tpu_torch.gw.krgw import _k_index_table, _kl_contribution

    dev = require_device(system.aoR_k, device)
    e_s, nk, noccs, Lmo_s = _kspin_setup(system, res, nelec)
    nmo = e_s[0].shape[1]
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)
    ef = _fermi(e_s, noccs, "GW-AC")

    freqs, wts = scaled_legendre(nw)
    omega_grid = sigma_grid(freqs)
    ft, wt, og = _on(freqs, dev), _on(wts, dev), _on(omega_grid, dev)
    ktab = _k_index_table(system.kpts, system.cell.a)
    ocols = torch.as_tensor(orbs, device=dev)
    sigma = [torch.zeros((nk, len(orbs), len(omega_grid)), dtype=C128, device=dev)
             for _ in range(2)]
    for kL in range(nk):
        kidx = ktab[:, kL]
        km_of = np.array([int(np.nonzero(kidx == kn)[0][0]) for kn in range(nk)])
        # each spin channel enters with 2/nk (half the restricted 4/nk)
        Lov, eia = _kspin_transfer(Lmo_s, e_s, noccs, ktab, kL, dev)
        Lw = [torch.stack([Lmo_s[s][km_of[kn]][kn][:, :, ocols] for kn in range(nk)])
              for s in range(2)]
        nc = freq_chunk(nw, Lov.shape[0], 2 * nk * nmo * len(orbs), 16)
        for w0 in range(0, nw, nc):
            R = torch.linalg.cholesky(_one_minus(_polarizability(
                Lov, eia, -ft[w0:w0 + nc] ** 2, 2.0 / nk)))
            for s in range(2):
                sigma[s] += _kl_contribution(
                    R, Lw[s], e_s[s][km_of, :], ft[w0:w0 + nc], wt[w0:w0 + nc], og, ef,
                    noccs[s], nk, orbs)

    vx_mo, v_mf_mo = _kmf_spin(system, res, xc)
    sig_h = [to_host(s) for s in sigma]
    qp = tuple(e.copy() for e in e_s)
    conv = True
    for kn in range(nk):
        q, ok = _solve_spin([s[kn] for s in sig_h], e_s, noccs, orbs, omega_grid, ef,
                            vx_mo, v_mf_mo, idx=(kn,))
        for s in range(2):
            qp[s][kn] = q[s][kn]
        conv = conv and ok
    return UGWResult(qp_energy=qp, mo_energy=tuple(e_s), sigma_x=tuple(vx_mo),
                     v_mf=tuple(v_mf_mo), converged=conv, nocc=noccs,
                     sigma_iw=tuple(sig_h), omega_grid=omega_grid)


# ------------------------------------------------------------------
# spin-polarized direct-RPA correlation energy

def urpa_ecorr_gamma(system, res, nw: int = 100, nelec=None, device=None) -> float:
    """Unrestricted direct-RPA correlation energy (Gamma):
    Pi(iw) = 2 sum_s L_s f_s L_s^T (unit occupancies),
    Ec = 1/(2 pi) int dw tr[ln(1 - Pi) + Pi]."""
    require_device(system.aoR, device)
    es = [_host(e).astype(np.float64) for e in res["mo_energy"]]
    noccs = _nelec(system, nelec)
    La, Lb = _spin_lmo(system, res)
    dev = La.device
    Lov, eia = _spin_ov((La, Lb), [_on(e, dev) for e in es], noccs)
    freqs, wts = scaled_legendre(nw)
    return float(np.sum(wts * _rpa_integrand(Lov, eia, freqs, 2.0)) / (2.0 * np.pi))


def urpa_ecorr_plasmon(res, nelec, La, Lb) -> float:
    """Dense spin-orbital dRPA plasmon-formula oracle: A = diag(d) + K,
    B = K over the stacked (ia, spin) space; Ec = 1/2 (sum_v Omega_v -
    tr A)."""
    dev = La.device
    es = [_on(e, dev) for e in res["mo_energy"]]
    Lov, eia = _spin_ov((La, Lb), es, nelec)
    d = -eia
    K = Lov.T @ Lov
    sd = torch.sqrt(d)
    C = 2.0 * K
    C.diagonal().add_(d)
    C.mul_(sd[:, None]).mul_(sd[None, :])
    omega = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(C), min=0.0))
    return float(0.5 * (omega.sum() - d.sum() - torch.trace(K)))


def kurpa_ecorr(system, res, nw: int = 100, nelec=None, device=None) -> float:
    """k-point spin-unrestricted direct-RPA correlation energy per unit
    cell: the per-q ln-det trace of krgw.rpa_ecorr_kpts with the
    spin-summed polarizability of kugw_ac (Pi_q = 2/nk sum_s sum_ki
    L^s f L^s*)."""
    from pyscf_isdf_tpu_torch.gw.krgw import _k_index_table

    dev = require_device(system.aoR_k, device)
    e_s, nk, noccs, Lmo_s = _kspin_setup(system, res, nelec)
    freqs, wts = scaled_legendre(nw)
    ktab = _k_index_table(system.kpts, system.cell.a)
    total = 0.0
    for kL in range(nk):
        Lov, eia = _kspin_transfer(Lmo_s, e_s, noccs, ktab, kL, dev)
        total += float(np.sum(wts * _rpa_integrand(Lov, eia, freqs, 2.0 / nk)))
    return total / (2.0 * np.pi * nk)

"""Contour-deformation G0W0 (Gamma, spin-polarized and k-point), torch.

Reference contract: pyscf/gw/gw_cd.py and pyscf/pbc/gw/krgw_cd.py (Zhu &
Chan, JCTC 17, 727 (2021)), as the JAX package carries them over
(``pyscf_isdf_tpu/gw/gw_cd.py``). Sigma_c at a real frequency:

    Sigma_c(n, w) = I(n, w) + R(n, w)

    I(n, w) = -(1/pi) sum_m int_0^inf dw' W_mn(iw')
              * (w - e_m) / ((w - e_m)^2 + w'^2)
    R(n, w) = sum_m s_m W_mn(|w - e_m| + i eta),
              s_m = +1 for ef < e_m < w, -1 for w < e_m < ef, else 0.

Only the columns n asked for are built: W(iw') once for the orbitals
``orbs`` (on the imaginary axis 1 - Pi is positive definite, so a chunk's
Cholesky factors and a triangular solve give it), and each residue W at
the real frequencies of the poles crossed, for the one orbital n and the
crossed m alone (a complex LU solve per pole, chunked). The
polarizability at any z is the same contraction with
f_z = e_ia / (e_ia^2 - z^2). Host float64 keeps the scalar QP updates.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device, to_host
from pyscf_isdf_tpu_torch.gw.rgw import (
    GWResult, _host, _mf_potentials, _on, _one_minus, _polarizability, _w_chol, _w_solve,
    build_lmo, freq_chunk, scaled_legendre)

C128 = torch.complex128


def _w_z(Lov, eia, scale, Lw, z2):
    """W(z) = Lw^H ((1 - Pi(z))^-1 - 1) Lw column by column for each z^2
    of ``z2``, Pi(z) = scale (Lov f_z) Lov^H, in chunks: (nz, ncols)
    complex128. On the imaginary axis (z^2 <= 0) through the Cholesky
    factors of 1 - Pi, elsewhere through an LU solve."""
    dev = Lov.device
    z2 = torch.as_tensor(np.asarray(z2), dtype=C128, device=dev)
    imag_axis = bool((z2.imag == 0).all() and (z2.real <= 0).all())
    naux, ncols = Lov.shape[0], Lw.shape[-1]
    out = torch.empty((z2.shape[0], ncols), dtype=C128, device=dev)
    nc = freq_chunk(z2.shape[0], naux, ncols, 16)
    for z0 in range(0, z2.shape[0], nc):
        zc = z2[z0:z0 + nc]
        if imag_axis:
            R = torch.linalg.cholesky(_one_minus(_polarizability(Lov, eia, zc.real,
                                                                 scale)))
            out[z0:z0 + nc] = _w_chol(R, Lw)
        else:
            out[z0:z0 + nc] = _w_solve(_one_minus(_polarizability(Lov, eia, zc, scale)),
                                       Lw)
    return out


def _ov(Lmo, e, nocc):
    naux = Lmo.shape[0]
    return (Lmo[:, :nocc, nocc:].reshape(naux, -1),
            (e[:nocc, None] - e[None, nocc:]).reshape(-1))


def _w_batched_z(Lmo, mo_energy, nocc, z2, cols=None):
    """W_mn(z_j) = sum_PQ L_Pmn [(1 - Pi(z_j))^-1 - 1]_PQ L_Qmn for a batch
    of complex squared frequencies z2[j] = z_j^2 and the columns n in
    ``cols`` (default all): (nz, nmo, ncols) complex128.

    Pi(z) = 4 sum_ia L_Pia L_Qia e_ia / (e_ia^2 - z^2) (closed-shell spin
    factor 4, Gamma point; z = iw' gives the GW-AC kernel)."""
    naux, nmo, _ = Lmo.shape
    cols = np.arange(nmo) if cols is None else np.asarray(cols)
    Lov, eia = _ov(Lmo, _on(mo_energy, Lmo.device), nocc)
    Lw = Lmo[:, :, torch.as_tensor(cols, device=Lmo.device)].reshape(naux, -1)
    return _w_z(Lov, eia, 4.0, Lw, z2).reshape(-1, nmo, len(cols))


def _residue_sel(e, omega, ef):
    """The poles crossed between the Fermi level and ``omega`` and the
    residue sign."""
    if omega >= ef:
        return np.nonzero((e > ef) & (e < omega))[0], 1.0
    return np.nonzero((e < ef) & (e > omega))[0], -1.0


def _imag_integral(Wn, wts, e, omega, eta, freqs):
    dm_ = omega - e                                         # (nmo,)
    kern = dm_[None, :] / (dm_[None, :] ** 2 + (np.asarray(freqs) ** 2)[:, None]
                           + eta ** 2)
    return -np.einsum("w,wm,wm->", np.asarray(wts), Wn.real, kern) / np.pi


def _sigma_cd_point(Wiw, wts, mo_energy, nocc, Lmo, n, omega, ef, eta, freqs,
                    col=None):
    """Sigma_c(n, omega) by contour deformation: the imaginary-axis integral
    on the host from ``Wiw`` (nw, nmo, ncols) host W(iw') whose column
    ``col`` (default n) is orbital n, and the residues from W at the
    crossed poles' real frequencies on the device of ``Lmo``."""
    e = np.asarray(mo_energy, np.float64)
    col = n if col is None else col
    val = _imag_integral(np.asarray(Wiw)[:, :, col], wts, e, omega, eta, freqs)
    sel, sign = _residue_sel(e, omega, ef)
    res = 0.0 + 0.0j
    if sel.size:
        z = np.abs(omega - e[sel]) + 1j * eta
        naux = Lmo.shape[0]
        Lov, eia = _ov(Lmo, _on(e, Lmo.device), nocc)
        Lw = Lmo[:, torch.as_tensor(sel, device=Lmo.device), n]      # (naux, nsel)
        Wr = _w_z(Lov, eia, 4.0, Lw.reshape(naux, -1), z * z)       # (nz, nsel)
        res = sign * complex(Wr.diagonal().sum())
    return val + res


def _qp_solve(qp_eq, w0, max_iter=50, conv_tol=1e-6, de_num=1e-4,
              max_step=0.1, w_tol=1e-6):
    """Safeguarded quasi-Newton for the QP equation f(w) = 0.

    The finite-quadrature CD sigma is not smooth at mean-field pole
    crossings, so steps are clipped to ``max_step``; once a sign change
    brackets the root, iterates outside the bracket bisect. If the
    bracket collapses below ``w_tol`` with |f| still above ``conv_tol``,
    the root is a quadrature-step crossing and the midpoint is returned
    as converged (gw_cd.py reference semantics)."""
    w = w0
    lo = hi = None
    for _ in range(max_iter):
        f0 = qp_eq(w)
        if abs(f0) < conv_tol:
            return w, True
        if f0 > 0:
            hi = w
        else:
            lo = w
        if lo is not None and hi is not None and abs(hi - lo) < w_tol:
            return 0.5 * (lo + hi), True
        f1 = qp_eq(w + de_num)
        dsdw = (f1 - f0) / de_num
        # a secant slope far from the physical QP slope 1 - dSigma/dw means
        # the stencil straddled a quadrature jump: take the ideal slope
        denom = dsdw if 0.2 < dsdw < 10.0 else 1.0
        step = np.clip(-f0 / denom, -max_step, max_step)
        wn = w + step
        if lo is not None and hi is not None \
                and not (min(lo, hi) < wn < max(lo, hi)):
            wn = 0.5 * (lo + hi)
        w = wn
    return w, False


def gw_cd_gamma(system, res, xc: Optional[str] = None, nw: int = 100,
                orbs=None, eta: float = 5e-3, Lmo=None, max_iter: int = 50,
                conv_tol: float = 1e-6, device=None) -> GWResult:
    """G0W0-CD quasiparticle energies on a converged Gamma SCF result.

    Same inputs and outputs as rgw.gw_ac_gamma, Sigma_c evaluated at real
    frequency by contour deformation (reliable for deep core levels);
    ``eta`` is the residue-pole broadening (reference default 5e-3)."""
    require_device(system.aoR, device)
    mo_energy = _host(res["mo_energy"]).astype(np.float64)
    nmo = mo_energy.shape[0]
    nocc = system.nelec // 2
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)

    homo, lumo = mo_energy[nocc - 1], mo_energy[nocc]
    if lumo - homo < 1e-3:
        raise ValueError("GW-CD does not support metallic references")
    ef = 0.5 * (homo + lumo)

    vx_mo, v_mf_mo = _mf_potentials(system, res, xc)
    if Lmo is None:
        Lmo = build_lmo(system, res["mo_coeff"])

    freqs, wts = scaled_legendre(nw)
    # the imaginary-axis W(iw') of the asked columns, shared by every step
    Wiw = to_host(_w_batched_z(Lmo, mo_energy, nocc, -freqs ** 2 + 0j, cols=orbs))

    qp = mo_energy.copy()
    conv = True
    for io, p in enumerate(orbs):
        def qp_eq(w, p=p, io=io):
            s0 = _sigma_cd_point(Wiw, wts, mo_energy, nocc, Lmo, p, w, ef, eta,
                                 freqs, col=io).real
            return w - mo_energy[p] - (s0 + vx_mo[p] - v_mf_mo[p])

        qp[p], ok = _qp_solve(qp_eq, mo_energy[p], max_iter=max_iter,
                              conv_tol=conv_tol)
        conv = conv and ok
    return GWResult(qp_energy=qp, mo_energy=mo_energy, sigma_x=vx_mo,
                    v_mf=v_mf_mo, converged=conv, orbs=orbs, nocc=nocc)


# -------------------------------------------------- spin-polarized CD
def _uw_batched_z(La, Lb, ea, eb, nocc_a, nocc_b, z2, cols=None):
    """Spin-polarized screened interaction at complex frequencies:
    (W_a, W_b)[j, m, n] for the columns n in ``cols`` (default all), with
    the spin-summed polarizability

        Pi(z) = 2 sum_sigma sum_ia L^s_Pia L^s_Qia e_ia/(e_ia^2 - z^2)

    (ugw._usigma_iw's convention)."""
    from pyscf_isdf_tpu_torch.gw.ugw import _spin_ov

    dev = La.device
    naux, nmo, _ = La.shape
    cols = np.arange(nmo) if cols is None else np.asarray(cols)
    Lov, eia = _spin_ov((La, Lb), (_on(ea, dev), _on(eb, dev)), (nocc_a, nocc_b))
    c = torch.as_tensor(cols, device=dev)
    Lw = torch.cat([La[:, :, c].reshape(naux, -1), Lb[:, :, c].reshape(naux, -1)], 1)
    W = _w_z(Lov, eia, 2.0, Lw, z2).reshape(-1, 2, nmo, len(cols))
    return W[:, 0], W[:, 1]


def ugw_cd_gamma(system, res, xc: Optional[str] = None, nw: int = 100,
                 orbs=None, eta: float = 5e-3, nelec=None, max_iter: int = 50,
                 conv_tol: float = 1e-6, device=None):
    """Spin-polarized contour-deformation G0W0 (Gamma): the contour
    identity of :func:`gw_cd_gamma` with the spin-summed polarizability
    screening both channels (ugw.ugw_ac_gamma conventions); a QP solve
    per (spin, orbital). Returns a :class:`~pyscf_isdf_tpu_torch.gw.ugw.UGWResult`."""
    from pyscf_isdf_tpu_torch.gw.ugw import (UGWResult, _fermi, _nelec, _spin_lmo,
                                             _spin_ov, _umf_potentials)

    require_device(system.aoR, device)
    es = tuple(_host(e).astype(np.float64) for e in res["mo_energy"])
    nmo = es[0].shape[0]
    noccs = _nelec(system, nelec)
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)
    ef = _fermi(es, noccs, "GW-CD")
    La, Lb = _spin_lmo(system, res)
    dev = La.device
    Ls = (La, Lb)

    freqs, wts = scaled_legendre(nw)
    Wiw = [to_host(w) for w in _uw_batched_z(La, Lb, es[0], es[1], noccs[0], noccs[1],
                                              -freqs ** 2 + 0j, cols=orbs)]
    Lov, eia = _spin_ov(Ls, [_on(e, dev) for e in es], noccs)
    vx, v_mf = _umf_potentials(system, res, xc)

    def sigma_cd(s, n, io, omega):
        e_m = es[s]
        val = _imag_integral(Wiw[s][:, :, io], wts, e_m, omega, eta, freqs)
        sel, sign = _residue_sel(e_m, omega, ef)
        if sel.size:
            z = np.abs(omega - e_m[sel]) + 1j * eta
            Lw = Ls[s][:, torch.as_tensor(sel, device=dev), n]
            Wr = _w_z(Lov, eia, 2.0, Lw, z * z)
            val += sign * complex(Wr.diagonal().sum())
        return val

    qp = (es[0].copy(), es[1].copy())
    conv = True
    for s, e in enumerate(es):
        for io, p in enumerate(orbs):
            def qp_eq(w, s=s, p=p, io=io, e=e):
                return w - e[p] - (sigma_cd(s, p, io, w).real + vx[s][p] - v_mf[s][p])

            qp[s][p], ok = _qp_solve(qp_eq, e[p], max_iter=max_iter,
                                     conv_tol=conv_tol)
            conv = conv and ok
    return UGWResult(qp_energy=qp, mo_energy=es, sigma_x=tuple(vx),
                     v_mf=tuple(v_mf), converged=conv, nocc=noccs)


# ------------------------------------------------------------- k-point CD
def _w_kl_z(L_stack, Lw, e_i, e_a, z2, nk):
    """W_mn(z_j) for one momentum transfer kL and one self-energy k-point
    kn at a batch of complex squared frequencies z2: (nz, nmo, ncols) for
    ``Lw`` (naux, nmo, ncols) = Lmo[km][kn] restricted to its columns.

    Pi(z) = (4/nk) sum_{k,ia} L_Pia e_ia/(e_ia^2 - z^2) conj(L_Qia) and
    W_mn = (1/nk) sum_PQ conj(Lw_Pmn) [(1-Pi)^-1 - 1]_PQ Lw_Qmn
    (krgw_cd.py contract)."""
    from pyscf_isdf_tpu_torch.gw.krgw import _flat_ov

    dev = L_stack.device
    Lov, eia = _flat_ov(L_stack, _on(e_i, dev), _on(e_a, dev))
    naux, nmo, ncols = Lw.shape
    return (_w_z(Lov, eia, 4.0 / nk, Lw.reshape(naux, -1), z2) / nk).reshape(
        -1, nmo, ncols)


def kgw_cd(system, res, xc: Optional[str] = None, nw: int = 100,
           orbs=None, kptlist=None, eta: float = 5e-3, Lmo=None,
           max_iter: int = 50, conv_tol: float = 1e-6, device=None):
    """Contour-deformation G0W0 on a converged k-point SCF result (the
    reference's pyscf/pbc/gw/krgw_cd.py role). Same inputs as
    krgw.kgw_ac; Sigma_c at real frequency per (k, orbital):

        Sigma_c(n,kn; w) = sum_kL [ I_kL(n, w) + R_kL(n, w) ]

    with I from the per-transfer W(iw') of the asked columns and R from W
    at one real frequency per crossed pole (m at km = kn + kL). No q->0
    head/wing correction."""
    from pyscf_isdf_tpu_torch.gw.krgw import (
        KGWResult, _flat_ov, _k_index_table, _mf_potentials_kpts, _nocc_k,
        _transfer, build_lmo_kpts)

    dev = require_device(system.aoR_k, device)
    mo_energy = _host(res["mo_energy"]).astype(np.float64)
    nk, nmo = mo_energy.shape
    nocc = _nocc_k(system, nk, "k-GW")
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)
    kptlist = list(range(nk)) if kptlist is None else list(kptlist)

    homo = mo_energy[:, nocc - 1].max()
    lumo = mo_energy[:, nocc].min()
    if lumo - homo < 1e-3:
        raise ValueError("GW-CD does not support metallic references")
    ef = 0.5 * (homo + lumo)

    if Lmo is None:
        Lmo = build_lmo_kpts(system, res["mo_coeff"])

    freqs, wts = scaled_legendre(nw)
    ktab = _k_index_table(system.kpts, system.cell.a)
    ocols = torch.as_tensor(orbs, device=dev)
    nj, no = len(kptlist), len(orbs)
    # per transfer: the imaginary-axis W(iw') of the asked columns,
    # Wiw[kL][w, j, m, o], and the statics of its residues
    Wiw, kl_data = [], []
    for kL in range(nk):
        _, L_stack, km_of, e_i, e_a = _transfer(Lmo, mo_energy, ktab, kL, nocc,
                                                kptlist, dev)
        Lw_js = [Lmo[km_of[j]][kptlist[j]][:, :, ocols] for j in range(nj)]
        Lov, eia = _flat_ov(L_stack, e_i, e_a)
        naux = Lov.shape[0]
        Lw = torch.stack(Lw_js).reshape(nj, naux, -1)
        W = torch.empty((nw, nj, nmo * no), dtype=torch.float64, device=dev)
        ft = _on(freqs, dev)
        nc = freq_chunk(nw, naux, nj * nmo * no, 16)
        for w0 in range(0, nw, nc):
            R = torch.linalg.cholesky(_one_minus(_polarizability(
                Lov, eia, -ft[w0:w0 + nc] ** 2, 4.0 / nk)))
            W[w0:w0 + nc] = _w_chol(R, Lw) / nk
        Wiw.append(to_host(W).reshape(nw, nj, nmo, no))
        kl_data.append((L_stack, Lw_js, e_i, e_a, km_of))

    def sigma_cd(j, io, omega):
        """Sigma_c(orbs[io], kptlist[j]; omega)."""
        val = 0.0 + 0.0j
        for kL in range(nk):
            L_stack, Lw_js, e_i, e_a, km_of = kl_data[kL]
            e_m = mo_energy[km_of[j]]
            val += _imag_integral(Wiw[kL][:, j, :, io], wts, e_m, omega, eta, freqs)
            sel, sign = _residue_sel(e_m, omega, ef)
            if sel.size:
                z = np.abs(omega - e_m[sel]) + 1j * eta
                Lw = Lw_js[j][:, torch.as_tensor(sel, device=dev), io][:, :, None]
                Wr = _w_kl_z(L_stack, Lw, e_i, e_a, z * z, nk)      # (nz, nsel, 1)
                val += sign * complex(Wr[:, :, 0].diagonal().sum())
        return val

    vx_mo, v_mf_mo = _mf_potentials_kpts(system, res, xc)

    qp = mo_energy.copy()
    conv = True
    for j, kn in enumerate(kptlist):
        for io, p in enumerate(orbs):
            def qp_eq(w, j=j, io=io, kn=kn, p=p):
                return w - mo_energy[kn, p] - (sigma_cd(j, io, w).real
                                               + vx_mo[kn, p] - v_mf_mo[kn, p])

            qp[kn, p], ok = _qp_solve(qp_eq, mo_energy[kn, p], max_iter=max_iter,
                                      conv_tol=conv_tol)
            conv = conv and ok
    return KGWResult(qp_energy=qp, mo_energy=mo_energy, sigma_x=vx_mo,
                     v_mf=v_mf_mo, converged=conv, nocc=nocc)

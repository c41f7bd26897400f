"""k-point G0W0-AC quasiparticle band energies (torch).

Reference contract: pyscf/pbc/gw/krgw_ac.py (Zhu & Chan,
arXiv:2007.03148), as the JAX package carries it over
(``pyscf_isdf_tpu/gw/krgw.py``): per momentum transfer kL the density
response sums over conserving (ki, kj = ki - kL) pairs, the dielectric
matrix is inverted in the auxiliary basis, and the self-energy at band kn
takes the screened interaction from the km = kn + kL pair; then Pade
continuation and Newton QP solves as at Gamma.

Per kL the pair tensors of every ki share one whitened q-space auxiliary
basis (df/gdf.py build_gdf_kpts), so they stack into one
(nk, naux_q, nocc, nvir) array and each frequency's polarizability is one
GEMM over the stacked (k, i, a) index. Frequencies go in chunks
(rgw.freq_chunk): 1 - Pi(iw) is Hermitian positive definite, and its
Cholesky factor gives the screened interaction by a triangular solve and
the RPA log-determinant from its diagonal, as at Gamma.

``fc=True`` adds the q->0 head and wing corrections (krgw_ac.py:255-337).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device, to_host
from pyscf_isdf_tpu_torch.df import fftdf_k
from pyscf_isdf_tpu_torch.gw.rgw import (
    _host, _on, _one_minus, _pade_fit_points, _polarizability, _rpa_integrand,
    _solve_qp_ac, _w_chol, _xcspec, freq_chunk, scaled_legendre, sigma_grid)
from pyscf_isdf_tpu_torch.scf.khf import bloch_ao_gradients, vxc_kpts
from pyscf_isdf_tpu_torch.utils.timing import null_timer

C128 = torch.complex128


@dataclass
class KGWResult:
    qp_energy: np.ndarray       # (nk, nmo)
    mo_energy: np.ndarray
    sigma_x: np.ndarray         # (nk, nmo) diag <p| -0.5 K |p>
    v_mf: np.ndarray            # (nk, nmo) diag <p| veff - vj |p>
    converged: bool
    nocc: int
    sigma_iw: np.ndarray | None = None    # (nkpt, norb, nw_sigma) Sigma_c(iw')
    omega_grid: np.ndarray | None = None  # (nw_sigma,) its w' grid


def _k_index_table(kpts, a):
    """ktab[i, L] = index of k_i - k_L folded to the mesh.  kscaled
    differences of a Monkhorst-Pack mesh close under subtraction."""
    kpts = np.reshape(kpts, (-1, 3))
    ks = kpts @ a.T / (2.0 * np.pi)
    nk = len(kpts)
    tab = np.full((nk, nk), -1, dtype=np.int64)
    for i in range(nk):
        for L in range(nk):
            d = ks[i] - ks[L]
            for j in range(nk):
                if np.linalg.norm(np.round(ks[j] - d) - (ks[j] - d)) < 1e-10:
                    tab[i, L] = j
                    break
    if (tab < 0).any():
        raise ValueError("k-mesh not closed under subtraction "
                         "(GW needs a full Monkhorst-Pack mesh)")
    return tab


def _flat_ov(L_stack, e_i, e_a):
    """The stacked (naux, nk * nov) pair factors and (nk * nov,) e_ia of
    one momentum transfer."""
    nk, naux = L_stack.shape[:2]
    Lov = L_stack.reshape(nk, naux, -1).permute(1, 0, 2).reshape(naux, -1)
    eia = (e_i[:, :, None] - e_a[:, None, :]).reshape(-1)
    return Lov, eia


def _pi_kl(L_stack, e_i, e_a, freqs, nk):
    """Polarizability stack for one momentum transfer at the frequencies
    ``freqs`` (a chunk): Pi[w] = 4/nk sum_{k,ia} L_Pia f_w,ia conj(L_Qia),
    (nw, naux, naux), one GEMM a frequency."""
    dev = L_stack.device
    Lov, eia = _flat_ov(L_stack, _on(e_i, dev), _on(e_a, dev))
    return _polarizability(Lov, eia, -_on(freqs, dev) ** 2, 4.0 / nk)


def _g0_factors(e_m, freqs, omega_grid, ef):
    """(g0_occ, g0_vir), each (nw, nklist, nmo, nw_sigma)."""
    out = []
    for sgn in (-1.0, 1.0):
        emo = sgn * 1j * omega_grid[None, None, :] + ef - e_m[:, :, None]
        out.append(emo[None] / (emo[None] ** 2 + (freqs ** 2)[:, None, None, None]))
    return tuple(out)


def _kl_contribution(chol, Lw_stack, e_m, freqs, wts, omega_grid, ef, nocc,
                     nk, orbs=None):
    """Sigma contribution (nklist, norb, nw_sigma) of one momentum transfer
    and one chunk of frequencies, from the chunk's lower Cholesky factors
    ``chol`` (nc, naux, naux) of 1 - Pi.

    Lw_stack: (nklist, naux, nmo, norb) W-side tensors L^{kn+kL, kn} for
    the orbitals ``orbs`` (default all); e_m: (nklist, nmo) eigenvalues at
    km = kn + kL. W_mn(iw) = 1/nk [|R^-1 L_mn|^2 - |L_mn|^2]."""
    dev = chol.device
    nj, naux, nmo, norb = Lw_stack.shape
    orbs = np.arange(norb) if orbs is None else np.asarray(orbs)
    W = (_w_chol(chol, Lw_stack.reshape(nj, naux, -1)) / nk).reshape(
        chol.shape[0], nj, nmo, norb).to(C128)
    g0_occ, g0_vir = _g0_factors(_on(e_m, dev), _on(freqs, dev),
                                 _on(omega_grid, dev), ef)
    wc = _on(wts, dev).to(C128)
    sig_occ = -torch.einsum("w,wnmq,wnmu->nqu", wc, W, g0_occ) / np.pi
    sig_vir = -torch.einsum("w,wnmq,wnmu->nqu", wc, W, g0_vir) / np.pi
    sel = torch.as_tensor(orbs < nocc, device=dev)[None, :, None]
    return torch.where(sel, sig_occ, sig_vir)


def _q0_fold(f_w, qij, Lov, eps_body_inv_w, qnorm, nk):
    """q->0 head/wing inverse-dielectric folding (one frequency):

        pi00  = 4/nk sum f |qij|^2          (head polarizability)
        piP0  = 4/nk sum L f conj(qij)      (wing vector)
        eps00 = 1 - 4 pi/q^2 pi00,  epsP0 = -sqrt(4 pi)/q piP0
        ei00  = 1/(eps00 - epsP0^H eps_body_inv epsP0)
        eiP0  = -ei00 eps_body_inv epsP0

    (krgw_ac.py:289-318), shared by the kgw_ac fc branch and
    dielectric_constant; tensors on one device."""
    pi00 = 4.0 / nk * torch.einsum("kia,kia->", f_w.to(C128), qij.abs().to(C128) ** 2)
    piP0 = 4.0 / nk * torch.einsum("kPia,kia->P", Lov, f_w * qij.conj())
    eps00 = 1.0 - 4.0 * np.pi / qnorm ** 2 * pi00
    epsP0 = -np.sqrt(4.0 * np.pi) / qnorm * piP0
    ei00 = 1.0 / (eps00 - epsP0.conj() @ eps_body_inv_w @ epsP0)
    eiP0 = -ei00 * (eps_body_inv_w @ epsP0)
    return ei00, eiP0


def _get_qij(system, res, q, nocc):
    """k.p transition dipoles qij = <psi_ik|e^{iqr}|psi_ak>/sqrt(vol) for
    the q->0 head/wing corrections (krgw_ac.py:389-425): on the uniform
    grid with spectral AO gradients, (nk, nocc, nvir) on the system's
    device."""
    aoR_k = system.aoR_k
    dev = aoR_k.device
    nk = len(system.kpts)
    ao_grad = bloch_ao_gradients(system)                     # (nk, 3, ng, nao)
    mo_energy = _on(res["mo_energy"], dev)
    C = _on(res["mo_coeff"], dev, C128)
    qt = torch.as_tensor(np.asarray(q, dtype=np.float64), dtype=C128, device=dev)
    out = []
    for k in range(nk):
        M = -1j * system.weight * torch.einsum("x,gm,xgn->mn", qt, aoR_k[k].conj(),
                                               ao_grad[k])
        Mmo = C[k][:, :nocc].conj().T @ M @ C[k][:, nocc:]
        enm = mo_energy[k][None, nocc:] - mo_energy[k][:nocc, None]
        out.append(Mmo / enm / np.sqrt(system.cell.vol))
    return torch.stack(out)


def build_lmo_kpts(system, mo_coeff, beta: float = 2.0, l_extra: int = 2,
                   kg=None, timer=None):
    """Whitened per-(k1,k2) DF tensors in the MO basis on the system's
    device: Lmo[k1][k2][P,p,q] = C^{k1 dagger} cd^{k1k2}_P C^{k2}.

    Pass a prebuilt ``kg`` (KGDF) to share one AO-basis fit across
    several MO transforms (the spin channels of kugw_ac)."""
    from pyscf_isdf_tpu_torch.df import gdf as gdf_mod

    if kg is None:
        kg = gdf_mod.build_gdf_kpts(system.cell, system.aoR_k, system.kpts,
                                    system.mesh, system.weight, beta=beta,
                                    l_extra=l_extra, timer=timer)
    C = _on(mo_coeff, system.aoR_k.device, C128)
    return [[torch.matmul(C[k1].conj().T, kg.cd[k1][k2] @ C[k2])
             for k2 in range(kg.nk)] for k1 in range(kg.nk)]


def _exchange_kpts(system, dm, coulG_pairs, madelung):
    """-(vk + madelung S dm S) at every k (the get_k_kpts weight is
    (1/nk) vol/ngrids, df/fftdf_k.py)."""
    nk = len(system.kpts)
    vk = fftdf_k.get_k_kpts(system.aoR_k, dm, coulG_pairs, system.expmikr,
                            system.mesh, system.weight / nk)
    S = system.S
    return -(vk + madelung * (S @ dm @ S))


def _mf_potentials_kpts(system, res, xc: Optional[str]):
    """(nk, nmo) diagonal MO elements of v_mf = veff - vj and of the HF
    exchange on the SCF density (kscf_kernel Fock conventions), host
    float64 arrays."""
    from pyscf_isdf_tpu_torch.ops import coulomb

    aoR_k = system.aoR_k
    dev = aoR_k.device
    dm = _on(res["dm"], dev, C128)
    C = _on(res["mo_coeff"], dev, C128)
    vx_ao = 0.5 * _exchange_kpts(system, dm, system.coulG_pairs, system.madelung)

    spec = _xcspec(xc)
    if spec is None:
        v_mf_ao = vx_ao
    else:
        ao_grad_k = (bloch_ao_gradients(system)
                     if spec.family in ("gga", "mgga") else None)
        _, v_mf_ao = vxc_kpts(aoR_k, ao_grad_k, dm, system.weight, spec)
        if spec.omega != 0.0:
            # RSH at k (scf/khf.py kernel semantics): hyb K_full +
            # (alpha - hyb) K_LR(omega), the LR part under erf-kernel pair
            # Coulomb kernels with its own probe-charge Madelung constant
            cpl, _ = fftdf_k.make_k_kernels(system.cell, system.kpts,
                                            omega=spec.omega)
            mad_lr = coulomb.madelung_omega(system.cell, system.kpts, spec.omega)
            vx_lr = 0.5 * _exchange_kpts(
                system, dm, torch.as_tensor(cpl, device=dev), mad_lr)
            v_mf_ao = v_mf_ao + spec.hyb * vx_ao + (spec.alpha - spec.hyb) * vx_lr
        elif spec.hyb > 0:
            v_mf_ao = v_mf_ao + spec.hyb * vx_ao

    def diag(V):
        return to_host(torch.einsum("kip,kij,kjp->kp", C.conj(), V, C).real)
    return diag(vx_ao), diag(v_mf_ao)


def _nocc_k(system, nk, what):
    if system.nelec_tot % (2 * nk):
        raise ValueError(f"{what} needs a uniform integer band filling")
    return system.nelec_tot // (2 * nk)


def _transfer(Lmo, mo_energy, ktab, kL, nocc, kptlist, dev):
    """One momentum transfer's occupied-virtual stack, its eigenvalues and
    the km = kn + kL map of the bands ``kptlist``."""
    nk = len(Lmo)
    kidx = ktab[:, kL]                                   # kj = ki - kL
    L_stack = torch.stack([Lmo[i][kidx[i]][:, :nocc, nocc:] for i in range(nk)])
    km_of = np.array([int(np.nonzero(kidx == kn)[0][0]) for kn in kptlist])
    e_i = _on(mo_energy[:, :nocc], dev)
    e_a = _on(mo_energy[kidx, nocc:], dev)
    return kidx, L_stack, km_of, e_i, e_a


def _solve_all_k(sigma, omega_grid, mo_energy, kptlist, orbs, nocc, ef, vx_mo,
                 v_mf_mo, linearized):
    """Pade fits and QP solves of every (k, orbital): (qp, converged)."""
    fit = _pade_fit_points(len(omega_grid))
    qp = mo_energy.copy()
    conv = True
    for j, kn in enumerate(kptlist):
        for io, p in enumerate(orbs):
            qp[kn, p], _, ok = _solve_qp_ac(
                sigma[j, io], omega_grid, fit, ef, mo_energy[kn, p], p < nocc,
                vx_mo[kn, p], v_mf_mo[kn, p], linearized)
            conv = conv and ok
    return qp, conv


def kgw_ac(system, res, xc: Optional[str] = None, nw: int = 100,
           orbs=None, kptlist=None, linearized: bool = False,
           Lmo=None, fc: bool = False, q_dir=(1.0, 0.0, 0.0), device=None,
           timer=None) -> KGWResult:
    """G0W0-AC on a converged k-point SCF result (kscf_kernel dict).

    ``fc=True`` adds the q->0 head + wing finite-size corrections
    (krgw_ac.py:255-337, Phys. Rev. B 83, 245122 k.p dipoles): the G=0
    dielectric head 1 - 4pi/q^2 Pi_00 and wings are folded into an
    inverse-dielectric correction Del_00/Del_P0 applied at the Gamma
    momentum transfer. ``timer`` records 'lmo' (with the GDF stages),
    'transfer' (each momentum transfer's Sigma) and 'pade_newton'."""
    dev = require_device(system.aoR_k, device)
    timer = timer or null_timer
    mo_energy = _host(res["mo_energy"]).astype(np.float64)
    nk, nmo = mo_energy.shape
    nocc = _nocc_k(system, nk, "k-GW")
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)
    kptlist = list(range(nk)) if kptlist is None else list(kptlist)

    homo = mo_energy[:, nocc - 1].max()
    lumo = mo_energy[:, nocc].min()
    if lumo - homo < 1e-3:
        raise ValueError("GW-AC does not support metallic references")
    ef = 0.5 * (homo + lumo)

    if Lmo is None:
        with timer("lmo"):
            Lmo = build_lmo_kpts(system, res["mo_coeff"], timer=timer)

    freqs, wts = scaled_legendre(nw)
    omega_grid = sigma_grid(freqs)
    ktab = _k_index_table(system.kpts, system.cell.a)
    ocols = torch.as_tensor(orbs, device=dev)
    nj = len(kptlist)
    sigma = torch.zeros((nj, len(orbs), len(omega_grid)), dtype=C128, device=dev)
    ft, wt, og = _on(freqs, dev), _on(wts, dev), _on(omega_grid, dev)
    if fc:
        b = 2.0 * np.pi * np.linalg.inv(system.cell.a).T
        q_abs = 1e-3 * (np.asarray(q_dir, float) / np.linalg.norm(q_dir)) @ b
        qnorm = np.linalg.norm(q_abs)
        qij = _get_qij(system, res, q_abs, nocc)
        vol = system.cell.vol
        pref00 = 2.0 / np.pi * (6.0 * np.pi ** 2 / vol / nk) ** (1. / 3.)
        prefP0 = np.sqrt(vol / 4.0 / np.pi ** 3) \
            * (6.0 * np.pi ** 2 / vol / nk) ** (2. / 3.)
        e_all = _on(mo_energy, dev)
        eia_all = e_all[:, :nocc, None] - e_all[:, None, nocc:]
        # <n|P|n> at each band k, for the wing: (nj, naux, norb)
        Ldiag = torch.stack([Lmo[kn][kn].diagonal(dim1=1, dim2=2)[:, ocols]
                             for kn in kptlist])
    occ_rows = torch.as_tensor(orbs < nocc, device=dev)[None, :, None]
    for kL in range(nk):
        with timer("transfer"):
            kidx, L_stack, km_of, e_i, e_a = _transfer(Lmo, mo_energy, ktab, kL,
                                                       nocc, kptlist, dev)
            Lw_stack = torch.stack([Lmo[km_of[j]][kn][:, :, ocols]
                                    for j, kn in enumerate(kptlist)])
            e_m = _on(mo_energy[km_of, :], dev)
            Lov, eia = _flat_ov(L_stack, e_i, e_a)
            gamma_fc = fc and (kidx == np.arange(nk)).all()
            nc = freq_chunk(nw, Lov.shape[0], nj * Lw_stack.shape[2] * len(orbs), 16)
            for w0 in range(0, nw, nc):
                R = torch.linalg.cholesky(_one_minus(_polarizability(
                    Lov, eia, -ft[w0:w0 + nc] ** 2, 4.0 / nk)))
                sigma += _kl_contribution(R, Lw_stack, e_m, ft[w0:w0 + nc],
                                          wt[w0:w0 + nc], og, ef, nocc, nk, orbs)
                if not gamma_fc:
                    continue
                # q -> 0 head + wing corrections at the Gamma transfer
                # (krgw_ac.py:289-337)
                eps_inv = torch.cholesky_inverse(R)
                g0_occ, g0_vir = _g0_factors(e_m[:, ocols], ft[w0:w0 + nc], og, ef)
                for c in range(eps_inv.shape[0]):
                    w = w0 + c
                    f_w = eia_all / (freqs[w] ** 2 + eia_all ** 2)
                    ei00, eiP0 = _q0_fold(f_w, qij, L_stack, eps_inv[c], qnorm, nk)
                    del00 = pref00 * (ei00 - 1.0)
                    delP0 = prefP0 * 2.0 * torch.einsum("jPn,P->jn", Ldiag, eiP0).real
                    corr = -(del00 + delP0[:, :, None]) * wts[w] / np.pi
                    sigma += torch.where(occ_rows, corr * g0_occ[c], corr * g0_vir[c])

    vx_mo, v_mf_mo = _mf_potentials_kpts(system, res, xc)
    sig_h = to_host(sigma)
    with timer("pade_newton"):
        qp, conv = _solve_all_k(sig_h, omega_grid, mo_energy, kptlist, orbs, nocc, ef,
                                vx_mo, v_mf_mo, linearized)
    return KGWResult(qp_energy=qp, mo_energy=mo_energy, sigma_x=vx_mo,
                     v_mf=v_mf_mo, converged=conv, nocc=nocc, sigma_iw=sig_h,
                     omega_grid=omega_grid)


def rpa_ecorr_kpts(system, res, nw: int = 100, Lmo=None, device=None) -> float:
    """k-point direct-RPA correlation energy per unit cell.

    The supercell polarizability block-diagonalizes over momentum
    transfers, so the ln-det trace splits per q:

        Ec_cell = 1/(2 pi nk) sum_q int_0^inf dw
                  tr[ ln(1 - Pi_q(iw)) + Pi_q(iw) ]

    (the log-determinant from each Cholesky factor's diagonal)."""
    dev = require_device(system.aoR_k, device)
    mo_energy = _host(res["mo_energy"]).astype(np.float64)
    nk, nmo = mo_energy.shape
    nocc = _nocc_k(system, nk, "k-RPA")
    if Lmo is None:
        Lmo = build_lmo_kpts(system, res["mo_coeff"])
    freqs, wts = scaled_legendre(nw)
    ktab = _k_index_table(system.kpts, system.cell.a)
    total = 0.0
    for kL in range(nk):
        _, L_stack, _, e_i, e_a = _transfer(Lmo, mo_energy, ktab, kL, nocc, [], dev)
        Lov, eia = _flat_ov(L_stack, e_i, e_a)
        total += float(np.sum(wts * _rpa_integrand(Lov, eia, freqs, 4.0 / nk)))
    return total / (2.0 * np.pi * nk)


def dielectric_constant(system, res, q_dir=(1.0, 0.0, 0.0), Lmo=None,
                        device=None) -> float:
    """Macroscopic (electronic, high-frequency) dielectric constant
    eps_infinity along ``q_dir``: eps_M = 1 / eps^-1_00(q->0, w=0) with
    the head + wing + body inverse-dielectric folding of the kgw_ac fc
    branch at a single static frequency."""
    dev = require_device(system.aoR_k, device)
    mo_energy = _host(res["mo_energy"]).astype(np.float64)
    nk, nmo = mo_energy.shape
    nocc = _nocc_k(system, nk, "dielectric_constant")
    if mo_energy[:, nocc].min() - mo_energy[:, nocc - 1].max() < 1e-3:
        raise ValueError("dielectric_constant: metallic reference "
                         "(the static interband response diverges)")
    if Lmo is None:
        Lmo = build_lmo_kpts(system, res["mo_coeff"])

    b = 2.0 * np.pi * np.linalg.inv(system.cell.a).T
    q_abs = 1e-3 * (np.asarray(q_dir, float) / np.linalg.norm(q_dir)) @ b
    qij = _get_qij(system, res, q_abs, nocc)
    qnorm = np.linalg.norm(q_abs)

    # static (w=0) response at the Gamma momentum transfer
    L_stack = torch.stack([Lmo[i][i][:, :nocc, nocc:] for i in range(nk)])
    e = _on(mo_energy, dev)
    Pi = _pi_kl(L_stack, e[:, :nocc], e[:, nocc:], np.zeros(1), nk)[0]
    eps_body_inv = torch.linalg.inv(_one_minus(Pi))
    eia = e[:, :nocc, None] - e[:, None, nocc:]
    ei00, _ = _q0_fold(1.0 / eia, qij, L_stack, eps_body_inv, qnorm, nk)
    return float(1.0 / ei00.real)

"""Gamma-point G0W0-AC quasiparticle energies and RPA correlation energy
(torch).

Reference contract: pyscf/gw/gw_ac.py and the k-point production code
pyscf/pbc/gw/krgw_ac.py (Zhu & Chan, arXiv:2007.03148), as the JAX
package carries them over (``pyscf_isdf_tpu/gw/rgw.py``): the
correlation self-energy on the imaginary-frequency axis from
density-fitted integrals, a Pade (Thiele) continuation to the real axis
and a Newton solve of the quasiparticle equation, all in float64.

Layout over frequency. The JAX package batches every quadrature
frequency in one program; at diamond 3x3x3 (naux 6227, n_ov 11664,
nw 100) its (nw, naux, n_ov) weighted factor would take 58 GB and the
(nw, naux, naux) polarizability stack 31 GB. Here the frequencies are
taken a chunk at a time (:func:`freq_chunk`, a device-byte budget), and
each frequency's polarizability is one GEMM,

    Pi(iw) = 4 (Lov * f_w) Lov^T,   f_w,ia = e_ia / (w^2 + e_ia^2) < 0,

so 1 - Pi(iw) is symmetric positive definite and one Cholesky factor R
(1 - Pi = R R^T) serves both the screened interaction and the RPA
log-determinant:

    W_mn(iw) = L_mn^T [(1 - Pi)^-1 - 1] L_mn = |R^-1 L_mn|^2 - |L_mn|^2,
    tr ln(1 - Pi) = 2 sum ln diag(R),

a triangular solve against the needed columns (n in ``orbs``) instead of
an inverse and a second product. The Pade fits and the Newton solves stay
on the host in float64 numpy/scipy, on one (norb, nw_sigma) copy of
Sigma(iw).

Conventions (the SCF's Fock assembly, so GW@HF reduces to identity):
v_mf = veff - vj = vxc - 0.5 hyb vk_ewald and the HF exchange on the
same density vx = -0.5 (vk + madelung S dm S).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device, to_host
from pyscf_isdf_tpu_torch.df import fftdf
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.hf import _vxc_gga, _vxc_lda, _vxc_mgga
from pyscf_isdf_tpu_torch.utils.timing import null_timer

# device bytes one frequency chunk may take: its (naux, naux) factors and
# the (naux, ncols) columns solved against them
CHUNK_BYTES = 4 << 30
IW_CUTOFF = 5.0          # Sigma(iw') is evaluated for w' below this (Ha)


# ------------------------------------------------------------------
# imaginary-axis quadrature (krgw_ac.py:427-441 contract)

def scaled_legendre(nw: int):
    """Gauss-Legendre nodes mapped from [-1,1] to [0,inf) by
    x -> x0 (1+x)/(1-x), x0 = 0.5 (same map as the reference)."""
    x, w = np.polynomial.legendre.leggauss(nw)
    x0 = 0.5
    freqs = x0 * (1.0 + x) / (1.0 - x)
    wts = w * 2.0 * x0 / (1.0 - x) ** 2
    return freqs, wts


def sigma_grid(freqs):
    """The self-energy's evaluation grid: 0 and the nodes below
    :data:`IW_CUTOFF`, (nw_sigma,)."""
    nw_sigma = int(np.sum(freqs < IW_CUTOFF)) + 1
    omega_grid = np.zeros(nw_sigma)
    omega_grid[1:] = freqs[: nw_sigma - 1]
    return omega_grid


def freq_chunk(nw: int, naux: int, ncols: int, itemsize: int = 8) -> int:
    """Frequencies a chunk so that its (naux, naux) matrices and
    (naux, ncols) solved columns stay within :data:`CHUNK_BYTES` (at
    least 1)."""
    per = itemsize * naux * (naux + ncols)
    return int(max(1, min(nw, CHUNK_BYTES // per)))


def _host(x):
    """``x`` (a tensor, a list of per-k tensors, or array-like) as a host
    numpy array."""
    if isinstance(x, (list, tuple)) and x and torch.is_tensor(x[0]):
        return np.stack([to_host(t) for t in x])
    return to_host(x)


def _on(x, device, dtype=torch.float64):
    """``x`` (tensor, numpy or list) as a tensor of ``dtype`` on ``device``."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    if isinstance(x, (list, tuple)) and x and torch.is_tensor(x[0]):
        return torch.stack([t.to(device=device, dtype=dtype) for t in x])
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


# ------------------------------------------------------------------
# the chunked screened interaction

def _polarizability(Lov, eia, z2, scale):
    """Pi(z) = scale (Lov * f) Lov^H with f = e_ia / (e_ia^2 - z^2), one
    GEMM per entry of ``z2`` (z^2; -w^2 on the imaginary axis):
    (nz, naux, naux)."""
    f = eia[None, :] / (eia[None, :] ** 2 - z2[:, None])
    dtype = torch.promote_types(Lov.dtype, f.dtype)
    out = torch.empty((z2.shape[0], Lov.shape[0], Lov.shape[0]), dtype=dtype,
                      device=Lov.device)
    if f.is_complex() and not Lov.is_complex():
        # real factors, complex weights (Gamma, off the imaginary axis):
        # two real GEMMs instead of one complex one
        for j in range(z2.shape[0]):
            out[j] = torch.complex(Lov * f[j].real @ Lov.T, Lov * f[j].imag @ Lov.T)
        return out.mul_(scale)
    Lov = Lov.to(dtype)
    Lh = Lov.conj().T
    for j in range(z2.shape[0]):
        torch.matmul(Lov * f[j].to(dtype), Lh, out=out[j])
    return out.mul_(scale)


def _one_minus(pi):
    """1 - Pi in place."""
    pi.neg_().diagonal(dim1=-2, dim2=-1).add_(1.0)
    return pi


def _w_chol(R, Lw):
    """Lw^H ((1 - Pi)^-1 - 1) Lw column by column from the Cholesky factors
    ``R`` (nc, naux, naux) of 1 - Pi: |R^-1 Lw|^2 - |Lw|^2, (nc, ncols)
    real. ``Lw`` is (naux, ncols), or (nb, naux, ncols) for a batch of
    right-hand sides per factor, giving (nc, nb, ncols); the columns go in
    blocks whose solutions fit :data:`CHUNK_BYTES`."""
    batched = Lw.dim() == 3
    nc, naux = R.shape[0], R.shape[1]
    nb = Lw.shape[0] if batched else 1
    ncols = Lw.shape[-1]
    step = max(1, CHUNK_BYTES // (R.element_size() * naux * nc * nb))
    Rb = R[:, None] if batched else R
    out = torch.empty((nc, nb, ncols) if batched else (nc, ncols),
                      dtype=torch.float64, device=R.device)
    for c0 in range(0, ncols, step):
        cols = Lw[..., c0:c0 + step].to(R.dtype)
        X = torch.linalg.solve_triangular(Rb, cols, upper=False)
        out[..., c0:c0 + step] = ((X.real ** 2 + X.imag ** 2) if X.is_complex()
                                  else X * X).sum(-2) \
            - (cols.abs() ** 2).sum(-2).real
    return out


def _w_solve(M, Lw):
    """Lw^H (M^-1 - 1) Lw column by column for general (complex) M
    (nz, naux, naux) and ``Lw`` (naux, ncols): (nz, ncols)."""
    Lc = Lw.to(M.dtype)
    # one solve a matrix: the host LAPACK's batched complex LU is not safe
    # under several threads
    Y = torch.stack([torch.linalg.solve(m, Lc) for m in M])
    return (Lc.conj() * Y).sum(-2) - (Lc.conj() * Lc).sum(-2)


def _g0(e, freqs, omega_grid, ef, sgn):
    """g0[w, m, u] = x / (x^2 + w^2), x = sgn i w'_u + ef - e_m."""
    emo = sgn * 1j * omega_grid[None, :] + ef - e[:, None]
    return emo[None] / (emo[None] ** 2 + (freqs ** 2)[:, None, None])


def _sigma_iw_batched(Lmo, mo_energy, nocc, freqs, wts, omega_grid, ef,
                      orbs=None, timer=None):
    """Diagonal Sigma_c(i w') of the orbitals ``orbs`` (default all), over
    frequency chunks.

    Args:
        Lmo: (naux, nmo, nmo) whitened DF tensor in the MO basis (real).
        omega_grid: (nw_sigma,) imaginary parts of the sigma evaluation
            grid (>= 0; occupied orbitals use -i w', virtuals +i w').
        timer: optional StageTimer; records 'pi', 'factor', 'w' and
            'sigma' per chunk.
    Returns:
        (norb, nw_sigma) complex128 tensor on the device of ``Lmo``: occ
        rows evaluated at ef - i w', vir rows at ef + i w'
        (krgw_ac.py:225-232 split).
    """
    timer = timer or null_timer
    dev = Lmo.device
    naux, nmo, _ = Lmo.shape
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)
    e = _on(mo_energy, dev)
    freqs_t, wts_t = _on(freqs, dev), _on(wts, dev)
    og = _on(omega_grid, dev)
    eia = (e[:nocc, None] - e[None, nocc:]).reshape(-1)
    Lov = Lmo[:, :nocc, nocc:].reshape(naux, -1)
    Lw = Lmo[:, :, torch.as_tensor(orbs, device=dev)].reshape(naux, -1)
    norb = len(orbs)
    occ = torch.as_tensor(orbs < nocc, device=dev)[:, None]
    sig = torch.zeros((norb, og.shape[0]), dtype=torch.complex128, device=dev)
    nc = freq_chunk(len(freqs), naux, Lw.shape[1])
    for w0 in range(0, len(freqs), nc):
        fw = freqs_t[w0:w0 + nc]
        with timer("pi"):
            M = _one_minus(_polarizability(Lov, eia, -fw ** 2, 4.0))
        with timer("factor"):
            R = torch.linalg.cholesky(M)
            del M
        with timer("w"):
            W = _w_chol(R, Lw).reshape(-1, nmo, norb).to(torch.complex128)
            del R
        with timer("sigma"):
            wc = wts_t[w0:w0 + nc].to(torch.complex128)
            s_o = torch.einsum("w,wmn,wmu->nu", wc, W, _g0(e, fw, og, ef, -1.0))
            s_v = torch.einsum("w,wmn,wmu->nu", wc, W, _g0(e, fw, og, ef, 1.0))
            sig -= torch.where(occ, s_o, s_v) / np.pi
    return sig


# ------------------------------------------------------------------
# Pade (Thiele reciprocal differences) analytic continuation, host numpy

def thiele_coefficients(fn: np.ndarray, zn: np.ndarray) -> np.ndarray:
    """Continued-fraction coefficients a_i of the Thiele interpolant
    through (zn, fn).  Standard recursion (J. Low Temp. Phys. 29, 179)."""
    n = len(zn)
    g = np.zeros((n, n), dtype=np.complex128)
    g[:, 0] = fn
    for i in range(1, n):
        g[i:, i] = (g[i - 1, i - 1] - g[i:, i - 1]) \
            / ((zn[i:] - zn[i - 1]) * g[i:, i - 1])
    return g.diagonal().copy()


def pade_eval(z, zn: np.ndarray, a: np.ndarray):
    """Evaluate the Thiele continued fraction at (complex) z."""
    n = len(a)
    x = a[-1] * (z - zn[-2])
    for i in range(n - 2, 0, -1):
        x = a[i] * (z - zn[i - 1]) / (1.0 + x)
    return a[0] / (1.0 + x)


def _pade_fit_points(nw_sigma: int):
    """Reference point selection (krgw_ac.py:521-527): every 6th point
    through the low-frequency region, then every 4th in the tail."""
    if nw_sigma < 2:
        raise ValueError(
            f"nw_sigma={nw_sigma}: Pade fit needs at least 2 self-energy "
            "frequencies; increase the quadrature size nw")
    idx1 = list(range(1, min(40, nw_sigma), 6))
    idx2 = list(range(idx1[-1] + 4, nw_sigma, 4))
    idx = np.array(idx1 + idx2)
    n = (len(idx) // 2) * 2          # Thiele needs an even count
    return idx[:n]


def _solve_qp_ac(sigma_p, omega_grid, fit, ef, e_p, occupied, vx_p, vmf_p,
                 linearized):
    """The Pade fit of one orbital's Sigma(iw') and its QP equation:
    (qp, Z, converged)."""
    from scipy.optimize import newton

    sgn = -1.0 if occupied else 1.0
    zn = 1j * sgn * omega_grid[fit]
    a = thiele_coefficients(sigma_p[fit], zn)

    def sigma_real(w):
        return pade_eval(w - ef, zn, a).real

    de = 1e-6
    if linearized:
        s0 = sigma_real(e_p)
        z = 1.0 / (1.0 - (sigma_real(e_p + de) - s0) / de)
        return e_p + z * (s0 + vx_p - vmf_p), z, True
    ok = True
    try:
        qp = newton(lambda w: w - e_p - (sigma_real(w) + vx_p - vmf_p), e_p,
                    tol=1e-6, maxiter=100)
    except RuntimeError:
        qp, ok = e_p, False
    z = 1.0 / (1.0 - (sigma_real(qp + de) - sigma_real(qp - de)) / (2 * de))
    return qp, z, ok


QP_SENS_REL = 1e-14          # the relative change of Sigma(iw') qp_sensitivity applies
QP_SENS_SEEDS = (0, 1, 2)    # its random +-1 patterns
QP_BAR = 1e-8                # Ha: the floor of qp_bars


def qp_sensitivity(sigma_p, omega_grid, ef, e_p, occupied, vx_p, vmf_p) -> float:
    """How far one orbital's AC quasiparticle energy moves when its
    Sigma_c(iw') changes by QP_SENS_REL of its largest entry (seeded random
    +-1 patterns on the real and imaginary parts; the largest move over
    QP_SENS_SEEDS): the conditioning of the Thiele continuation and the QP
    solve. Deep and high-lying levels, far from the Fermi level along the
    real axis, can amplify a round-off change of Sigma by 1e7 and more."""
    fit = _pade_fit_points(len(omega_grid))
    sigma_p = np.asarray(sigma_p)
    q0 = _solve_qp_ac(sigma_p, omega_grid, fit, ef, e_p, occupied, vx_p, vmf_p,
                      False)[0]
    scale = QP_SENS_REL * np.abs(sigma_p).max()
    out = 0.0
    for seed in QP_SENS_SEEDS:
        sgn = np.random.default_rng(seed).choice([-1.0, 1.0], size=(2, len(sigma_p)))
        q = _solve_qp_ac(sigma_p + scale * (sgn[0] + 1j * sgn[1]), omega_grid, fit, ef,
                         e_p, occupied, vx_p, vmf_p, False)[0]
        out = max(out, abs(q - q0))
    return out


def qp_sensitivities(out, evgw: bool = False):
    """:func:`qp_sensitivity` of every level of an AC result (GWResult,
    KGWResult or UGWResult, from their ``sigma_iw``; a k-point result over
    every k-point and orbital): an array shaped like ``out.qp_energy`` (a
    tuple of two for UGW), zero outside ``orbs``.
    ``evgw``: the result of :func:`evgw_gamma` (G and W on its QP levels)."""
    def levels(e, nocc, ef, sigma, vx, vmf, orbs):
        s = np.zeros(e.shape)
        for io, p in enumerate(orbs):
            s[p] = qp_sensitivity(sigma[io], out.omega_grid, ef, e[p], p < nocc, vx[p],
                                  vmf[p])
        return s

    if isinstance(out.qp_energy, tuple):                      # UGW
        es, nos = out.mo_energy, out.nocc
        homo = max(e[..., n - 1].max() for e, n in zip(es, nos) if n)
        ef = 0.5 * (homo + min(e[..., n].min() for e, n in zip(es, nos)))
        if es[0].ndim == 2:
            return tuple(np.stack([levels(es[s][k], nos[s], ef, out.sigma_iw[s][k],
                                          out.sigma_x[s][k], out.v_mf[s][k],
                                          np.arange(es[s].shape[1]))
                                   for k in range(es[s].shape[0])]) for s in range(2))
        return tuple(levels(es[s], nos[s], ef, out.sigma_iw[s], out.sigma_x[s],
                            out.v_mf[s], np.arange(es[s].shape[0])) for s in range(2))
    e, n = np.asarray(out.mo_energy), out.nocc
    if e.ndim == 2:                                           # k-point
        ef = 0.5 * (e[:, n - 1].max() + e[:, n].min())
        return np.stack([levels(e[k], n, ef, out.sigma_iw[k], out.sigma_x[k], out.v_mf[k],
                                np.arange(e.shape[1])) for k in range(e.shape[0])])
    g = out.qp_energy if evgw else e
    return levels(e, n, 0.5 * (g[n - 1] + g[n]), out.sigma_iw, out.sigma_x, out.v_mf,
                  out.orbs)


def qp_bars(out, evgw: bool = False):
    """Per-level bars for comparing two AC results' QP energies: QP_BAR
    plus ten times each level's :func:`qp_sensitivities`, shaped like
    ``out.qp_energy``. Two runs whose Sigma(iw') agree to round-off can part
    by more than QP_BAR on a level whose continuation amplifies it."""
    sens = qp_sensitivities(out, evgw=evgw)
    if isinstance(sens, tuple):
        return tuple(QP_BAR + 10.0 * x for x in sens)
    return QP_BAR + 10.0 * sens


# ------------------------------------------------------------------
# driver

@dataclass
class GWResult:
    qp_energy: np.ndarray        # (nmo,) QP energies (orbs others = KS)
    mo_energy: np.ndarray        # KS eigenvalues
    sigma_x: np.ndarray          # diagonal <p| -0.5 K |p>
    v_mf: np.ndarray             # diagonal <p| veff - vj |p>
    converged: bool
    orbs: np.ndarray
    nocc: int
    qp_weight: np.ndarray | None = None  # Z_p = 1/(1 - dSigma/dw) at
    #                                      the QP pole (NaN outside orbs)
    sigma_iw: np.ndarray | None = None   # (norb, nw_sigma) Sigma_c(iw') of orbs
    omega_grid: np.ndarray | None = None  # (nw_sigma,) its w' grid


def _xcspec(xc):
    """XCSpec of ``xc``, None for Hartree-Fock (None or 'hf')."""
    spec = XCSpec(xc) if xc is not None else None
    return None if spec is not None and spec.family == "hf" else spec


def _mo_diag(C, V):
    """diag(C^H V C) as a host float64 array."""
    return to_host(torch.einsum("ip,ij,jp->p", C.conj(), V, C).real)


def _mf_potentials(system, res, xc: Optional[str]):
    """Diagonal MO matrix elements of v_mf = veff - vj and of the HF
    exchange on the SCF density (scf/hf.py Fock conventions), host
    float64 arrays; the matrices are built on the system's device."""
    from pyscf_isdf_tpu_torch.ops import coulomb

    aoR = system.aoR
    dev = aoR.device
    mesh, weight = system.mesh, system.weight
    dm = _on(res["dm"], dev)
    C = _on(res["mo_coeff"], dev)
    S = system.S
    SdS = S @ dm @ S
    vk = fftdf.get_k(aoR, dm, system.coulG, mesh, weight)
    vx_ao = -0.5 * (vk + system.madelung * SdS)

    spec = _xcspec(xc)
    if spec is None:
        v_mf_ao = vx_ao                 # HF: v_mf IS the exchange
    else:
        ao_grad = None
        if spec.family in ("gga", "mgga"):
            ao_grad = ao_gradient_fft(aoR, mesh, system.Gv)
        if spec.family == "mgga":
            _, vxc, _ = _vxc_mgga(aoR, ao_grad, dm, weight, spec)
        elif spec.family == "gga":
            _, vxc, _ = _vxc_gga(aoR, ao_grad, dm, weight, spec)
        else:
            _, vxc, _ = _vxc_lda(aoR, dm, weight, spec)
        v_mf_ao = vxc
        if spec.omega != 0.0:
            # RSH (reference pbc/dft/rks.py:108-121): the mean field's
            # exchange is hyb K_full + (alpha - hyb) K_LR(omega), each part
            # with its own probe-charge Madelung constant; Sigma_x stays the
            # full-range vx_ao
            coulG_lr = torch.as_tensor(coulomb.get_coulG(
                system.cell, exxdiv=None, omega=spec.omega), dtype=aoR.dtype,
                device=dev)
            vk_lr = fftdf.get_k(aoR, dm, coulG_lr, mesh, weight)
            mad_lr = coulomb.madelung_omega(system.cell, None, spec.omega)
            vx_lr = -0.5 * (vk_lr + mad_lr * SdS)
            v_mf_ao = v_mf_ao + spec.hyb * vx_ao + (spec.alpha - spec.hyb) * vx_lr
        elif spec.hyb > 0:
            v_mf_ao = v_mf_ao + spec.hyb * vx_ao
    return _mo_diag(C, vx_ao), _mo_diag(C, v_mf_ao)


def build_lmo(system, mo_coeff, beta: float = 2.0, l_extra: int = 2,
              g=None, timer=None):
    """Whitened Gamma-point DF tensor in the MO basis on the system's
    device: (ia|jb) = sum_P Lmo[P,i,a] Lmo[P,j,b] (df/gdf.py grid build).

    Pass a prebuilt ``g`` (GDF) to share the cell-only AO-basis fit
    across several MO transforms (the spin channels of ugw/urpa).
    ``timer`` records the GDF build's stages and 'lmo' (the transform)."""
    from pyscf_isdf_tpu_torch.df import gdf as gdf_mod

    timer = timer or null_timer
    if g is None:
        g = gdf_mod.build_gdf(system.cell, system.aoR, system.coulG,
                              system.mesh, system.weight, beta=beta,
                              l_extra=l_extra, timer=timer)
    with timer("lmo"):
        C = _on(mo_coeff, g.cderi.device, g.cderi.dtype)
        return torch.matmul(C.T, g.cderi @ C)


def gw_ac_gamma(system, res, xc: Optional[str] = None, nw: int = 100,
                orbs=None, linearized: bool = False, Lmo=None,
                eta: float = 1e-6, mo_energy_gw=None, device=None,
                timer=None) -> GWResult:
    """G0W0-AC on a converged Gamma-point SCF result dict.

    Args:
        system: SCFSystem (scf/hf.py) on ``device`` (default: the GPU).
        res: scf_kernel result dict (mo_energy/mo_coeff/dm).
        xc: the functional the SCF ran with (None = HF) — sets v_mf.
        Lmo: optional precomputed (naux, nmo, nmo) MO DF tensor (tests
            pass the same tensor to the exact oracle to cancel DF error).
        mo_energy_gw: optional eigenvalues used inside G and W (the evGW
            feedback); the QP equation always uses the mean-field
            res["mo_energy"] as its reference.
        timer: optional StageTimer: 'mf' (the mean-field potentials), the
            GDF stages and 'lmo', then per chunk 'pi', 'factor', 'w',
            'sigma', and 'pade_newton' (the host fits and QP solves).
    Sigma_c is evaluated only for ``orbs``.
    """
    require_device(system.aoR, device)
    timer = timer or null_timer
    mo_energy = _host(res["mo_energy"]).astype(np.float64)
    e_gw = (mo_energy if mo_energy_gw is None
            else np.asarray(mo_energy_gw, dtype=np.float64))
    nmo = mo_energy.shape[0]
    nocc = system.nelec // 2
    orbs = np.arange(nmo) if orbs is None else np.asarray(orbs)

    if e_gw[nocc] - e_gw[nocc - 1] < 1e-3:
        raise ValueError("GW-AC does not support metallic (gapless) "
                         "references (same posture as krgw_ac.py:221)")
    ef = 0.5 * (e_gw[nocc - 1] + e_gw[nocc])

    with timer("mf"):
        vx_mo, v_mf_mo = _mf_potentials(system, res, xc)
    if Lmo is None:
        Lmo = build_lmo(system, res["mo_coeff"], timer=timer)

    freqs, wts = scaled_legendre(nw)
    omega_grid = sigma_grid(freqs)
    sigma = to_host(_sigma_iw_batched(Lmo, e_gw, nocc, freqs, wts, omega_grid,
                                      ef, orbs=orbs, timer=timer))

    fit = _pade_fit_points(len(omega_grid))
    qp = mo_energy.copy()
    zfac = np.full(nmo, np.nan)
    conv = True
    with timer("pade_newton"):
        for j, p in enumerate(orbs):
            qp[p], zfac[p], ok = _solve_qp_ac(
                sigma[j], omega_grid, fit, ef, mo_energy[p], p < nocc, vx_mo[p],
                v_mf_mo[p], linearized)
            conv = conv and ok
    return GWResult(qp_energy=qp, mo_energy=mo_energy, sigma_x=vx_mo,
                    v_mf=v_mf_mo, converged=conv, orbs=orbs, nocc=nocc,
                    qp_weight=zfac, sigma_iw=sigma, omega_grid=omega_grid)


def evgw_gamma(system, res, xc: Optional[str] = None, nw: int = 100,
               orbs=None, max_iter: int = 10, conv_tol: float = 1e-5,
               Lmo=None, verbose: bool = False, device=None):
    """Eigenvalue-self-consistent GW (evGW): iterate G0W0 with the
    quasiparticle eigenvalues fed back into both G and W (orbitals and
    v_mf frozen at the mean-field level) until the QP energies are
    stationary."""
    require_device(system.aoR, device)
    if Lmo is None:
        Lmo = build_lmo(system, res["mo_coeff"])
    last = _host(res["mo_energy"]).astype(np.float64).copy()
    e_gw = last.copy()
    out = None
    for it in range(max_iter):
        out = gw_ac_gamma(system, res, xc=xc, nw=nw, orbs=orbs, Lmo=Lmo,
                          mo_energy_gw=e_gw, device=device)
        delta = np.abs(out.qp_energy - last).max()
        if verbose:
            print(f"evGW iter {it}: max|dQP| = {delta:.2e}")
        last = out.qp_energy.copy()
        e_gw = out.qp_energy
        if delta < conv_tol:
            break
    # report against the original mean-field eigenvalues
    return GWResult(qp_energy=out.qp_energy,
                    mo_energy=_host(res["mo_energy"]).astype(np.float64),
                    sigma_x=out.sigma_x, v_mf=out.v_mf,
                    converged=out.converged and delta < conv_tol,
                    orbs=out.orbs, nocc=out.nocc, qp_weight=out.qp_weight,
                    sigma_iw=out.sigma_iw, omega_grid=out.omega_grid)


# ------------------------------------------------------------------
# RPA correlation energy (reference pyscf/gw/rpa.py capability)

def _rpa_integrand(Lov, eia, freqs, scale, timer=None):
    """tr[ln(1 - Pi(iw)) + Pi(iw)] at every node, host (nw,): the
    log-determinant from the Cholesky factor (2 sum ln diag R) and the
    trace of Pi from the column norms, tr Pi = scale sum_x f_x |Lov_x|^2."""
    timer = timer or null_timer
    freqs_t = _on(freqs, Lov.device)
    colsq = (Lov.abs() ** 2).sum(0).to(torch.float64)
    out = torch.empty(len(freqs), dtype=torch.float64, device=Lov.device)
    nc = freq_chunk(len(freqs), Lov.shape[0], 0, Lov.element_size())
    for w0 in range(0, len(freqs), nc):
        fw = freqs_t[w0:w0 + nc]
        with timer("pi"):
            M = _one_minus(_polarizability(Lov, eia, -fw ** 2, scale))
        with timer("factor"):
            R = torch.linalg.cholesky(M)
            del M
            logdet = 2.0 * torch.log(R.diagonal(dim1=-2, dim2=-1).real).sum(-1)
        f = eia[None, :] / (eia[None, :] ** 2 + fw[:, None] ** 2)
        out[w0:w0 + nc] = logdet + scale * (f @ colsq)
    return to_host(out)


def rpa_ecorr_gamma(system, res, nw: int = 100, Lmo=None, device=None,
                    timer=None) -> float:
    """Direct-RPA correlation energy by imaginary-frequency quadrature:

        Ec = 1/(2 pi) int_0^inf dw  tr[ ln(1 - Pi(iw)) + Pi(iw) ]

    with Pi the same symmetrized polarizability as the GW kernel, the
    log-determinant from its Cholesky factor (the same trace as the
    reference's eigvalsh form)."""
    require_device(system.aoR, device)
    mo_energy = _host(res["mo_energy"]).astype(np.float64)
    nocc = system.nelec // 2
    if Lmo is None:
        Lmo = build_lmo(system, res["mo_coeff"], timer=timer)
    naux = Lmo.shape[0]
    e = _on(mo_energy, Lmo.device)
    eia = (e[:nocc, None] - e[None, nocc:]).reshape(-1)
    Lov = Lmo[:, :nocc, nocc:].reshape(naux, -1)
    freqs, wts = scaled_legendre(nw)
    integrand = _rpa_integrand(Lov, eia, freqs, 4.0, timer)
    return float(np.sum(wts * integrand) / (2.0 * np.pi))

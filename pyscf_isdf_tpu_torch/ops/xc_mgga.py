"""meta-GGA exchange-correlation functionals (SCAN, TPSS, r2SCAN) in torch,
closed-shell and spin-polarised.

Energy densities are transcribed from the published papers, as in the
reference package; potentials (vrho, vsigma, vtau) come from autograd of
f = rho * exc (:meth:`pyscf_isdf_tpu_torch.ops.xc.XCSpec.exc_vxc_mgga`,
``exc_vxc_mgga_spin``).

  SCAN: Sun, Ruzsinszky, Perdew, PRL 115, 036402 (2015) + SI.
  TPSS: Tao, Perdew, Staroverov, Scuseria, PRL 91, 146401 (2003).
  r2SCAN: Furness, Kaplan, Ning, Perdew, Sun, JPCL 11, 8208 (2020)
          (+ erratum JPCL 11, 9248).

Conventions: rho (density), sigma = |grad rho|^2, tau = 1/2 sum_occ
|grad psi|^2. All inputs are clamped away from zero; the alpha -> 1
essential singularity of the SCAN interpolation and the alpha = 2.5 switch
of r2SCAN's are routed through guards that keep the branch not taken
finite, so its gradient stays finite too. The spin-polarised forms
(``exc_*_spin``) take (na, nb, sigma_aa, sigma_ab, sigma_bb, tau_a, tau_b):
exchange by spin scaling, Ex[na, nb] = (Ex[2 na] + Ex[2 nb]) / 2,
correlation from the total density and its polarisation.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.ops.xc import (
    _TINY, _clip, _ec_pbe_spin, _ec_pw92_spin, _max, _min,
)

_C3 = (3.0 * np.pi**2) ** (2.0 / 3.0)


def _sva(rho, sigma, tau):
    """Common meta-GGA variables: s^2, alpha, tau_w/tau (restricted)."""
    rho = _max(rho, _TINY)
    sigma = _max(sigma, _TINY)
    tau = _max(tau, _TINY)
    s2 = sigma / (4.0 * _C3 * rho ** (8.0 / 3.0))
    tau_w = sigma / (8.0 * rho)
    tau_unif = 0.3 * _C3 * rho ** (5.0 / 3.0)
    alpha = _max((tau - tau_w) / tau_unif, 0.0)
    z = _clip(tau_w / tau, 0.0, 1.0)
    return s2, alpha, z


def _interp_f(alpha, c1, c2, d):
    """SCAN's switching function
    f(alpha) = exp(-c1 a/(1-a)) [a<1]  -  d exp(c2/(1-a)) [a>1]."""
    am1 = alpha - 1.0
    lo = torch.where(am1 < -1e-12, am1, -1e-12)      # alpha < 1 branch
    hi = torch.where(am1 > 1e-12, am1, 1e-12)        # alpha > 1 branch
    f_lo = torch.exp(-c1 * alpha / (-lo))
    f_hi = -d * torch.exp(-c2 / hi)
    return torch.where(am1 < 0.0, f_lo, torch.where(am1 > 0.0, f_hi, 0.0))


# ------------------------------------------------------------------ SCAN
_K1 = 0.065
_MUAK = 10.0 / 81.0
_B2 = np.sqrt(5913.0 / 405000.0)
_B1 = (511.0 / 13500.0) / (2.0 * _B2)
_B3 = 0.5
_B4 = _MUAK**2 / _K1 - 1606.0 / 18225.0 - _B1**2
_A1 = 4.9479
_H0X = 1.174
_C1X, _C2X, _DX = 0.667, 0.8, 1.24
_C1C, _C2C, _DC = 0.64, 1.5, 0.7
_B1C, _B2C, _B3C = 0.0285764, 0.0889, 0.125541
_GAMMA = 0.031091
_CHI_INF = 0.128026


def _scan_fx(s2, alpha):
    """SCAN exchange enhancement Fx(s, alpha)."""
    x = _MUAK * s2 * (1.0 + (_B4 * s2 / _MUAK)
                      * torch.exp(-abs(_B4) * s2 / _MUAK)) \
        + (_B1 * s2 + _B2 * (1.0 - alpha)
           * torch.exp(-_B3 * (1.0 - alpha) ** 2)) ** 2
    h1x = 1.0 + _K1 - _K1 / (1.0 + x / _K1)
    s = torch.sqrt(_max(s2, _TINY))
    gx = 1.0 - torch.exp(-_A1 / torch.sqrt(s))
    fx = _interp_f(alpha, _C1X, _C2X, _DX)
    return (h1x + fx * (_H0X - h1x)) * gx


def _ex_scan(rho, sigma, tau):
    """SCAN exchange energy per particle (spin-restricted input)."""
    rho = _max(rho, _TINY)
    s2, alpha, _ = _sva(rho, sigma, tau)
    ex_unif = -0.75 * (3.0 / np.pi) ** (1.0 / 3.0) * rho ** (1.0 / 3.0)
    return ex_unif * _scan_fx(s2, alpha)


def _beta_rs(rs):
    return 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)


def _ec_lda0_gc(rs, zeta):
    """SCAN's single-orbital LDA correlation and its zeta factor gc."""
    ec_lda0 = -_B1C / (1.0 + _B2C * torch.sqrt(rs) + _B3C * rs)
    dx_z = 0.5 * ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0))
    gc = (1.0 - 2.3631 * (dx_z - 1.0)) * (1.0 - zeta**12)
    return ec_lda0, gc


def _scan_ec_spin(rho, zeta, sigma, tau):
    """SCAN correlation energy per particle of the total density
    (rho, sigma, tau totals; zeta the polarisation)."""
    rho = _max(rho, _TINY)
    sigma = _max(sigma, _TINY)
    tau = _max(tau, _TINY)
    zeta = _clip(zeta, -1.0 + 1e-12, 1.0 - 1e-12)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    s2 = sigma / (4.0 * _C3 * rho ** (8.0 / 3.0))
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    d_z = 0.5 * ((1.0 + zeta) ** (5.0 / 3.0) + (1.0 - zeta) ** (5.0 / 3.0))
    tau_w = sigma / (8.0 * rho)
    tau_unif = 0.3 * _C3 * rho ** (5.0 / 3.0) * d_z
    alpha = _max((tau - tau_w) / tau_unif, 0.0)

    # ec1: PW92 + gradient correction H1
    eps_lsda = _ec_pw92_spin(rho, zeta)
    t2 = (3.0 * np.pi**2 / 16.0) ** (2.0 / 3.0) * s2 / (phi**2 * rs)
    w1 = torch.expm1(-eps_lsda / (_GAMMA * phi**3))
    beta = _beta_rs(rs)
    y = beta / (_GAMMA * _max(w1, _TINY)) * t2
    g_y = (1.0 + 4.0 * y) ** (-0.25)
    h1 = _GAMMA * phi**3 * torch.log1p(w1 * (1.0 - g_y))
    ec1 = eps_lsda + h1

    # ec0: single-orbital / low-density limit
    ec_lda0, gc = _ec_lda0_gc(rs, zeta)
    w0 = torch.expm1(-ec_lda0 / _B1C)
    ginf = (1.0 + 4.0 * _CHI_INF * s2) ** (-0.25)
    h0 = _B1C * torch.log1p(w0 * (1.0 - ginf))
    ec0 = (ec_lda0 + h0) * gc

    fc = _interp_f(alpha, _C1C, _C2C, _DC)
    return ec1 + fc * (ec0 - ec1)


def exc_scan(rho, sigma, tau):
    """Restricted SCAN exc per particle."""
    return _ex_scan(rho, sigma, tau) + _scan_ec_spin(rho, 0.0, sigma, tau)


def _ex_spin_scaled(ex_fn, ra, rb, saa, sbb, ta, tb, rho):
    """Spin-scaled meta-GGA exchange per particle of ``rho``."""
    return 0.5 * (ex_fn(2 * ra, 4 * saa, 2 * ta) * 2 * ra
                  + ex_fn(2 * rb, 4 * sbb, 2 * tb) * 2 * rb) / rho


def exc_scan_spin(ra, rb, saa, sab, sbb, ta, tb):
    """Spin-polarised SCAN exc per particle of the total density."""
    rho = ra + rb + _TINY
    return _ex_spin_scaled(_ex_scan, ra, rb, saa, sbb, ta, tb, rho) \
        + _scan_ec_spin(rho, (ra - rb) / rho, saa + 2.0 * sab + sbb, ta + tb)


# ------------------------------------------------------------------ TPSS
_KAPPA = 0.804
_CT = 1.59096
_ET = 1.537
_MUT = 0.21951
_BT = 0.40
_DT = 2.8


def _tpss_fx(p, z):
    """TPSS exchange enhancement Fx(p = s^2, z = tau_w/tau)."""
    z = _clip(z, _TINY, 1.0 - 1e-12)
    alpha = (5.0 * p / 3.0) * (1.0 / z - 1.0)
    am1 = alpha - 1.0
    qb = 0.45 * am1 / torch.sqrt(1.0 + _BT * alpha * am1) + 2.0 * p / 3.0
    zt = 0.6 * z                          # (3/5) z
    x = ((10.0 / 81.0 + _CT * z**2 / (1.0 + z**2) ** 2) * p
         + 146.0 / 2025.0 * qb**2
         - 73.0 / 405.0 * qb * torch.sqrt(0.5 * zt**2 + 0.5 * p**2)
         + (1.0 / _KAPPA) * (10.0 / 81.0) ** 2 * p**2
         + 2.0 * np.sqrt(_ET) * (10.0 / 81.0) * zt**2
         + _ET * _MUT * p**3) / (1.0 + np.sqrt(_ET) * p) ** 2
    return 1.0 + _KAPPA - _KAPPA / (1.0 + x / _KAPPA)


def _ex_tpss(rho, sigma, tau):
    rho = _max(rho, _TINY)
    s2, _, z = _sva(rho, sigma, tau)
    ex_unif = -0.75 * (3.0 / np.pi) ** (1.0 / 3.0) * rho ** (1.0 / 3.0)
    return ex_unif * _tpss_fx(s2, z)


def _tpss_ec_spin(ra, rb, saa, sab, sbb, ta, tb):
    """TPSS correlation per particle (revPKZB + self-correlation fix)."""
    rho = ra + rb + _TINY
    zeta = _clip((ra - rb) / rho, -1.0 + 1e-12, 1.0 - 1e-12)
    sigma = _max(saa + 2.0 * sab + sbb, _TINY)
    tau = _max(ta + tb, _TINY)
    z = _clip(sigma / (8.0 * rho) / tau, 0.0, 1.0)   # tau_w / tau

    # grad-zeta^2 from the sigma invariants
    dnm2 = _max(saa - 2.0 * sab + sbb, 0.0)          # |grad(na-nb)|^2
    cross = saa - sbb                                # grad(na-nb).grad n
    gz2 = _max((dnm2 - 2.0 * zeta * cross + zeta**2 * sigma) / rho**2, 0.0)
    # only xi^2 enters C(zeta, xi): kept squared (sqrt at 0 has an
    # infinite slope that would make vrho/vsigma NaN at zeta = 0)
    xi2 = gz2 / (4.0 * (3.0 * np.pi**2 * rho) ** (2.0 / 3.0))

    c_z0 = 0.53 + 0.87 * zeta**2 + 0.50 * zeta**4 + 2.26 * zeta**6
    denom = 1.0 + xi2 * 0.5 * ((1.0 + zeta) ** (-4.0 / 3.0)
                               + (1.0 - zeta) ** (-4.0 / 3.0))
    c_zxi = c_z0 / denom**4

    ec_pbe_t = _ec_pbe_spin(rho, zeta, sigma)
    # per-spin fully polarised PBE correlation, floored at the total
    # (the max[...] of the revPKZB definition)
    ec_a = torch.maximum(_ec_pbe_spin(_max(ra, _TINY), 1.0 - 1e-12,
                                      _max(saa, _TINY)), ec_pbe_t)
    ec_b = torch.maximum(_ec_pbe_spin(_max(rb, _TINY), 1.0 - 1e-12,
                                      _max(sbb, _TINY)), ec_pbe_t)
    ec_pkzb = ec_pbe_t * (1.0 + c_zxi * z**2) \
        - (1.0 + c_zxi) * z**2 * (ra * ec_a + rb * ec_b) / rho
    return ec_pkzb * (1.0 + _DT * ec_pkzb * z**3)


def exc_tpss(rho, sigma, tau):
    """Restricted TPSS exc per particle."""
    r2 = rho / 2.0
    return _ex_tpss(rho, sigma, tau) \
        + _tpss_ec_spin(r2, r2, sigma / 4, sigma / 4, sigma / 4,
                        tau / 2, tau / 2)


def exc_tpss_spin(ra, rb, saa, sab, sbb, ta, tb):
    """Spin-polarised TPSS exc per particle of the total density."""
    rho = ra + rb + _TINY
    return _ex_spin_scaled(_ex_tpss, ra, rb, saa, sbb, ta, tb, rho) \
        + _tpss_ec_spin(ra, rb, saa, sab, sbb, ta, tb)


# ---------------------------------------------------------------- r2SCAN
# SCAN with the regularised interpolation and the restored second-order
# gradient expansion (GE2). The derived constants are re-derived at import
# from the construction rules, as the reference does:
#   * the 7th-order interpolation polynomials solve the 8-condition
#     smoothness system {f(0)/f'(0)/f''(0) Taylor-match SCAN's
#     exp(-c1 a/(1-a)); f(1)=0; value..3rd derivative match of the
#     -d exp(c2/(1-a)) branch at a=2.5} with SCAN's own (c1, c2, d);
#   * C2x = k0 * fx'(1) and C2c = fc'(1) are the GE2-cancellation
#     conditions;
#   * C_eta = 20/27 + 5 eta/3 is the slowly varying slope of alpha-bar.
_ETA = 0.001
_CETA = 20.0 / 27.0 + 5.0 * _ETA / 3.0
_DP2 = 0.361
_K0 = 0.174            # == _H0X - 1


def _r2_poly(c1, c2, d):
    """Interpolation-polynomial coefficients from the smoothness
    conditions (numpy float64, solved once at import)."""
    A = np.zeros((8, 8))
    b = np.zeros(8)

    def rows(x):
        out = []
        for k in range(4):
            r = np.zeros(8)
            for i in range(k, 8):
                fac = 1.0
                for j in range(k):
                    fac *= i - j
                r[i] = fac * x ** (i - k)
            out.append(r)
        return out

    r0, r1, r25 = rows(0.0), rows(1.0), rows(2.5)
    # Taylor of exp(-c1 a/(1-a)) at a=0: 1 - c1 a + (c1^2/2 - c1) a^2
    A[0], b[0] = r0[0], 1.0
    A[1], b[1] = r0[1], -c1
    A[2], b[2] = r0[2], c1 * c1 - 2.0 * c1
    A[3], b[3] = r1[0], 0.0
    # value..3rd derivative of g(a) = -d exp(c2/(1-a)) at a=2.5
    u = 1.0 - 2.5
    e = -d * np.exp(c2 / u)
    g1 = e * c2 / u**2
    g2 = e * (c2**2 / u**4 + 2.0 * c2 / u**3)
    g3 = e * (c2**3 / u**6 + 6.0 * c2**2 / u**5 + 6.0 * c2 / u**4)
    for k, gk in enumerate((e, g1, g2, g3)):
        A[4 + k], b[4 + k] = r25[k], gk
    return np.linalg.solve(A, b)


_CX_POLY = _r2_poly(_C1X, _C2X, _DX)
_CC_POLY = _r2_poly(_C1C, _C2C, _DC)
_C2X_R2 = _K0 * float((np.arange(8) * _CX_POLY).sum())      # -0.162742
_C2C_R2 = float((np.arange(8) * _CC_POLY).sum())            # -0.711402


def _interp_r2(alpha, coeffs, c2, d):
    """r2SCAN interpolation: 7th-order polynomial on [0, 2.5], the SCAN
    negative-exponential branch beyond."""
    a_p = _min(alpha, 2.5)
    poly = coeffs[7]
    for i in range(6, -1, -1):
        poly = poly * a_p + coeffs[i]
    a_e = _max(alpha, 2.5)
    f_hi = -d * torch.exp(-c2 / (a_e - 1.0))
    return torch.where(alpha <= 2.5, poly, f_hi)


def _r2scan_fx(p, alpha):
    """r2SCAN exchange enhancement Fx(p = s^2, alpha-bar)."""
    damp = torch.exp(-p * p / _DP2**4)
    x = (_CETA * _C2X_R2 * damp + _MUAK) * p
    h1x = 1.0 + _K1 - _K1 / (1.0 + x / _K1)
    gx = 1.0 - torch.exp(-_A1 * _max(p, _TINY) ** (-0.25))
    fx = _interp_r2(alpha, _CX_POLY, _C2X, _DX)
    return (h1x + fx * (_H0X - h1x)) * gx


def _ex_r2scan(rho, sigma, tau):
    """r2SCAN exchange per particle (spin-restricted input)."""
    rho = _max(rho, _TINY)
    sigma = _max(sigma, _TINY)
    tau = _max(tau, _TINY)
    p = sigma / (4.0 * _C3 * rho ** (8.0 / 3.0))
    tau_w = sigma / (8.0 * rho)
    tau_u = 0.3 * _C3 * rho ** (5.0 / 3.0)
    alpha = _max((tau - tau_w) / (tau_u + _ETA * tau_w), 0.0)
    ex_unif = -0.75 * (3.0 / np.pi) ** (1.0 / 3.0) * rho ** (1.0 / 3.0)
    return ex_unif * _r2scan_fx(p, alpha)


def _r2scan_w_fn(rho, zeta):
    """W(rs, zeta) = ec0(p=0) - ec1(p=0): the alpha-interpolation gap of
    the two correlation limits at zero gradient (enters Delta-y)."""
    rs = (3.0 / (4.0 * np.pi * _max(rho, _TINY))) ** (1.0 / 3.0)
    ec_lda0, gc = _ec_lda0_gc(rs, zeta)
    return ec_lda0 * gc - _ec_pw92_spin(rho, zeta)


def _w_and_slope(rho, zeta):
    """W(rho) and dW/drho, the latter by autograd kept differentiable
    (the reference's forward-mode jvp), so the potentials see its rho
    dependence too."""
    needs_grad = rho.requires_grad
    with torch.enable_grad():
        r = rho if needs_grad else rho.detach().requires_grad_(True)
        W = _r2scan_w_fn(r, zeta)
        (dW,) = torch.autograd.grad(W.sum(), r, create_graph=needs_grad)
    return (W, dW) if needs_grad else (W.detach(), dW)


def _r2scan_ec_spin(rho, zeta, sigma, tau):
    """r2SCAN correlation per particle of the total density."""
    rho = _max(rho, _TINY)
    sigma = _max(sigma, _TINY)
    tau = _max(tau, _TINY)
    zeta = _clip(zeta, -1.0 + 1e-12, 1.0 - 1e-12)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    p = sigma / (4.0 * _C3 * rho ** (8.0 / 3.0))
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    d_z = 0.5 * ((1.0 + zeta) ** (5.0 / 3.0) + (1.0 - zeta) ** (5.0 / 3.0))
    tau_w = sigma / (8.0 * rho)
    tau_u = 0.3 * _C3 * rho ** (5.0 / 3.0) * d_z
    alpha = _max((tau - tau_w) / (tau_u + _ETA * tau_w), 0.0)

    # ec1: PW92 + H1 with the GE2-restoring Delta-y shift
    eps_lsda = _ec_pw92_spin(rho, zeta)
    t2 = (3.0 * np.pi**2 / 16.0) ** (2.0 / 3.0) * p / (phi**2 * rs)
    w1 = _max(torch.expm1(-eps_lsda / (_GAMMA * phi**3)), _TINY)
    beta = _beta_rs(rs)
    y = beta / (_GAMMA * w1) * t2
    # Delta-y cancels the second-order contribution of fc(alpha)(ec0-ec1)
    # under the energy integral; rs d/drs == -3 rho d/drho
    W, dW_drho = _w_and_slope(rho, zeta)
    rs_dW = -3.0 * rho * dW_drho
    damp = torch.exp(-p * p / _DP2**4)
    dy = (_C2C_R2 / (27.0 * _GAMMA * d_z * phi**3 * w1)
          * (20.0 * rs_dW - 45.0 * _ETA * W) * p * damp)
    g_y = _max(1.0 + 4.0 * (y - dy), _TINY) ** (-0.25)
    h1 = _GAMMA * phi**3 * torch.log1p(w1 * (1.0 - g_y))
    ec1 = eps_lsda + h1

    # ec0: single-orbital / low-density limit (as SCAN)
    ec_lda0, gc = _ec_lda0_gc(rs, zeta)
    w0 = torch.expm1(-ec_lda0 / _B1C)
    ginf = (1.0 + 4.0 * _CHI_INF * p) ** (-0.25)
    h0 = _B1C * torch.log1p(w0 * (1.0 - ginf))
    ec0 = (ec_lda0 + h0) * gc

    fc = _interp_r2(alpha, _CC_POLY, _C2C, _DC)
    return ec1 + fc * (ec0 - ec1)


def exc_r2scan(rho, sigma, tau):
    """Restricted r2SCAN exc per particle."""
    return _ex_r2scan(rho, sigma, tau) + _r2scan_ec_spin(rho, 0.0, sigma, tau)


def exc_r2scan_spin(ra, rb, saa, sab, sbb, ta, tb):
    """Spin-polarised r2SCAN exc per particle of the total density."""
    rho = ra + rb + _TINY
    return _ex_spin_scaled(_ex_r2scan, ra, rb, saa, sbb, ta, tb, rho) \
        + _r2scan_ec_spin(rho, (ra - rb) / rho, saa + 2.0 * sab + sbb, ta + tb)

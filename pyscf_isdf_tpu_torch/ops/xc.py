"""Exchange-correlation functionals in torch (closed-shell).

Implements, at formula level, the closed-shell functionals of the
reference package:

  * LDA exchange (Slater/Dirac), VWN5 and VWN-RPA correlation,
  * PBE and PBEsol exchange + correlation, PBE0,
  * B88 exchange and LYP correlation (BLYP, B3LYP, B3LYP5),
  * HSE06: PBE with a quarter of the short-range (erfc-screened) PBE
    exchange replaced by exact short-range exchange,
  * the meta-GGAs SCAN, TPSS and r2SCAN (:mod:`.xc_mgga`),
  * 'hf' (no density functional, full exact exchange).

Energy densities are written once; potentials (vrho, vsigma, vtau) come
from ``torch.autograd.grad`` of the energy per volume, exact derivatives
with no hand-coded potential formulas. Branch switches keep the
reference's guards (``_max``/``_min`` of both branches, series below a
threshold) so the branch not taken never feeds a NaN into a gradient,
and ``_max``/``_min`` split the gradient evenly at a tie as the
reference's ``maximum``/``minimum`` do. The spin-polarised forms are not
ported yet.
"""
from __future__ import annotations

import math

import torch

_TINY = 1e-30
_PI = math.pi


def _max(x, c: float):
    """Elementwise max(x, c); at a tie the gradient splits evenly."""
    return torch.maximum(x, torch.full_like(x, c))


def _min(x, c: float):
    """Elementwise min(x, c); at a tie the gradient splits evenly."""
    return torch.minimum(x, torch.full_like(x, c))


def _clip(x, lo: float, hi: float):
    """min(max(x, lo), hi) for tensors, the same clamp for Python floats."""
    if isinstance(x, torch.Tensor):
        return _min(_max(x, lo), hi)
    return min(max(x, lo), hi)


# ----------------------------------------------------------------- LDA pieces
def _ex_slater(rho):
    """Slater exchange energy per particle."""
    return -0.75 * (3.0 / _PI) ** (1.0 / 3) * rho ** (1.0 / 3)


_VWN5 = dict(A=0.0310907, b=3.72744, c=12.9352, x0=-0.10498)
# VWN-RPA (VWN III) parameters, the correlation B3LYP historically mixes
_VWN3 = dict(A=0.0310907, b=13.0720, c=42.7198, x0=-0.409286)


def _vwn_eps(rho, p):
    """VWN paramagnetic correlation energy per particle, parameters ``p``."""
    A, b, c, x0 = p["A"], p["b"], p["c"], p["x0"]
    rs = (3.0 / (4 * _PI * rho)) ** (1.0 / 3)
    x = torch.sqrt(rs)
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = math.sqrt(4 * c - b * b)
    atn = torch.arctan(Q / (2 * x + b))
    return A * (
        torch.log(x * x / X)
        + 2 * b / Q * atn
        - b * x0 / X0 * (torch.log((x - x0) ** 2 / X) + 2 * (b + 2 * x0) / Q * atn)
    )


def _ec_vwn5(rho):
    """VWN5 paramagnetic correlation energy per particle."""
    return _vwn_eps(rho, _VWN5)


# ------------------------------------------------------------ B88 / LYP
_B88_BETA = 0.0042
_B88_C = 1.5 * (3.0 / (4 * _PI)) ** (1.0 / 3)     # spin-channel LDA_x


def _ex_b88_channel(n, s):
    """B88 exchange energy density of one spin channel (Becke, PRA 38,
    3098 (1988)): -n^{4/3} [C + beta x^2/(1 + 6 beta x asinh x)],
    x = sqrt(s)/n^{4/3}."""
    n43 = n ** (4.0 / 3)
    x = torch.sqrt(s) / (n43 + _TINY)
    g = _B88_C + _B88_BETA * x * x / (1 + 6 * _B88_BETA * x * torch.asinh(x))
    return -n43 * g


def _ex_b88(rho, sigma):
    """Closed-shell B88 exchange per particle (spin-scaled channels)."""
    return 2.0 * _ex_b88_channel(0.5 * rho, 0.25 * sigma) / (rho + _TINY)


_LYP_A, _LYP_B, _LYP_C, _LYP_D = 0.04918, 0.132, 0.2533, 0.349
_CF = 0.3 * (3 * _PI**2) ** (2.0 / 3)


def _ec_lyp_spin(ra, rb, saa, sab, sbb):
    """LYP correlation per particle of the total density, spin-resolved
    (Lee-Yang-Parr PRB 37, 785 (1988) in the Miehlich et al.,
    CPL 157, 200 (1989) laplacian-free reformulation)."""
    a, b, c, d = _LYP_A, _LYP_B, _LYP_C, _LYP_D
    rho = ra + rb
    st = saa + 2 * sab + sbb                    # |grad rho|^2
    r13 = (rho + _TINY) ** (-1.0 / 3)
    denom = 1 + d * r13
    omega = torch.exp(-c * r13) / denom * (rho + _TINY) ** (-11.0 / 3)
    delta = c * r13 + d * r13 / denom
    e1 = -4 * a * ra * rb / (rho * denom + _TINY)
    inner = (2 ** (11.0 / 3) * _CF * (ra ** (8.0 / 3) + rb ** (8.0 / 3))
             + (47.0 / 18 - 7.0 * delta / 18) * st
             - (2.5 - delta / 18) * (saa + sbb)
             - (delta - 11.0) / 9 * (ra * saa + rb * sbb) / (rho + _TINY))
    e2 = -a * b * omega * (
        ra * rb * inner
        - 2.0 / 3 * rho**2 * st
        + (2.0 / 3 * rho**2 - ra**2) * sbb
        + (2.0 / 3 * rho**2 - rb**2) * saa)
    return (e1 + e2) / (rho + _TINY)


def _ec_lyp(rho, sigma):
    """Closed-shell LYP correlation per particle."""
    return _ec_lyp_spin(0.5 * rho, 0.5 * rho, 0.25 * sigma, 0.25 * sigma,
                        0.25 * sigma)


# ----------------------------------------------------------------- PBE pieces
def _ex_pbe(rho, sigma, mu=0.2195149727645171):
    """PBE exchange energy per particle (PRL 77, 3865). ``mu=10/81``
    (the GE2 value) gives the PBEsol exchange (PRL 100, 136406)."""
    kappa = 0.804
    kf = (3 * _PI**2 * rho) ** (1.0 / 3)
    s2 = sigma / (4 * kf**2 * rho**2 + _TINY)
    fx = 1 + kappa - kappa / (1 + mu * s2 / kappa)
    return _ex_slater(rho) * fx


def _pw92_eps(rho, A, a1, b1, b2, b3, b4):
    rs = (3.0 / (4 * _PI * rho)) ** (1.0 / 3)
    srs = torch.sqrt(rs)
    den = 2 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    return -2 * A * (1 + a1 * rs) * torch.log(1 + 1.0 / (den + _TINY))


def _ec_pw92(rho):
    """PW92 paramagnetic correlation (basis of PBE correlation)."""
    return _pw92_eps(rho, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)


def _ec_pbe(rho, sigma, beta=0.06672455060314922):
    """PBE correlation energy per particle (closed shell).
    ``beta=0.046`` (jellium-surface fit) gives PBEsol correlation."""
    gamma = 0.031090690869654895
    ec0 = _ec_pw92(rho)
    kf = (3 * _PI**2 * rho) ** (1.0 / 3)
    ks = torch.sqrt(4 * kf / _PI)
    t2 = sigma / (4 * ks**2 * rho**2 + _TINY)
    expm = torch.exp(-ec0 / gamma)
    Afac = beta / gamma / (expm - 1 + _TINY)
    num = 1 + Afac * t2
    H = gamma * torch.log(1 + beta / gamma * t2 * num / (num + Afac**2 * t2 * t2))
    return ec0 + H


# polarisation-dependent PW92/PBE correlation: the meta-GGAs evaluate it
# at zeta = 0 and, for TPSS's one-spin term, at zeta = 1 - 1e-12
def _fzeta(z):
    return (((1 + z) ** (4.0 / 3) + (1 - z) ** (4.0 / 3)) - 2) \
        / (2 * (2 ** (1.0 / 3) - 1))


_FPP0 = 4.0 / (9 * (2 ** (1.0 / 3) - 1))  # f''(0)


def _ec_pw92_spin(rho, zeta):
    ec_p = _pw92_eps(rho, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
    ec_f = _pw92_eps(rho, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
    m_ac = _pw92_eps(rho, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
    f = _fzeta(zeta)
    z4 = zeta**4
    return ec_p - m_ac * f / _FPP0 * (1 - z4) + (ec_f - ec_p) * f * z4


def _ec_pbe_spin(rho, zeta, sigma, beta=0.06672455060314922):
    """Spin-resolved PBE correlation (PRL 77, 3865 Eqs. 7-8)."""
    gamma = 0.031090690869654895
    phi = 0.5 * ((1 + zeta) ** (2.0 / 3) + (1 - zeta) ** (2.0 / 3))
    ec0 = _ec_pw92_spin(rho, zeta)
    kf = (3 * _PI**2 * rho) ** (1.0 / 3)
    ks = torch.sqrt(4 * kf / _PI)
    t2 = sigma / (4 * phi**2 * ks**2 * rho**2 + _TINY)
    expm = torch.exp(-ec0 / (gamma * phi**3))
    Afac = beta / gamma / (expm - 1 + _TINY)
    num = 1 + Afac * t2
    H = gamma * phi**3 * torch.log(
        1 + beta / gamma * t2 * num / (num + Afac**2 * t2 * t2))
    return ec0 + H


# ------------------------------------------------ range-separated exchange
def _sr_lda_factor(a):
    """Exact erfc(w r)/r attenuation of the UEG exchange energy.

    a = w / (2 kF). Closed form of the UEG exchange-hole integral against
    the short-range kernel (Gill & Adamson CPL 261, 105 (1996); used by
    the HSE construction, JCP 118, 8207 (2003)). Series expansion below
    a ~ 1e-3, where the closed form cancels; the guards keep the branch
    not taken finite so its gradient is not NaN.
    """
    a2 = a * a
    exp4 = torch.exp(-1.0 / _max(4 * a2, 1e-8))
    full = 1.0 - (8.0 / 3.0) * a * (
        math.sqrt(_PI) * torch.special.erf(1.0 / (2 * _max(a, 1e-12)))
        + (2 * a - 4 * a2 * a) * exp4
        - 3 * a + 4 * a2 * a
    )
    small = 1.0 - (8.0 / 3.0) * a * (math.sqrt(_PI) - 3 * a + 4 * a2 * a)
    return torch.where(a < 1e-3, small, full)


def _fx_pbe(s2):
    """PBE exchange enhancement factor F(s^2)."""
    kappa, mu = 0.804, 0.2195149727645171
    return 1 + kappa - kappa / (1 + mu * s2 / kappa)


def _fx_sr(s2, nu):
    """Short-range (erfc-screened) PBE exchange enhancement
    F_SR(s, nu) = F_PBE(s) f_srLDA(nu / (2 F_PBE(s))), nu = omega / kF
    (local-wavevector screening, Iikura-Tsuneda-Yanai-Hirao, JCP 115,
    3540 (2001)): F_PBE at nu -> 0, the exact UEG attenuation at s -> 0.
    """
    F = _fx_pbe(s2)
    return F * _sr_lda_factor(nu / (2.0 * F))


def _ex_wpbe_sr(rho, sigma, omega):
    """Short-range (erfc-screened) PBE exchange energy per particle."""
    kf = (3 * _PI**2 * rho) ** (1.0 / 3)
    s2 = sigma / (4 * kf**2 * rho**2 + _TINY)
    nu = omega / kf
    return _ex_slater(rho) * _fx_sr(s2, nu)


# --------------------------------------------------------------- public specs
class XCSpec:
    """Resolved functional: family ('lda'|'gga'|'mgga'|'hf'), hybrid
    exact-exchange weight ``hyb`` and the energy-per-particle function
    exc(rho[, sigma[, tau]]).

    Range separation follows the reference's (omega, alpha, hyb)
    convention (pyscf rsh_and_hybrid_coeff, pbc/dft/rks.py:108-121):

        K_eff = alpha * K_full + (hyb - alpha) * K_SR(omega)

    with alpha == hyb and omega == 0 for pure and global hybrids. For
    hse06: omega=0.11, hyb=0.25, alpha=0 (short-range exact exchange only).
    """

    def __init__(self, name: str):
        name = name.lower().replace(" ", "")
        self.name = name
        self.omega = 0.0
        if name in ("lda", "lda,vwn", "lda,vwn5", "svwn"):
            self.family = "lda"
            self.hyb = 0.0
            self._exc = lambda rho: _ex_slater(rho) + _ec_vwn5(rho)
        elif name in ("lda,", "slater"):
            self.family = "lda"
            self.hyb = 0.0
            self._exc = _ex_slater
        elif name == "pbe":
            self.family = "gga"
            self.hyb = 0.0
            self._exc = lambda rho, sigma: _ex_pbe(rho, sigma) + _ec_pbe(rho, sigma)
        elif name == "pbesol":
            # PBE for solids (Perdew et al., PRL 100, 136406): exchange mu
            # at the GE2 value 10/81, correlation beta from the
            # jellium-surface fit
            self.family = "gga"
            self.hyb = 0.0
            self._exc = lambda rho, sigma: (
                _ex_pbe(rho, sigma, mu=10.0 / 81.0)
                + _ec_pbe(rho, sigma, beta=0.046)
            )
        elif name == "pbe0":
            self.family = "gga"
            self.hyb = 0.25
            self._exc = lambda rho, sigma: (
                0.75 * _ex_pbe(rho, sigma) + _ec_pbe(rho, sigma)
            )
        elif name == "blyp":
            self.family = "gga"
            self.hyb = 0.0
            self._exc = lambda rho, sigma: _ex_b88(rho, sigma) + _ec_lyp(rho, sigma)
        elif name in ("b3lyp", "b3lyp5"):
            # Gaussian-convention B3: 0.8 LDA_x + 0.72 dB88 + 0.2 HF
            # == 0.08 LDA_x + 0.72 B88(full) + 0.2 HF; correlation
            # 0.19 VWN + 0.81 LYP with VWN-RPA ('b3lyp') or VWN5 ('b3lyp5')
            self.family = "gga"
            self.hyb = 0.2
            vwn = _VWN5 if name == "b3lyp5" else _VWN3
            self._exc = lambda rho, sigma: (
                0.08 * _ex_slater(rho) + 0.72 * _ex_b88(rho, sigma)
                + 0.19 * _vwn_eps(rho, vwn) + 0.81 * _ec_lyp(rho, sigma)
            )
        elif name == "hse06":
            # E_xc = 0.25 K_SR(w) + [E_x^PBE - 0.25 E_x^{SR-PBE}(w)] + E_c^PBE
            self.family = "gga"
            self.hyb = 0.25
            self.omega = 0.11
            w = self.omega
            self._exc = lambda rho, sigma: (
                _ex_pbe(rho, sigma) - 0.25 * _ex_wpbe_sr(rho, sigma, w)
                + _ec_pbe(rho, sigma)
            )
        elif name in ("hf", "hartree-fock"):
            self.family = "hf"
            self.hyb = 1.0
            self._exc = None
        elif name in ("scan", "tpss", "r2scan"):
            from pyscf_isdf_tpu_torch.ops import xc_mgga

            self.family = "mgga"
            self.hyb = 0.0
            self._exc = {"scan": xc_mgga.exc_scan, "tpss": xc_mgga.exc_tpss,
                         "r2scan": xc_mgga.exc_r2scan}[name]
        else:
            raise NotImplementedError(f"xc functional {name!r}")
        self.alpha = 0.0 if name == "hse06" else self.hyb

    def _grads(self, *args):
        """(exc, d(rho exc)/d arg for each arg) by autograd; every arg is
        clamped to 1e-30 first."""
        args = [torch.clamp(a, min=_TINY).detach() for a in args]
        with torch.enable_grad():
            args = [a.requires_grad_(True) for a in args]
            exc = self._exc(*args)
            grads = torch.autograd.grad((args[0] * exc).sum(), args)
        return (exc.detach(),) + tuple(grads)

    def exc_vxc(self, rho, sigma=None):
        """Energy density per particle and potentials.

        Returns (exc, vrho, vsigma) with vsigma=None for LDA; derivatives of
        f = rho * exc by autograd (elementwise, so the gradient of the sum).
        """
        if self.family == "lda":
            return self._grads(rho) + (None,)
        if self.family == "gga":
            return self._grads(rho, sigma)
        raise ValueError(f"{self.name}: exc_vxc takes an LDA or GGA functional")

    def exc_vxc_mgga(self, rho, sigma, tau):
        """meta-GGA energy density per particle and potentials
        (exc, vrho, vsigma, vtau). The Fock-matrix tau term is
        V_tau = 1/2 w sum_x grad_x ao^T (vtau grad_x ao) (the reference's
        eval_xc convention, pyscf/dft/libxc.py:1282)."""
        if self.family != "mgga":
            raise ValueError(f"{self.name} is not a meta-GGA")
        return self._grads(rho, sigma, tau)

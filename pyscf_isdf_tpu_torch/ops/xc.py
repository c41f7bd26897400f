"""Exchange-correlation functionals in torch, closed-shell and
spin-polarised.

Implements, at formula level, the functionals of the reference package:

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
reference's ``maximum``/``minimum`` do. The spin-polarised forms
(:meth:`XCSpec.exc_vxc_spin`, :meth:`XCSpec.exc_vxc_mgga_spin`) take the
spin densities and the three spin-resolved gradient invariants
sigma_aa, sigma_ab, sigma_bb; exchange follows the spin-scaling relation
Ex[na, nb] = (Ex[2 na] + Ex[2 nb]) / 2, correlation the zeta forms.
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


_VWN5_F = dict(A=0.01554535, b=7.06042, c=18.0578, x0=-0.32500)
_VWN5_A = dict(A=-1.0 / (6 * _PI**2), b=1.13107, c=13.0045, x0=-0.00475840)
# VWN-RPA ferromagnetic and spin-stiffness parameters (libxc lda_c_vwn_rpa)
_VWN3_F = dict(A=0.01554535, b=20.1231, c=101.578, x0=-0.743294)
_VWN3_A = dict(A=-1.0 / (6 * _PI**2), b=1.06835, c=11.4813, x0=-0.228344)


def _ec_vwn_spin(rho, zeta, p_para, p_ferro, p_alpha):
    """VWN correlation with the standard zeta interpolation, for a given
    (paramagnetic, ferromagnetic, spin-stiffness) parameter triple."""
    ec_p = _vwn_eps(rho, p_para)
    ec_f = _vwn_eps(rho, p_ferro)
    alpha = _vwn_eps(rho, p_alpha)
    f = _fzeta(zeta)
    z4 = zeta**4
    return ec_p + alpha * f / _FPP0 * (1 - z4) + (ec_f - ec_p) * f * z4


def _ec_vwn5_spin(rho, zeta):
    """VWN5 correlation with the standard zeta interpolation."""
    return _ec_vwn_spin(rho, zeta, _VWN5, _VWN5_F, _VWN5_A)


def _ex_lsda(rho_a, rho_b, rho):
    """Spin-scaled Slater exchange per particle of the density ``rho``."""
    return 0.5 * (_ex_slater(2 * rho_a) * 2 * rho_a
                  + _ex_slater(2 * rho_b) * 2 * rho_b) / rho


def _exc_lsda(rho_a, rho_b):
    """LSDA (Slater + VWN5) exchange-correlation energy per particle of the
    total density."""
    rho = rho_a + rho_b
    zeta = (rho_a - rho_b) / (rho + _TINY)
    return _ex_lsda(rho_a, rho_b, rho + _TINY) + _ec_vwn5_spin(rho, zeta)


def _exc_pbe_spin(rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb, ex_frac=1.0,
                  mu=0.2195149727645171, beta=0.06672455060314922):
    """Spin-resolved PBE(sol) exc per particle of the total density."""
    rho = rho_a + rho_b
    zeta = (rho_a - rho_b) / (rho + _TINY)
    sigma = sigma_aa + 2 * sigma_ab + sigma_bb
    ex = 0.5 * (_ex_pbe(2 * rho_a, 4 * sigma_aa, mu) * 2 * rho_a
                + _ex_pbe(2 * rho_b, 4 * sigma_bb, mu) * 2 * rho_b) \
        / (rho + _TINY)
    return ex_frac * ex + _ec_pbe_spin(rho, zeta, sigma, beta)


def _exc_b3_spin(ax_lda, ax_b88, ac_vwn, ac_lyp, vwn):
    """Spin-resolved B88/LYP hybrid mixes (BLYP, B3LYP, B3LYP5) with VWN
    parameter triple ``vwn``: exc per particle of the total density."""
    def exc(ra, rb, saa, sab, sbb):
        rho = ra + rb + _TINY
        zeta = (ra - rb) / rho
        e = ax_b88 * (_ex_b88_channel(ra, saa) + _ex_b88_channel(rb, sbb)) / rho \
            + ac_lyp * _ec_lyp_spin(ra, rb, saa, sab, sbb)
        if ax_lda:
            e = e + ax_lda * _ex_lsda(ra, rb, rho)
        if ac_vwn:
            e = e + ac_vwn * _ec_vwn_spin(rho, zeta, *vwn)
        return e
    return exc


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
            self._exc_spin = _exc_lsda
        elif name in ("lda,", "slater"):
            self.family = "lda"
            self.hyb = 0.0
            self._exc = _ex_slater
            self._exc_spin = lambda ra, rb: _ex_lsda(ra, rb, ra + rb + _TINY)
        elif name == "pbe":
            self.family = "gga"
            self.hyb = 0.0
            self._exc = lambda rho, sigma: _ex_pbe(rho, sigma) + _ec_pbe(rho, sigma)
            self._exc_spin = _exc_pbe_spin
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
            self._exc_spin = lambda *a: _exc_pbe_spin(*a, mu=10.0 / 81.0, beta=0.046)
        elif name == "pbe0":
            self.family = "gga"
            self.hyb = 0.25
            self._exc = lambda rho, sigma: (
                0.75 * _ex_pbe(rho, sigma) + _ec_pbe(rho, sigma)
            )
            self._exc_spin = lambda *a: _exc_pbe_spin(*a, ex_frac=0.75)
        elif name == "blyp":
            self.family = "gga"
            self.hyb = 0.0
            self._exc = lambda rho, sigma: _ex_b88(rho, sigma) + _ec_lyp(rho, sigma)
            self._exc_spin = _exc_b3_spin(0.0, 1.0, 0.0, 1.0, None)
        elif name in ("b3lyp", "b3lyp5"):
            # Gaussian-convention B3: 0.8 LDA_x + 0.72 dB88 + 0.2 HF
            # == 0.08 LDA_x + 0.72 B88(full) + 0.2 HF; correlation
            # 0.19 VWN + 0.81 LYP with VWN-RPA ('b3lyp') or VWN5 ('b3lyp5')
            self.family = "gga"
            self.hyb = 0.2
            vwn = ((_VWN5, _VWN5_F, _VWN5_A) if name == "b3lyp5"
                   else (_VWN3, _VWN3_F, _VWN3_A))
            self._exc = lambda rho, sigma: (
                0.08 * _ex_slater(rho) + 0.72 * _ex_b88(rho, sigma)
                + 0.19 * _vwn_eps(rho, vwn[0]) + 0.81 * _ec_lyp(rho, sigma)
            )
            self._exc_spin = _exc_b3_spin(0.08, 0.72, 0.19, 0.81, vwn)
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
            # spin scaling of the short-range exchange: (2 na, 4 s_aa) per channel
            self._exc_spin = lambda ra, rb, saa, sab, sbb: (
                _exc_pbe_spin(ra, rb, saa, sab, sbb)
                - 0.25 * 0.5 * (_ex_wpbe_sr(2 * ra, 4 * saa, w) * 2 * ra
                                + _ex_wpbe_sr(2 * rb, 4 * sbb, w) * 2 * rb)
                / (ra + rb + _TINY)
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
            self._exc_spin = {"scan": xc_mgga.exc_scan_spin,
                              "tpss": xc_mgga.exc_tpss_spin,
                              "r2scan": xc_mgga.exc_r2scan_spin}[name]
        else:
            raise NotImplementedError(f"xc functional {name!r}")
        self.alpha = 0.0 if name == "hse06" else self.hyb

    def exc_vxc(self, rho, sigma=None):
        """Energy density per particle and potentials.

        Returns (exc, vrho, vsigma) with vsigma=None for LDA; derivatives of
        f = rho * exc by autograd (elementwise, so the gradient of the sum).
        """
        if self.family == "lda":
            return _exc_grads(self._exc, (rho,)) + (None,)
        if self.family == "gga":
            return _exc_grads(self._exc, (rho, sigma))
        raise ValueError(f"{self.name}: exc_vxc takes an LDA or GGA functional")

    def exc_vxc_mgga(self, rho, sigma, tau):
        """meta-GGA energy density per particle and potentials
        (exc, vrho, vsigma, vtau). The Fock-matrix tau term is
        V_tau = 1/2 w sum_x grad_x ao^T (vtau grad_x ao) (the reference's
        eval_xc convention, pyscf/dft/libxc.py:1282)."""
        if self.family != "mgga":
            raise ValueError(f"{self.name} is not a meta-GGA")
        return _exc_grads(self._exc, (rho, sigma, tau))

    def exc_vxc_spin(self, rho_a, rho_b, sigma_aa=None, sigma_ab=None,
                     sigma_bb=None):
        """Spin-polarised energy density and potentials, derivatives of
        f = (rho_a + rho_b) * exc.

        LDA: returns (exc, (vrho_a, vrho_b), None).
        GGA: returns (exc, (vrho_a, vrho_b), (vs_aa, vs_ab, vs_bb)).
        ``exc`` is per particle of the total density. rho and the
        same-spin sigmas are floored at 1e-30; sigma_ab, which may be
        negative, is not.
        """
        if self.family == "lda":
            exc, va, vb = _exc_grads(self._exc_spin, (rho_a, rho_b), spin=True)
            return exc, (va, vb), None
        if self.family == "gga":
            exc, va, vb, vaa, vab, vbb = _exc_grads(
                self._exc_spin, (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb),
                spin=True, keep=(3,))
            return exc, (va, vb), (vaa, vab, vbb)
        raise ValueError(f"{self.name}: exc_vxc_spin takes an LDA or GGA "
                         "functional")

    def exc_vxc_mgga_spin(self, rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb,
                          tau_a, tau_b):
        """Spin-polarised meta-GGA: returns (exc, (va, vb),
        (vs_aa, vs_ab, vs_bb), (vt_a, vt_b)), floors as
        :meth:`exc_vxc_spin` (tau floored too)."""
        if self.family != "mgga":
            raise ValueError(f"{self.name} is not a meta-GGA")
        exc, va, vb, vaa, vab, vbb, vta, vtb = _exc_grads(
            self._exc_spin,
            (rho_a, rho_b, sigma_aa, sigma_ab, sigma_bb, tau_a, tau_b),
            spin=True, keep=(3,))
        return exc, (va, vb), (vaa, vab, vbb), (vta, vtb)


def _exc_grads(exc_fn, args, spin: bool = False, keep=()):
    """(exc, d(n exc)/d arg for each arg) by autograd, n = args[0], or
    args[0] + args[1] with ``spin``; every arg but those at the positions
    in ``keep`` is floored at 1e-30 first (the potentials are the
    derivatives at the floored values, as the reference takes them).

    When an argument requires grad (with grad mode on) the results are
    differentiable in the arguments: exc keeps its graph and the
    potentials are built with ``create_graph``, so a force functional can
    differentiate exc and a response kernel the potentials. The floor is
    then differentiated as the reference's ``jnp.maximum``: no gradient
    below it, half at a tie (:func:`_max`). Otherwise nothing is recorded.
    """
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        args = [a if i in keep else _max(a, _TINY) for i, a in enumerate(args)]
        args = [a if a.requires_grad else a.detach().requires_grad_(True)
                for a in args]
        exc = exc_fn(*args)
        n = args[0] + args[1] if spin else args[0]
        grads = torch.autograd.grad((n * exc).sum(), args, create_graph=True)
        return (exc,) + tuple(grads)
    args = [(a if i in keep else torch.clamp(a, min=_TINY)).detach()
            for i, a in enumerate(args)]
    with torch.enable_grad():
        args = [a.requires_grad_(True) for a in args]
        exc = exc_fn(*args)
        n = args[0] + args[1] if spin else args[0]
        grads = torch.autograd.grad((n * exc).sum(), args)
    return (exc.detach(),) + tuple(grads)

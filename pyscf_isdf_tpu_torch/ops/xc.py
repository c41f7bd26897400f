"""Exchange-correlation functionals in torch (closed-shell).

Implements, at formula level, the functionals this slice of the port
needs:

  * LDA exchange (Slater/Dirac) and VWN5 correlation ('lda,vwn'),
  * PBE exchange + correlation, and PBE0 = 0.25 exact + 0.75 PBE x + PBE c,
  * 'hf' (no density functional, full exact exchange).

Energy densities are written once; potentials (vrho, vsigma) come from
``torch.autograd.grad`` of the energy per volume — exact derivatives, no
hand-coded potential formulas. Other functionals (B3LYP, range-separated
hybrids, meta-GGAs) are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

_TINY = 1e-30
_PI = math.pi


# ----------------------------------------------------------------- LDA pieces
def _ex_slater(rho):
    """Slater exchange energy per particle."""
    return -0.75 * (3.0 / _PI) ** (1.0 / 3) * rho ** (1.0 / 3)


_VWN5 = dict(A=0.0310907, b=3.72744, c=12.9352, x0=-0.10498)


def _ec_vwn5(rho):
    """VWN5 paramagnetic correlation energy per particle."""
    A, b, c, x0 = _VWN5["A"], _VWN5["b"], _VWN5["c"], _VWN5["x0"]
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


# ----------------------------------------------------------------- PBE pieces
def _ex_pbe(rho, sigma, mu=0.2195149727645171):
    """PBE exchange energy per particle (PRL 77, 3865)."""
    kappa = 0.804
    kf = (3 * _PI**2 * rho) ** (1.0 / 3)
    s2 = sigma / (4 * kf**2 * rho**2 + _TINY)
    fx = 1 + kappa - kappa / (1 + mu * s2 / kappa)
    return _ex_slater(rho) * fx


def _ec_pw92(rho):
    """PW92 paramagnetic correlation (basis of PBE correlation)."""
    A, a1 = 0.031091, 0.21370
    b1, b2, b3, b4 = 7.5957, 3.5876, 1.6382, 0.49294
    rs = (3.0 / (4 * _PI * rho)) ** (1.0 / 3)
    srs = torch.sqrt(rs)
    den = 2 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    return -2 * A * (1 + a1 * rs) * torch.log(1 + 1.0 / (den + _TINY))


def _ec_pbe(rho, sigma, beta=0.06672455060314922):
    """PBE correlation energy per particle (closed shell)."""
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


# --------------------------------------------------------------- public specs
class XCSpec:
    """Resolved functional: family ('lda'|'gga'|'hf'), hybrid exact-exchange
    weight ``hyb`` and the energy-per-particle function exc(rho[, sigma]).
    Every functional ported here is pure or a global hybrid (no range
    separation)."""

    def __init__(self, name: str):
        name = name.lower().replace(" ", "")
        self.name = name
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
        elif name == "pbe0":
            self.family = "gga"
            self.hyb = 0.25
            self._exc = lambda rho, sigma: (
                0.75 * _ex_pbe(rho, sigma) + _ec_pbe(rho, sigma)
            )
        elif name in ("hf", "hartree-fock"):
            self.family = "hf"
            self.hyb = 1.0
            self._exc = None
        else:
            raise NotImplementedError(f"xc functional {name!r}")

    def exc_vxc(self, rho, sigma=None):
        """Energy density per particle and potentials.

        Returns (exc, vrho, vsigma) with vsigma=None for LDA; derivatives of
        f = rho * exc by autograd (elementwise, so the gradient of the sum).
        """
        if self.family not in ("lda", "gga"):
            raise ValueError("pure HF has no xc functional")
        args = [torch.clamp(rho, min=_TINY).detach()]
        if self.family == "gga":
            args.append(torch.clamp(sigma, min=_TINY).detach())
        with torch.enable_grad():
            args = [a.requires_grad_(True) for a in args]
            exc = self._exc(*args)
            grads = torch.autograd.grad((args[0] * exc).sum(), args)
        vsigma = grads[1] if self.family == "gga" else None
        return exc.detach(), grads[0], vsigma

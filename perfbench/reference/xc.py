"""PBE0 on the uniform grid for the plain reference.

Frozen, trimmed copy (closed shell, PBE0 only) of
``pyscf_isdf_tpu_torch/ops/xc.py`` and of ``_vxc_gga`` in
``pyscf_isdf_tpu_torch/scf/hf.py`` at commit
0f4080748bdaf2cf81cd310235eeac9d4311d481: the energy density is written
once and the potentials are its autograd derivatives.
"""
from __future__ import annotations

import math

import torch

_TINY = 1e-30
_PI = math.pi
HYB = 0.25          # PBE0's share of exact exchange


def _ex_slater(rho):
    return -0.75 * (3.0 / _PI) ** (1.0 / 3) * rho ** (1.0 / 3)


def _ex_pbe(rho, sigma, mu=0.2195149727645171):
    kappa = 0.804
    kf = (3 * _PI**2 * rho) ** (1.0 / 3)
    s2 = sigma / (4 * kf**2 * rho**2 + _TINY)
    return _ex_slater(rho) * (1 + kappa - kappa / (1 + mu * s2 / kappa))


def _ec_pw92(rho, A=0.031091, a1=0.21370, b1=7.5957, b2=3.5876, b3=1.6382,
             b4=0.49294):
    rs = (3.0 / (4 * _PI * rho)) ** (1.0 / 3)
    srs = torch.sqrt(rs)
    den = 2 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
    return -2 * A * (1 + a1 * rs) * torch.log(1 + 1.0 / (den + _TINY))


def _ec_pbe(rho, sigma, beta=0.06672455060314922):
    gamma = 0.031090690869654895
    ec0 = _ec_pw92(rho)
    kf = (3 * _PI**2 * rho) ** (1.0 / 3)
    ks = torch.sqrt(4 * kf / _PI)
    t2 = sigma / (4 * ks**2 * rho**2 + _TINY)
    Afac = beta / gamma / (torch.exp(-ec0 / gamma) - 1 + _TINY)
    num = 1 + Afac * t2
    return ec0 + gamma * torch.log(1 + beta / gamma * t2 * num / (num + Afac**2 * t2 * t2))


def exc_pbe0(rho, sigma):
    """PBE0's semilocal energy per particle: 3/4 PBE exchange + PBE
    correlation."""
    return 0.75 * _ex_pbe(rho, sigma) + _ec_pbe(rho, sigma)


def exc_vxc(rho, sigma):
    """(exc, vrho, vsigma), derivatives of rho * exc at the floored
    arguments."""
    args = [torch.clamp(a, min=_TINY).detach() for a in (rho, sigma)]
    with torch.enable_grad():
        args = [a.requires_grad_(True) for a in args]
        exc = exc_pbe0(*args)
        vrho, vsigma = torch.autograd.grad((args[0] * exc).sum(), args)
    return exc.detach(), vrho, vsigma


def vxc_gga(aoR, ao_grad, dm, weight):
    """(e_xc, vxc) of PBE0's semilocal part on the grid."""
    t = aoR @ dm
    rho = (t * aoR).sum(-1)
    grad_rho = 2.0 * torch.einsum("gi,xgi->xg", t, ao_grad)
    sigma = (grad_rho * grad_rho).sum(0)
    exc, vrho, vsigma = exc_vxc(rho, sigma)
    e_xc = weight * torch.sum(rho * exc)
    aow = 0.5 * vrho[:, None] * aoR + 2.0 * torch.einsum(
        "xg,xgi->gi", grad_rho * vsigma, ao_grad)
    half = weight * (aoR.T @ aow)
    return e_xc, half + half.T

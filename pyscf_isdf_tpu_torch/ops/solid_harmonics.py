"""Real solid harmonics S_lm for l <= 4.

``S_lm(v)`` is the homogeneous degree-l polynomial such that a normalized
real spherical harmonic is ``Y_lm(r_hat) = S_lm(v) / |v|^l``; the angular
normalization ``int |Y_lm|^2 dOmega = 1`` is folded into the coefficients.

Component ordering matches the reference AO convention
(libcint spherical ordering, see pyscf/gto/mole.py cart2sph):
  l=0: (1,)
  l=1: (x, y, z)
  l>=2: m = -l ... +l.

Works with numpy (host float64 build path) and torch (device path): pass
the array namespace (``np`` or ``torch``) as ``xp``.
"""
from __future__ import annotations

import math

_PI = math.pi


def solid_harmonics(l: int, v, xp):
    """Evaluate all 2l+1 real solid harmonics at vectors ``v`` (..., 3).

    Returns an array of shape (..., 2l+1).
    """
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        c = 0.5 / math.sqrt(_PI)
        return c * xp.ones_like(x)[..., None]
    if l == 1:
        c = math.sqrt(3 / (4 * _PI))
        return xp.stack([c * x, c * y, c * z], -1)
    if l == 2:
        c0 = math.sqrt(15 / (4 * _PI))
        c1 = math.sqrt(5 / (16 * _PI))
        c2 = math.sqrt(15 / (16 * _PI))
        return xp.stack(
            [
                c0 * x * y,
                c0 * y * z,
                c1 * (2 * z * z - x * x - y * y),
                c0 * x * z,
                c2 * (x * x - y * y),
            ],
            -1,
        )
    if l == 3:
        r2 = x * x + y * y + z * z
        c_3 = math.sqrt(35 / (32 * _PI))
        c_2 = math.sqrt(105 / (4 * _PI))
        c_1 = math.sqrt(21 / (32 * _PI))
        c0 = math.sqrt(7 / (16 * _PI))
        c2 = math.sqrt(105 / (16 * _PI))
        return xp.stack(
            [
                c_3 * y * (3 * x * x - y * y),
                c_2 * x * y * z,
                c_1 * y * (4 * z * z - x * x - y * y),
                c0 * z * (2 * z * z - 3 * x * x - 3 * y * y),
                c_1 * x * (4 * z * z - x * x - y * y),
                c2 * z * (x * x - y * y),
                c_3 * x * (x * x - 3 * y * y),
            ],
            -1,
        )
    if l == 4:
        x2, y2, z2 = x * x, y * y, z * z
        r2 = x2 + y2 + z2
        c_4 = 0.75 * math.sqrt(35 / _PI)
        c_3 = 0.75 * math.sqrt(35 / (2 * _PI))
        c_2 = 0.75 * math.sqrt(5 / _PI)
        c_1 = 0.75 * math.sqrt(5 / (2 * _PI))
        c0 = 3.0 / (16 * math.sqrt(_PI))
        c2 = 3.0 / 8 * math.sqrt(5 / _PI)
        c4 = 3.0 / 16 * math.sqrt(35 / _PI)
        return xp.stack(
            [
                c_4 * x * y * (x2 - y2),
                c_3 * y * z * (3 * x2 - y2),
                c_2 * x * y * (7 * z2 - r2),
                c_1 * y * z * (7 * z2 - 3 * r2),
                c0 * (35 * z2 * z2 - 30 * z2 * r2 + 3 * r2 * r2),
                c_1 * x * z * (7 * z2 - 3 * r2),
                c2 * (x2 - y2) * (7 * z2 - r2),
                c_3 * x * z * (x2 - 3 * y2),
                c4 * (x2 * (x2 - 3 * y2) - y2 * (3 * x2 - y2)),
            ],
            -1,
        )
    raise NotImplementedError(f"solid harmonics for l={l}")

"""Port functionals == JAX reference XCSpec, point by point.

Every closed-shell functional the port added beside LDA/PBE/PBE0: the
GGAs through exc_vxc (exc, vrho, vsigma), the meta-GGAs through
exc_vxc_mgga (exc, vrho, vsigma, vtau), on the same float64 points. The
reference side is the reference XCSpec's energy function: rho*exc and
its pullback of ones by one jax.vjp, the derivatives its exc_vxc takes
point by point under vmap, at a third of the compile time. The
sample is random over eleven decades of density and five of reduced
gradient, plus the points where a formula switches branch: the
short-range attenuation's series at a = omega/(2 kF F) = 1e-3 (HSE06),
SCAN's interpolation at alpha = 1 and r2SCAN's at alpha-bar = 2.5, each
approached from both sides. Bars, relative and per point: 1e-12 on exc,
1e-10 on the potentials (the same formulas, autograd against autodiff,
differing in rounding only).

The spin-polarised forms are held the same way on the same points (the
same shapes, so the reference's eager operations compiled for the
closed-shell cases serve): the random ones split between the spins at
random (zeta over (-1, 1), sigma_ab of either sign), the switch points
evenly (the spin-scaled exchange and the total correlation then sit at
the same switches). The reference side is its exc_vxc_spin and
exc_vxc_mgga_spin, run eagerly, with the vmap(grad(f, argnums=i)) it
takes for every input served by one jax.vjp of the same elementwise f
(_OneVjp: the same derivatives, a third of the eager dispatch). Some spin-polarised
potentials cancel large terms at some points (TPSS's spin-gradient term,
O(1/rho^2), at a strongly polarised low density: a one-ulp change of one
input moves v_sigma_aa by 1e-8 of itself there), so any two float64
evaluations differ there by more than 1e-10. The spin bar per point is
therefore 1e-10 relative plus four times the point's rounding response:
the sum over inputs of the change of the port's output when that input
moves by one ulp. Where that response is below 1e-10 relative, which is
all but a few points, the bar is 1e-10 relative. The unpolarised limit
exc_vxc_spin(rho/2, rho/2, sigma/4, sigma/4, sigma/4) == exc_vxc(rho,
sigma) holds in the port for every functional, at the same bars.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu.ops import xc as ref_xc  # noqa: E402

from pyscf_isdf_tpu_torch.ops import xc  # noqa: E402

C3 = (3 * np.pi**2) ** (2.0 / 3)
ETA = 1e-3                                   # r2SCAN's alpha-bar regulariser


def _sample():
    """(rho, sigma, tau) float64, random and at the branch switches."""
    rng = np.random.default_rng(11)
    n = 40
    rho = 10 ** rng.uniform(-6, 1.5, n)
    sigma = rho ** (8.0 / 3) * 10 ** rng.uniform(-3, 2, n)
    alpha = rng.uniform(0.0, 4.0, n)
    tau = sigma / (8 * rho) + alpha * 0.3 * C3 * rho ** (5.0 / 3)
    # SCAN alpha = 1 and r2SCAN alpha-bar = 2.5 from below and above
    d = np.array([-1e-3, -1e-6, 1e-6, 1e-3])
    r0 = np.full(8, 0.3)
    s0 = r0 ** (8.0 / 3) * 0.5
    tw, tu = s0[:4] / (8 * r0[:4]), 0.3 * C3 * r0[:4] ** (5.0 / 3)
    tau_sw = np.concatenate([tw + (1 + d) * tu, tw + (2.5 + d) * (tu + ETA * tw)])
    # the short-range series switch a = 1e-3 at s -> 0 (F_PBE ~ 1)
    a = 1e-3 * (1 + np.array([-1e-2, -1e-5, 1e-5, 1e-2]))
    r1 = (0.11 / (2 * a)) ** 3 / (3 * np.pi**2)
    s1 = r1 ** (8.0 / 3) * 1e-10
    t1 = s1 / (8 * r1) + 0.3 * C3 * r1 ** (5.0 / 3)
    return (np.concatenate([rho, r0, r1]), np.concatenate([sigma, s0, s1]),
            np.concatenate([tau, tau_sw, t1]))


@pytest.mark.parametrize("name", ["pbesol", "blyp", "b3lyp", "b3lyp5", "hse06",
                                  "scan", "tpss", "r2scan"])
def test_functional_parity(name):
    rho, sigma, tau = _sample()
    ref_spec, spec = ref_xc.XCSpec(name), xc.XCSpec(name)
    assert (spec.family, spec.hyb, spec.alpha, spec.omega) == \
        (ref_spec.family, ref_spec.hyb, ref_spec.alpha, ref_spec.omega)
    args = (rho, sigma) if spec.family == "gga" else (rho, sigma, tau)
    jargs = tuple(map(jnp.asarray, args))
    f, vjp = jax.vjp(lambda *a: a[0] * ref_spec._exc(*a), *jargs)
    ref = (f / jargs[0],) + vjp(jnp.ones_like(f))
    targs = tuple(map(torch.as_tensor, args))
    out = spec.exc_vxc(*targs) if spec.family == "gga" else spec.exc_vxc_mgga(*targs)
    out = [o for o in out if o is not None]
    for i, (o, r) in enumerate(zip(out, ref)):
        o, r = o.numpy(), np.asarray(r)
        assert np.all(np.isfinite(o))
        bar = 1e-12 if i == 0 else 1e-10
        assert np.all(np.abs(o - r) <= bar * np.abs(r)), (i, np.max(np.abs(o - r) / np.abs(r)))


def _spin_sample():
    """(rho_a, rho_b, s_aa, s_ab, s_bb, tau_a, tau_b) on the points of
    _sample(): the random ones split between the spins at random (zeta
    over (-1, 1), sigma_ab of either sign), the switch points evenly."""
    rho, sigma, tau = _sample()
    rng = np.random.default_rng(12)
    n = 40
    u = np.concatenate([rng.uniform(0.0, 1.0, n), np.full(len(rho) - n, 0.5)])
    v = np.concatenate([rng.uniform(0.0, 1.0, n), np.full(len(rho) - n, 0.5)])
    cos = np.concatenate([rng.uniform(-1.0, 1.0, n), np.ones(len(rho) - n)])
    ra, rb = u * rho, (1 - u) * rho
    saa, sbb = u * u * sigma, (1 - u) ** 2 * sigma
    sab = np.sqrt(saa * sbb) * cos
    return ra, rb, saa, sab, sbb, v * tau, (1 - v) * tau


class _OneVjp:
    """Stands in for the module ``jax`` inside the reference's ops/xc.py,
    whose spin potentials are vmap(grad(f, argnums=i))(*args) of one
    elementwise f for every i: all of them come from one jax.vjp of f.
    Everything else is jax's."""

    def __init__(self):
        self._last = None

    def __getattr__(self, name):
        return getattr(jax, name)

    def grad(self, f, argnums=0):
        return f, argnums

    def vmap(self, f_argnum):
        f, i = f_argnum

        def run(*args):
            if self._last is None or self._last[0] is not f:
                e, vjp = jax.vjp(f, *args)
                self._last = (f, vjp(jnp.ones_like(e)))
            return self._last[1][i]
        return run


@pytest.mark.parametrize("name", ["lda", "pbe0", "b3lyp", "hse06", "scan", "tpss",
                                  "r2scan"])
def test_spin_functional_parity(name):
    """One functional of each spin-polarised form: LSDA (VWN5 spin),
    spin PBE (PBE/PBE0/PBEsol), the B88/LYP mixes with VWN-RPA spin
    (BLYP/B3LYP/B3LYP5), HSE06's spin-scaled short-range exchange, and
    the three meta-GGAs."""
    args = _spin_sample()
    ref_spec, spec = ref_xc.XCSpec(name), xc.XCSpec(name)
    n = {"lda": 2, "gga": 5, "mgga": 7}[spec.family]
    jargs = tuple(map(jnp.asarray, args[:n]))
    targs = tuple(map(torch.as_tensor, args[:n]))
    method = "exc_vxc_mgga_spin" if n == 7 else "exc_vxc_spin"
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_xc, "jax", _OneVjp())
    try:
        ref = getattr(ref_spec, method)(*jargs)
    finally:
        mp.undo()
    out = getattr(spec, method)(*targs)
    ref, out = ((o[0],) + sum((p for p in o[1:] if p), ()) for o in (ref, out))
    assert len(out) == len(ref)
    resp = _ulp_response(spec, targs, n)
    for i, (o, r, d) in enumerate(zip(out, ref, resp)):
        o, r = o.numpy(), np.asarray(r)
        assert np.all(np.isfinite(o))
        bar = (1e-12 if i == 0 else 1e-10) * np.abs(r) + 4 * d
        assert np.all(np.abs(o - r) <= bar), (i, np.max(np.abs(o - r) / np.abs(r)))


def _ulp_response(spec, targs, n):
    """Per output, the sum over the first ``n`` inputs of |change| of the
    port's output when that input moves by one ulp."""
    def flat(*a):
        out = spec.exc_vxc_mgga_spin(*a) if spec.family == "mgga" else spec.exc_vxc_spin(*a)
        return [out[0]] + [t for part in out[1:] if part for t in part]

    base = flat(*targs[:n])
    resp = [torch.zeros_like(b) for b in base]
    for k in range(n):
        moved = list(targs[:n])
        moved[k] = torch.nextafter(moved[k], torch.full_like(moved[k], np.inf))
        for r, b, m in zip(resp, base, flat(*moved)):
            r += (m - b).abs()
    return [r.numpy() for r in resp]


@pytest.mark.parametrize("name", ["lda", "lda,", "pbe", "pbe0", "pbesol", "blyp",
                                  "b3lyp", "b3lyp5", "hse06", "scan", "tpss",
                                  "r2scan"])
def test_unpolarised_limit(name):
    """exc_vxc_spin at rho_a = rho_b = rho/2, sigma_ss' = sigma/4 (tau_s =
    tau/2) against exc_vxc: exc equal, vrho_a = vrho,
    (vs_aa + vs_ab + vs_bb)/4 = vsigma, (vt_a + vt_b)/2 = vtau."""
    rho, sigma, tau = map(torch.as_tensor, _sample())
    spec = xc.XCSpec(name)
    h, q = rho / 2, sigma / 4
    if spec.family == "lda":
        e0, v0, _ = spec.exc_vxc(rho)
        e, (va, vb), _ = spec.exc_vxc_spin(h, h)
        pairs = [(e, e0), (va, v0), (vb, v0)]
    elif spec.family == "gga":
        e0, v0, vs0 = spec.exc_vxc(rho, sigma)
        e, (va, vb), vs = spec.exc_vxc_spin(h, h, q, q, q)
        pairs = [(e, e0), (va, v0), (vb, v0), (sum(vs) / 4, vs0)]
    else:
        e0, v0, vs0, vt0 = spec.exc_vxc_mgga(rho, sigma, tau)
        e, (va, vb), vs, (ta, tb) = spec.exc_vxc_mgga_spin(h, h, q, q, q, tau / 2, tau / 2)
        pairs = [(e, e0), (va, v0), (vb, v0), (sum(vs) / 4, vs0), ((ta + tb) / 2, vt0)]
    for i, (o, r) in enumerate(pairs):
        bar = 1e-12 if i == 0 else 1e-10
        assert torch.all((o - r).abs() <= bar * r.abs()), (i, float(((o - r) / r).abs().max()))

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
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
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

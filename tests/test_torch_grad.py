"""Port forces, stress and geometry optimization (grad/) == JAX reference.

Each case converges one SCF with the port on the CPU and hands the same
state (density, orbitals, energies, Fock matrices) to both packages'
gradient functions, the reference's on its own system of the same cell.
Cells are the reference tests' (tests/test_grad.py, test_kgrad.py,
test_stress.py, test_kstress.py): H2 in a 6-bohr box, the diamond
primitive cell, the H3 radical (spin 1), all on 14^3; the two-k-point H2
and H3 chains. All float64 on the CPU. Bars: forces and stress (dE/d eps)
1e-9, the traced energy 1e-10 Ha from the SCF's e_tot.

The reference's ``jax.value_and_grad`` runs under one ``jax.jit`` at
XLA's backend optimization level 0 here (:func:`_jitted_reference`): its
eager autodiff takes 10-30 s a call on one core, such a compile 4-15 s.
The optimizers' own logic is held to the reference's with the port's
SCF, forces and stress inside both. The
autograd pieces of the port are held to brute-force finite differences
without the reference: the AO values' backward (positions, grid points,
lattice images; Gamma and a k-point) and the differentiable XC route
(first and second derivatives, a floored point and a tie).
"""
import contextlib
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu.grad import khf as ref_khf, kstress as ref_kstress  # noqa: E402
from pyscf_isdf_tpu.grad import kuhf as ref_kuhf  # noqa: E402
from pyscf_isdf_tpu.grad.optimize import optimize as ref_optimize  # noqa: E402
from pyscf_isdf_tpu.grad.optimize import optimize_cell as ref_optimize_cell  # noqa: E402
from pyscf_isdf_tpu.grad import rhf as ref_rhf, stress as ref_stress  # noqa: E402
from pyscf_isdf_tpu.grad import uhf as ref_uhf  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_kbuild  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell, lattice  # noqa: E402
from pyscf_isdf_tpu_torch.grad import khf, kstress, kuhf, rhf, stress, uhf  # noqa: E402
from pyscf_isdf_tpu_torch.grad.optimize import optimize, optimize_cell  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops import xc  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ao_eval import (  # noqa: E402
    PackedBasis, eval_ao_positions, shell_rcut,
)
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, kuhf_kernel, rohf_kernel,
    scf_kernel, uhf_kernel,
)

GRAD_TOL = 1e-9
E_TOL = 1e-10
L = 6.0


@contextlib.contextmanager
def _jitted_reference():
    """The reference's jax.value_and_grad under one jax.jit."""
    vg = jax.value_and_grad
    jax.value_and_grad = lambda f, *a, **k: jax.jit(
        vg(f, *a, **k), compiler_options={"xla_backend_optimization_level": 0})
    try:
        yield
    finally:
        jax.value_and_grad = vg


def _host(v):
    """A port SCF result's tensors (nested in tuples and lists) as numpy."""
    if isinstance(v, (tuple, list)):
        return [_host(x) for x in v]
    return v.numpy() if torch.is_tensor(v) else v


def _ref_res(res):
    return {k: _host(v) for k, v in res.items()}


def _h2(build, dx=0.0):
    return build(np.eye(3) * L, [["H", (L / 2 - 0.8 + dx, L / 2, L / 2)],
                                 ["H", (L / 2 + 0.7, L / 2 + 0.1, L / 2)]],
                 basis="gth-szv", pseudo="gth-pade", mesh=[14] * 3)


def _h3(build):
    L3 = 7.0
    return build(np.eye(3) * L3, [["H", (L3 / 2 - 1.0, L3 / 2, L3 / 2)],
                                  ["H", (L3 / 2 + 0.4, L3 / 2 + 0.1, L3 / 2)],
                                  ["H", (L3 / 2 + 1.9, L3 / 2, L3 / 2)]],
                 basis="gth-szv", pseudo="gth-pade", mesh=[14] * 3, spin=1)


def _h2_chain(build):
    return build(np.array([[2.9, 0, 0], [0, L, 0], [0, 0, L]]),
                 [["H", (0.0, L / 2, L / 2)], ["H", (1.25, L / 2 + 0.1, L / 2)]],
                 basis="gth-szv", pseudo="gth-pade", mesh=[8, 14, 14])


def _h3_chain(build):
    return build(np.array([[3.4, 0, 0], [0, L, 0], [0, 0, L]]),
                 [["H", (0.0, L / 2, L / 2)], ["H", (1.45, L / 2 + 0.2, L / 2)],
                  ["H", (2.4, L / 2, L / 2)]],
                 basis="gth-szv", pseudo="gth-pade", mesh=[10, 14, 14], spin=1)


@pytest.fixture(scope="module")
def gamma_systems():
    """(port system, reference system) of each Gamma cell."""
    return {
        "h2": (build_scf_system(_h2(build_cell), device="cpu"),
               ref_build(_h2(ref_build_cell))),
        "diamond": (build_scf_system(diamond_primitive(mesh=(14,) * 3), device="cpu"),
                    ref_build(ref_diamond(mesh=(14,) * 3))),
        "h3": (build_scf_system(_h3(build_cell), device="cpu"),
               ref_build(_h3(ref_build_cell))),
    }


@pytest.fixture(scope="module")
def k_systems():
    out = {}
    for name, make in (("h2", _h2_chain), ("h3", _h3_chain)):
        cell = make(build_cell)
        kpts = lattice.make_kpts(cell.a, [2, 1, 1])
        out[name] = (build_kscf_system(cell, kpts, device="cpu"),
                     ref_kbuild(make(ref_build_cell), kpts))
    return out


def _check(port, ref, e_port, res):
    assert np.abs(np.asarray(port) - np.asarray(ref)).max() < GRAD_TOL
    assert abs(e_port - res["e_tot"]) < E_TOL


# ------------------------------------------------------ autograd pieces
def _fd_cell():
    """Diamond primitive on a coarse 6^3 mesh with atom 0 moved off its
    site: every AO column, image and grid point is live."""
    cell = diamond_primitive(mesh=(6, 6, 6))
    return replace(cell, coords=cell.coords + np.array([[0.11, -0.07, 0.05], [0, 0, 0]]))


@pytest.mark.parametrize("kpt", [None, (0.21, -0.13, 0.34)], ids=["gamma", "kpt"])
def test_ao_positions_backward_against_fd(kpt):
    """The backward of eval_ao_positions, sum Re(conj(G) d aoR), against
    central differences of the aoR sum: positions alone (the AO-derivative
    path), then positions, grid points and images together (the
    image-resolved path) along random directions."""
    cell = _fd_cell()
    packed = PackedBasis.from_cell(cell)
    f64 = dict(dtype=torch.float64)
    rcut = max(shell_rcut(sh) for sh in cell.shells)
    images = torch.as_tensor(lattice.lattice_images(cell.a, rcut, 3), **f64)
    coords = torch.as_tensor(cell.uniform_grid(), **f64)
    pos = torch.as_tensor(cell.coords, **f64)
    k = None if kpt is None else torch.as_tensor(kpt, **f64)
    rng = np.random.default_rng(7)
    G = torch.as_tensor(rng.standard_normal((coords.shape[0], cell.nao)), **f64)
    if k is not None:
        G = G + 1j * torch.as_tensor(rng.standard_normal(G.shape), **f64)

    def loss(p, c, im, kv=k):
        ao = eval_ao_positions(packed, c, im, p, kpt=kv)
        return (G.conj() * ao).real.sum() if kv is not None else (G * ao).sum()

    p0 = pos.clone().requires_grad_(True)
    gp, = torch.autograd.grad(loss(p0, coords, images), p0)
    h = 1e-5
    for a in range(2):
        for x in range(3):
            d = torch.zeros_like(pos)
            d[a, x] = h
            fd = (loss(pos + d, coords, images) - loss(pos - d, coords, images)) / (2 * h)
            assert abs(float(gp[a, x]) - float(fd)) < 1e-7 * max(1.0, abs(float(fd)))

    xs = [t.clone().requires_grad_(True) for t in (pos, coords, images)]
    grads = torch.autograd.grad(loss(*xs), xs)
    if k is None:
        # independent random displacements of positions, points and images
        dirs = [torch.as_tensor(rng.standard_normal(t.shape), **f64) for t in xs]
        fd = (loss(*(t + h * d for t, d in zip((pos, coords, images), dirs)))
              - loss(*(t - h * d for t, d in zip((pos, coords, images), dirs)))) / (2 * h)
    else:
        # a strain: positions, points and images as (1 + eps) r and the
        # k-point contragradiently, so the phase k.T is invariant
        E = torch.as_tensor(rng.standard_normal((3, 3)), **f64)
        dirs = [t @ E.T for t in (pos, coords, images)]

        def strained(sign):
            F = torch.eye(3, **f64) + sign * h * E
            return loss(pos @ F.T, coords @ F.T, images @ F.T, k @ torch.linalg.inv(F))

        fd = (strained(1) - strained(-1)) / (2 * h)
    ad = sum(float((g * d).sum()) for g, d in zip(grads, dirs))
    assert abs(ad - float(fd)) < 1e-7 * max(1.0, abs(float(fd)))


def test_xc_route_first_and_second_derivatives():
    """exc and the potentials of PBE (closed shell) and of the spin LDA are
    differentiable when their inputs require grad: d(sum rho exc)/d rho
    equals the potential, d vrho/d rho matches central differences of the
    potential, and nothing changes in the values (the SCF path's)."""
    spec = xc.XCSpec("pbe")
    rho = torch.tensor([0.3, 0.05, 1e-3, 2.0], dtype=torch.float64)
    sigma = torch.tensor([0.02, 1e-4, 1e-7, 0.5], dtype=torch.float64)
    exc0, vr0, vs0 = spec.exc_vxc(rho, sigma)
    r = rho.clone().requires_grad_(True)
    s = sigma.clone().requires_grad_(True)
    exc, vr, vs = spec.exc_vxc(r, s)
    for a, b in ((exc, exc0), (vr, vr0), (vs, vs0)):
        assert torch.equal(a.detach(), b)
    g_r, g_s = torch.autograd.grad((r * exc).sum(), (r, s), retain_graph=True)
    assert torch.allclose(g_r, vr0, rtol=1e-13, atol=0)
    assert torch.allclose(g_s, vs0, rtol=1e-13, atol=0)
    h = 1e-6 * rho
    d2, = torch.autograd.grad(vr.sum(), r)
    fd = (spec.exc_vxc(rho + h, sigma)[1] - spec.exc_vxc(rho - h, sigma)[1]) / (2 * h)
    assert torch.allclose(d2, fd, rtol=1e-6, atol=0)

    lda = xc.XCSpec("lda,vwn")
    ra = torch.tensor([0.2, 0.01], dtype=torch.float64, requires_grad=True)
    rb = torch.tensor([0.1, 0.02], dtype=torch.float64, requires_grad=True)
    _, (va, _), _ = lda.exc_vxc_spin(ra, rb)
    faa, fab = torch.autograd.grad(va.sum(), (ra, rb))
    hh = 1e-7
    for t, f in ((ra, faa), (rb, fab)):
        up = lda.exc_vxc_spin(ra.detach() + hh * (t is ra), rb.detach() + hh * (t is rb))[1][0]
        dn = lda.exc_vxc_spin(ra.detach() - hh * (t is ra), rb.detach() - hh * (t is rb))[1][0]
        assert torch.allclose(f, (up - dn) / (2 * hh), rtol=1e-6, atol=0)


def test_xc_route_at_the_floor():
    """Below the 1e-30 floor the potential is that of the floored density
    and passes no gradient (the reference's jnp.maximum); at the floor
    itself half of it (the tie); the second derivative there is half the
    one just above, and zero below."""
    spec = xc.XCSpec("lda,vwn")
    floor = 1e-30
    r = torch.tensor([1e-40, floor, 1e-3], dtype=torch.float64, requires_grad=True)
    exc, vr, _ = spec.exc_vxc(r)
    v_floor = spec.exc_vxc(torch.tensor([floor], dtype=torch.float64))[1]
    assert float(vr[0].detach()) == float(v_floor[0])
    d_exc, = torch.autograd.grad(exc.sum(), r, retain_graph=True)
    assert float(d_exc[0]) == 0.0
    d2, = torch.autograd.grad(vr.sum(), r)
    x = torch.tensor([floor], dtype=torch.float64, requires_grad=True)
    v_x, = torch.autograd.grad((x * spec._exc(x)).sum(), x, create_graph=True)
    full, = torch.autograd.grad(v_x.sum(), x)
    assert float(d2[0]) == 0.0
    assert abs(float(d2[1]) - 0.5 * float(full[0])) <= 1e-14 * abs(float(full[0]))
    h = 1e-9
    fd = (spec.exc_vxc(torch.tensor([1e-3 + h], dtype=torch.float64))[1]
          - spec.exc_vxc(torch.tensor([1e-3 - h], dtype=torch.float64))[1]) / (2 * h)
    assert abs(float(d2[2]) - float(fd[0])) < 1e-5 * abs(float(fd[0]))


# -------------------------------------------------------------- forces
@pytest.mark.parametrize("cell,xc_name", [("h2", "hse06"), ("diamond", "pbe0")])
def test_rhf_gradient(gamma_systems, cell, xc_name):
    """Closed-shell forces: the range-separated hybrid (full and long-range
    exchange, both probe madelungs) and the hybrid GGA with the carbon
    nonlocal PP."""
    system, ref_system = gamma_systems[cell]
    res = scf_kernel(system, xc=xc_name, conv_tol=1e-11)
    g, e = rhf.rhf_gradient(system, res, xc=xc_name, return_energy=True, device="cpu")
    with _jitted_reference():
        g_ref = ref_rhf.rhf_gradient(ref_system, _ref_res(res), xc=xc_name)
    _check(g, g_ref, e, res)


def test_uhf_and_rohf_gradient(gamma_systems):
    """UKS-LDA and ROHF forces on the H3 radical (ROHF: the non-canonical
    Pulay weight D_a F_a D_a + D_b F_b D_b)."""
    system, ref_system = gamma_systems["h3"]
    res = uhf_kernel(system, xc="lda,vwn", conv_tol=1e-11)
    g, e = uhf.uhf_gradient(system, res, xc="lda,vwn", return_energy=True, device="cpu")
    with _jitted_reference():
        g_ref = ref_uhf.uhf_gradient(ref_system, _ref_res(res), xc="lda,vwn")
    _check(g, g_ref, e, res)
    res = rohf_kernel(system, xc=None, conv_tol=1e-13, device="cpu")
    g, e = uhf.rohf_gradient(system, res, return_energy=True, device="cpu")
    with _jitted_reference():
        g_ref = ref_uhf.rohf_gradient(ref_system, _ref_res(res))
    _check(g, g_ref, e, res)


@pytest.mark.parametrize("xc_name", ["pbe0"])
def test_krhf_gradient(k_systems, xc_name):
    """k-point forces on the two-k-point H2 chain (PBE0: the (k1, k2)
    exchange and the GGA Bloch gradients)."""
    system, ref_system = k_systems["h2"]
    res = kscf_kernel(system, xc=xc_name, conv_tol=1e-12, max_cycle=200, device="cpu")
    g, e = khf.krhf_gradient(system, res, xc=xc_name, return_energy=True, device="cpu")
    with _jitted_reference():
        g_ref = ref_khf.krhf_gradient(ref_system, _ref_res(res), xc=xc_name)
    _check(g, g_ref, e, res)


def test_kuhf_gradient(k_systems):
    """k-point spin-polarized forces, KUKS-LDA on the H3 chain."""
    system, ref_system = k_systems["h3"]
    res = kuhf_kernel(system, xc="lda,vwn", conv_tol=1e-12, max_cycle=200, device="cpu")
    g, e = kuhf.kuhf_gradient(system, res, xc="lda,vwn", return_energy=True, device="cpu")
    with _jitted_reference():
        g_ref = ref_kuhf.kuhf_gradient(ref_system, _ref_res(res), xc="lda,vwn")
    _check(g, g_ref, e, res)


@pytest.mark.parametrize("gamma_centred", [True, False], ids=["gamma-centred", "shifted"])
def test_k_force_functional_is_the_scf_energy(gamma_centred):
    """ROADMAP queue 3 (o) and (p): at k-points with the carbon nonlocal PP
    the port's force functional takes the projectors at k+G and the local
    potential on the SCF's density, so its traced energy is the SCF's; the
    reference's takes the projectors at G ((o): the Gamma-centred 2x1x1
    mesh, k = b/2) and, where the Bloch AOs are complex (the shifted mesh),
    the transposed density too ((p)), and misses it."""
    cell = diamond_primitive(mesh=(8, 8, 8))
    kpts = lattice.make_kpts(cell.a, [2, 1, 1], with_gamma_point=gamma_centred)
    system = build_kscf_system(cell, kpts, device="cpu")
    res = kscf_kernel(system, xc="lda,vwn", conv_tol=1e-12, device="cpu")
    _, e = khf.krhf_gradient(system, res, xc="lda,vwn", return_energy=True, device="cpu")
    assert abs(e - res["e_tot"]) < E_TOL
    ref_system = ref_kbuild(ref_diamond(mesh=(8, 8, 8)), kpts)
    with _jitted_reference():
        _, e_ref = ref_khf.krhf_gradient(ref_system, _ref_res(res), xc="lda,vwn",
                                         return_energy=True)
    assert abs(e_ref - res["e_tot"]) > 1e-3


# -------------------------------------------------------------- stress
@pytest.mark.parametrize("cell,xc_name", [("diamond", "lda,vwn"), ("h2", "hse06")])
def test_stress_tensor(gamma_systems, cell, xc_name):
    """Closed-shell stress: LDA on diamond (strained vnl projectors and
    local PP; the image-resolved AO backward), HSE06 on H2 (the strained
    GGA gradient, the full and long-range exchange kernels and their
    probe-charge madelungs)."""
    system, ref_system = gamma_systems[cell]
    res = scf_kernel(system, xc=xc_name, conv_tol=1e-11)
    sig, e, g = stress.stress_tensor(system, res, xc=xc_name, return_energy=True,
                                     device="cpu")
    with _jitted_reference():
        _, _, g_ref = ref_stress.stress_tensor(ref_system, _ref_res(res), xc=xc_name,
                                               return_energy=True)
    _check(g, g_ref, e, res)
    assert np.allclose(sig, sig.T)


def test_open_shell_stress(gamma_systems):
    """UKS-LDA (ustress_tensor) and ROHF (rostress_tensor) stress of H3."""
    system, ref_system = gamma_systems["h3"]
    res = uhf_kernel(system, xc="lda,vwn", conv_tol=1e-11)
    _, e, g = stress.ustress_tensor(system, res, xc="lda,vwn", return_energy=True,
                                    device="cpu")
    with _jitted_reference():
        _, _, g_ref = ref_stress.ustress_tensor(ref_system, _ref_res(res), xc="lda,vwn",
                                                return_energy=True)
    _check(g, g_ref, e, res)
    res = rohf_kernel(system, xc=None, conv_tol=1e-13, device="cpu")
    _, e, g = stress.rostress_tensor(system, res, return_energy=True, device="cpu")
    with _jitted_reference():
        _, _, g_ref = ref_stress.rostress_tensor(ref_system, _ref_res(res),
                                                 return_energy=True)
    _check(g, g_ref, e, res)


@pytest.mark.parametrize("xc_name", ["hse06"])
def test_kstress_tensor(k_systems, xc_name):
    """k-point stress on the H2 chain (HSE06: the wrapped (k1, k2) kernels
    and the traced supercell madelung, long range too)."""
    system, ref_system = k_systems["h2"]
    res = kscf_kernel(system, xc=xc_name, conv_tol=1e-12, max_cycle=200, device="cpu")
    _, e, g = kstress.kstress_tensor(system, res, xc=xc_name, return_energy=True,
                                     device="cpu")
    with _jitted_reference():
        _, _, g_ref = ref_kstress.kstress_tensor(ref_system, _ref_res(res), xc=xc_name,
                                                 return_energy=True)
    _check(g, g_ref, e, res)


# --------------------------------------------------------- optimizers
@pytest.fixture
def ref_driven_by_port(monkeypatch):
    """The reference's optimizers with the port's system build, SCF, forces
    and stress in place of the reference's: the same iterations on the same
    numbers, so the two optimizers' own logic is compared exactly."""
    import pyscf_isdf_tpu.scf as ref_scf_pkg

    def build(ref_cell):
        port_cell = _h2(build_cell)
        return build_scf_system(replace(port_cell, a=np.array(ref_cell.a),
                                        coords=np.array(ref_cell.coords),
                                        mesh=tuple(ref_cell.mesh)), device="cpu")

    monkeypatch.setattr(ref_scf_pkg, "build_scf_system", build)
    monkeypatch.setattr(ref_scf_pkg, "scf_kernel", scf_kernel)
    monkeypatch.setattr(ref_rhf, "rhf_gradient",
                        lambda s, r, **kw: rhf.rhf_gradient(s, r, device="cpu", **kw))
    monkeypatch.setattr(ref_stress, "stress_tensor",
                        lambda s, r, **kw: stress.stress_tensor(s, r, device="cpu", **kw))


def test_optimize_two_fire_steps(ref_driven_by_port):
    """Two FIRE steps of a stretched H2 (LDA): the same energies, forces and
    positions as the reference's FIRE on the same pieces."""
    _, info = optimize(_h2(build_cell, dx=-0.3), xc="lda,vwn", maxsteps=2, device="cpu")
    _, info_ref = ref_optimize(_h2(ref_build_cell, dx=-0.3), xc="lda,vwn", maxsteps=2)
    assert info["nsteps"] == info_ref["nsteps"] == 2
    assert np.abs(np.array(info["traj"]) - np.array(info_ref["traj"])).max() < 1e-12
    assert np.abs(info["positions"] - info_ref["positions"]).max() < 1e-12


def test_optimize_cell_one_step(ref_driven_by_port):
    """One variable-cell step of H2 (HF): the same energy, force and stress
    norms, and the same strained lattice, positions and regenerated mesh."""
    new, info = optimize_cell(_h2(build_cell), xc=None, maxsteps=1, device="cpu")
    new_ref, info_ref = ref_optimize_cell(_h2(ref_build_cell), xc=None, maxsteps=1)
    assert np.abs(np.array(info["traj"]) - np.array(info_ref["traj"])).max() < 1e-12
    assert abs(info["pressure"] - info_ref["pressure"]) < 1e-12
    assert np.abs(new.a - new_ref.a).max() < 1e-12
    assert np.abs(new.coords - new_ref.coords).max() < 1e-12
    assert new.mesh == tuple(new_ref.mesh)

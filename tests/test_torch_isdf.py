"""Port ISDF (K2's plain path, robust K, the build) == JAX reference.

All in float64 on the CPU; K2 runs through its plain torch version (the
CUDA kernel is held against it on the card by chip_smoke.py).
Tolerances: 1e-10 where both sides evaluate the same products on the
same factorization (summation order only); 1e-9 for the port's own ISDF
against its FFTDF at saturated rank (n_ip above the AO-pair rank, so the
fit is exact up to the Cholesky regularization), as in tests/test_isdf.py.

The CVT selection is held on the grid points moved by a seeded jitter of
0.01 Bohr: on the uniform grid the first Lloyd assignment has exact ties
(points equidistant from two grid-point seeds), which the reference's fused
XLA distance and the port's break differently at round-off
(test_cvt_ties_on_uniform_grid names them). Bars there: centroids 1e-12
Bohr against a jitted copy of the reference's Lloyd loop, whose indices
equal the reference's; indices equal.
"""
from functools import partial
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu.df import isdf as ref_isdf  # noqa: E402
from pyscf_isdf_tpu.ops import interp_points as ref_ip  # noqa: E402
from pyscf_isdf_tpu.ops.pallas_robust_k import robust_k_cross as ref_cross  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.convert import isdf_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.df import fftdf, isdf  # noqa: E402
from pyscf_isdf_tpu_torch.ops import interp_points  # noqa: E402
from pyscf_isdf_tpu_torch.ops.cuda_robust_k import robust_k_cross  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system  # noqa: E402
from pyscf_isdf_tpu_torch.scf.hf import make_rdm1, orthogonalizer  # noqa: E402

MESH = (12, 12, 12)
# diamond primitive with the second atom moved off its site: no symmetry
# pins the density, so the SCF takes several cycles
A = [[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834], [1.7834, 1.7834, 0.0]]
ATOMS = [["C", (0.0, 0.0, 0.0)], ["C", (0.93, 0.87, 0.90)]]


def _cell(build):
    return build(A, ATOMS, "gth-szv", pseudo="gth-pade", mesh=MESH,
                 unit="Angstrom")


@pytest.mark.parametrize("ng,nao,nip,tg,tp,seed",
                         [(1000, 30, 200, 256, 64, 0),   # tile-divisible
                          (777, 11, 70, 128, 32, 1),     # padded ng and n_ip
                          (300, 300, 40, 128, 32, 2)])   # nao > 256
def test_cross_term_plain_vs_pallas(ng, nao, nip, tg, tp, seed):
    rng = np.random.default_rng(seed)
    aoR = rng.standard_normal((ng, nao))
    B = rng.standard_normal((nip, nao))
    Vxi = rng.standard_normal((nip, ng))
    ref = np.asarray(ref_cross(jnp.asarray(aoR), jnp.asarray(B),
                               jnp.asarray(Vxi), tg=tg, tp=tp, interpret=True))
    out = robust_k_cross(torch.as_tensor(aoR), torch.as_tensor(B),
                         torch.as_tensor(Vxi)).numpy()
    assert np.abs(out - ref).max() < 1e-10 * np.abs(ref).max()


@pytest.fixture(scope="module")
def factorization():
    """The reference's robust-fit ISDF and a random density, in numpy."""
    system = ref_build(_cell(ref_build_cell))
    f = ref_isdf.build_isdf(system.aoR, jnp.asarray(system.coulG),
                            system.mesh, system.weight, c=8, keep_v=True)
    rng = np.random.default_rng(3)
    C = rng.standard_normal((system.aoR.shape[1], 4))
    dm = C @ C.T
    return system, f, dm


def test_robust_k_on_reference_factorization(factorization):
    system, f, dm = factorization
    port = isdf_from_numpy(f.aoRg, f.W, f.ip_idx, f.Vxi, device="cpu")
    aoR = torch.as_tensor(np.array(system.aoR))
    dmt = torch.as_tensor(dm)
    dmj = jnp.asarray(dm)
    pairs = [
        (isdf.get_k_robust(port, aoR, dmt, system.weight),
         ref_isdf.get_k_robust(f, system.aoR, dmj, system.weight)),
        (isdf.get_k(port, dmt), ref_isdf.get_k(f, dmj)),
        (isdf.get_j(port, dmt), ref_isdf.get_j(f, dmj)),
    ]
    for out, ref in pairs:
        ref = np.asarray(ref)
        assert np.abs(out.numpy() - ref).max() < 1e-10 * np.abs(ref).max()


def test_build_isdf_multi(factorization):
    """One IP selection and xi fit, full-range and long-range kernels: the
    same points, W and Vxi as the reference (1e-10 relative; c=4 keeps the
    Gram of the 12^3 cell's 36 AO pairs well conditioned)."""
    from pyscf_isdf_tpu_torch.ops import coulomb

    system = factorization[0]
    coulGs = [np.asarray(system.coulG),
              coulomb.get_coulG(_cell(build_cell), omega=0.11)]
    refs = ref_isdf.build_isdf_multi(system.aoR, [jnp.asarray(g) for g in coulGs],
                                     system.mesh, system.weight, c=4, keep_v=True)
    outs = isdf.build_isdf_multi(torch.as_tensor(np.array(system.aoR)), coulGs,
                                 system.mesh, system.weight, c=4, keep_v=True)
    for out, ref in zip(outs, refs):
        assert np.array_equal(out.ip_idx.numpy(), np.asarray(ref.ip_idx))
        for a, b in ((out.W, ref.W), (out.Vxi, ref.Vxi)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() < 1e-10 * np.abs(b).max()


@pytest.mark.parametrize("method,tol", [("cholesky", 1e-9),
                                        ("cholesky-blocked", 1e-8)])
def test_port_isdf_matches_port_fftdf(method, tol):
    """The port's own build at saturated rank reproduces its FFTDF J/K
    (blocked selection: 1e-8, as in the reference's test)."""
    system = build_scf_system(_cell(build_cell), device="cpu")
    X = orthogonalizer(system.S)
    dm = make_rdm1(X @ torch.linalg.eigh(X.T @ system.hcore @ X)[1],
                   system.nelec // 2)                # core-guess density
    args = (system.aoR, dm, system.coulG, system.mesh, system.weight)
    f = isdf.build_isdf(system.aoR, system.coulG, system.mesh, system.weight,
                        c=8, method=method, keep_v=True)
    vk_ref = fftdf.get_k(*args)
    assert (isdf.get_k(f, dm) - vk_ref).abs().max() < tol
    assert (isdf.get_k_robust(f, system.aoR, dm, system.weight)
            - vk_ref).abs().max() < tol
    assert (isdf.get_j(f, dm) - fftdf.get_j(*args)).abs().max() < tol


@partial(jax.jit, static_argnames=("n_ip",))
def _ref_draw(rho, n_ip, seed=0):
    """The reference's initial CVT centres: its jax.random.choice call
    (pyscf_isdf_tpu/ops/interp_points.py:158-163), jitted as there."""
    return jax.random.choice(jax.random.PRNGKey(seed), rho.shape[0], shape=(n_ip,),
                             replace=False, p=rho / jnp.sum(rho))


@partial(jax.jit, static_argnames=("n_ip", "n_iter"))
def _ref_lloyd(coords, rho, init_idx, n_ip, n_iter=30):
    """The reference's Lloyd loop (interp_points.py:164-175), jitted as
    there, returning its centroids beside its indices."""
    def lloyd(_, centers):
        d2 = jnp.sum((coords[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
        onehot = jax.nn.one_hot(jnp.argmin(d2, axis=1), n_ip, dtype=coords.dtype)
        wsum = onehot.T @ rho
        wcoords = onehot.T @ (coords * rho[:, None])
        return jnp.where(wsum[:, None] > 0, wcoords / wsum[:, None], centers)

    centers = jax.lax.fori_loop(0, n_iter, lloyd, coords[init_idx])
    d2 = jnp.sum((coords[:, None, :] - centers[None, :, :]) ** 2, axis=-1)
    return centers, jnp.argmin(d2, axis=0)


@pytest.fixture(scope="module")
def cvt_inputs(factorization):
    """Uniform and jittered grid coordinates, and the density of the
    fixture's density matrix on the grid."""
    system, _, dm = factorization
    coords = np.asarray(_cell(ref_build_cell).uniform_grid())
    jitter = coords + np.random.default_rng(7).uniform(-0.01, 0.01, coords.shape)
    aoR = np.asarray(system.aoR)
    return coords, jitter, np.einsum("gi,ij,gj->g", aoR, dm, aoR)


def test_cvt_points(cvt_inputs):
    _, coords, rho = cvt_inputs
    n_ip = 32                     # c=4, as the build below: shared compiles
    init = np.array(_ref_draw(jnp.asarray(rho), n_ip=n_ip))
    c0, i0 = _ref_lloyd(jnp.asarray(coords), jnp.asarray(rho), jnp.asarray(init), n_ip=n_ip)
    ref = np.asarray(ref_ip.cvt_points(jnp.asarray(coords), jnp.asarray(rho), n_ip))
    assert np.array_equal(np.asarray(i0), ref)
    ct, rt = torch.as_tensor(coords), torch.as_tensor(rho)
    mp = pytest.MonkeyPatch()
    mp.setattr(interp_points, "CHUNK_ROWS", 500)   # 4 blocks, the last partial
    try:
        centers = interp_points.cvt_centroids(ct, rt, n_ip, init_idx=init)
        out = interp_points.cvt_points(ct, rt, n_ip, init_idx=init)
    finally:
        mp.undo()
    assert np.abs(centers.numpy() - np.asarray(c0)).max() < 1e-12
    assert np.array_equal(out.numpy(), ref)
    # the port's own draw: rho-weighted, without replacement, reproducible
    a = interp_points.cvt_points(ct, rt, n_ip, seed=3)
    assert torch.equal(a, interp_points.cvt_points(ct, rt, n_ip, seed=3))


def test_cvt_ties_on_uniform_grid(cvt_inputs):
    """On the uniform grid the first assignment to the grid-point seeds has
    exact ties; wherever the port's assignment differs from the reference's
    fused XLA distance, the two nearest seeds tie within 1e-12 relative."""
    coords, _, rho = cvt_inputs
    n_ip = 32
    seeds = coords[np.array(_ref_draw(jnp.asarray(rho), n_ip=n_ip))]
    d2 = jax.jit(lambda x, c: jnp.sum((x[:, None, :] - c[None, :, :]) ** 2, axis=-1))
    ref_assign = np.asarray(jnp.argmin(d2(jnp.asarray(coords), jnp.asarray(seeds)), axis=1))
    d = interp_points._sq_dist(torch.as_tensor(coords), torch.as_tensor(seeds))
    port_assign = d.argmin(1).numpy()
    d = d.numpy()
    rows = np.arange(len(coords))
    ties = np.abs(d[rows, ref_assign] - d[rows, port_assign]) <= 1e-12 * d[rows, port_assign]
    assert np.all(ties | (ref_assign == port_assign))
    assert np.any(ref_assign != port_assign)   # the hazard is real on this grid


@pytest.mark.parametrize("method", ["cvt", "atomic"])
def test_build_isdf_cvt_atomic(factorization, cvt_inputs, method):
    """The whole build with each selection (jittered coordinates for CVT,
    the reference's draw handed in), c=4: the same points, W and Vxi
    within 1e-10 relative."""
    system, _, _ = factorization
    _, coords, rho = cvt_inputs
    atoms = _cell(ref_build_cell).coords
    kw = dict(coords=coords, rho=rho) if method == "cvt" else \
        dict(coords=coords, atom_coords=atoms)
    ref = ref_isdf.build_isdf(system.aoR, jnp.asarray(system.coulG), system.mesh,
                              system.weight, c=4, method=method, keep_v=True, **kw)
    mp = pytest.MonkeyPatch()
    if method == "cvt":
        init = np.array(_ref_draw(jnp.asarray(rho), n_ip=len(ref.ip_idx)))
        mp.setattr(isdf, "cvt_points",
                   partial(interp_points.cvt_points, init_idx=init))
    try:
        out = isdf.build_isdf(torch.as_tensor(np.array(system.aoR)), system.coulG,
                              system.mesh, system.weight, c=4, method=method,
                              keep_v=True, **kw)
    finally:
        mp.undo()
    assert np.array_equal(out.ip_idx.numpy(), np.asarray(ref.ip_idx))
    for a, b in ((out.W, ref.W), (out.Vxi, ref.Vxi)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() < 1e-10 * np.abs(b).max()
    with pytest.raises(ValueError, match="needs"):
        isdf.build_isdf(out.aoRg, system.coulG, system.mesh, system.weight,
                        method=method)


def test_atomic_points_voronoi_is_not_periodic(cvt_inputs):
    """The reference assigns grid points to atoms by the plain distance to
    the atom positions as given, not to the nearest periodic image; the
    port keeps that for parity. On this cell some points lie nearer an
    image of the atom they are not given to."""
    coords, _, _ = cvt_inputs
    cell = _cell(build_cell)
    atoms = cell.coords
    plain = ((coords[:, None] - atoms[None]) ** 2).sum(-1).argmin(1)
    images = (atoms[None, :, None] + cell.lattice_images()[None, None]).reshape(1, -1, 3)
    nearest = ((coords[:, None] - images) ** 2).sum(-1).argmin(1) \
        // len(cell.lattice_images())
    assert np.any(plain != nearest)


def test_robust_k_error(factorization):
    """The residual certificate against the reference on the reference's
    c=2 factorization (1e-10 relative), and the identity it rests on for
    the port's own build: tr(D (K_fftdf - K_robust)), D = C_w C_w^T."""
    ref_sys = factorization[0]
    f0 = ref_isdf.build_isdf(ref_sys.aoR, jnp.asarray(ref_sys.coulG), ref_sys.mesh,
                             ref_sys.weight, c=2, keep_v=True)
    C_w = np.random.default_rng(5).standard_normal((ref_sys.aoR.shape[1], 4))
    args = (ref_sys.coulG, ref_sys.mesh, ref_sys.weight)
    e0 = ref_isdf.robust_k_error(f0, ref_sys.aoR, C_w, jnp.asarray(args[0]), *args[1:])
    aoR = torch.as_tensor(np.array(ref_sys.aoR))
    port_f0 = isdf_from_numpy(f0.aoRg, f0.W, f0.ip_idx, f0.Vxi, device="cpu")
    assert e0 > 0
    assert abs(isdf.robust_k_error(port_f0, aoR, C_w, *args) - e0) < 1e-10 * e0
    f = isdf.build_isdf(aoR, ref_sys.coulG, ref_sys.mesh, ref_sys.weight, c=2,
                        keep_v=True)
    dm = torch.as_tensor(C_w @ C_w.T)
    coulG = torch.as_tensor(ref_sys.coulG)
    vk = fftdf.get_k(aoR, dm, coulG, ref_sys.mesh, ref_sys.weight) \
        - isdf.get_k_robust(f, aoR, dm, ref_sys.weight)
    direct = float(torch.einsum("ij,ji->", dm, vk))
    e = isdf.robust_k_error(f, aoR, C_w, *args)
    assert abs(e - direct) < 1e-8 * e

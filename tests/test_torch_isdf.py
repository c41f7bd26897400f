"""Port ISDF (K2's plain path, robust K, the build) == JAX reference.

All in float64 on the CPU; K2 runs through its plain torch version (the
CUDA kernel is held against it on the card by chip_smoke.py).
Tolerances: 1e-10 where both sides evaluate the same products on the
same factorization (summation order only); 1e-9 for the port's own ISDF
against its FFTDF at saturated rank (n_ip above the AO-pair rank, so the
fit is exact up to the Cholesky regularization), as in tests/test_isdf.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu.df import isdf as ref_isdf  # noqa: E402
from pyscf_isdf_tpu.ops.pallas_robust_k import robust_k_cross as ref_cross  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.convert import isdf_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.df import fftdf, isdf  # noqa: E402
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

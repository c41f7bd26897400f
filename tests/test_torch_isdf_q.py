"""Port k-point ISDF engines (shared-xi isdf_k, q-resolved isdf_q) == JAX
reference.

Diamond primitive, 9^3 mesh, shifted (1,1,2) k-mesh: k = +-b3/4, neither
zero nor its own inverse. Both packages start from the reference's Bloch
AOs (eval_ao_numpy, as its build_kscf_system makes them), so near-tied
pivots of the IP selection cannot break differently. All float64 on the
CPU.

Bars: equal interpolation-point indices; factorizations within 1e-10
relative at compressions where the regularized Gram is well conditioned
(c=2 for isdf_k, c=4 for isdf_q: at c=8 the 1e-12 shift leaves a
condition number near 1e12, and two Cholesky orderings then need not
agree to 1e-10 in Xq); exchange, Coulomb, the phased kernel and the
certificates within 1e-10 relative, at c=8 on the reference's own
factorization. The CVT build is held with the CVT points themselves fixed
to the reference's (the selection is held in test_torch_isdf.py: on the
uniform grid its first Lloyd step has exact ties that the two packages
break differently at round-off).
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.df import isdf_k as ref_isdf_k, isdf_q as ref_isdf_q  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import coulomb as ref_coulomb  # noqa: E402
from pyscf_isdf_tpu.ops.ao_eval import eval_ao_numpy  # noqa: E402

from pyscf_isdf_tpu_torch.convert import isdfq_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.df import isdf_k, isdf_q  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402

MESH = (9, 9, 9)


def rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(out.numpy() - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def systems():
    """What the engines take, per package: aoR_k, grid weight and mesh."""
    rcell = ref_diamond(mesh=MESH)
    kpts = ref_lattice.make_kpts(rcell.a, [1, 1, 2], with_gamma_point=False)
    aoR_k = np.stack([eval_ao_numpy(rcell, kpt=k) for k in kpts])
    ref = SimpleNamespace(aoR_k=jnp.asarray(aoR_k), weight=rcell.grid_weight,
                          mesh=tuple(rcell.mesh))
    cell = diamond_primitive(mesh=MESH)
    port = SimpleNamespace(aoR_k=torch.as_tensor(aoR_k), weight=cell.grid_weight,
                           mesh=tuple(cell.mesh))
    rng = np.random.default_rng(11)
    C = rng.standard_normal((2, cell.nao, 4)) + 1j * rng.standard_normal((2, cell.nao, 4))
    return rcell, ref, cell, port, kpts, C


def test_unique_q(systems):
    rcell, _, cell, _, kpts, _ = systems
    for port_fn, ref_fn in ((isdf_q.unique_q, ref_isdf_q.unique_q),
                            (isdf_k.unique_q, ref_isdf_k.unique_q)):
        q, qmap = port_fn(cell, kpts)
        q0, qmap0 = ref_fn(rcell, kpts)
        assert np.array_equal(qmap, qmap0) and np.abs(q - q0).max() < 1e-12


def test_isdf_k_build_and_exchange(systems):
    rcell, ref, cell, port, kpts, C = systems
    f0 = ref_isdf_k.build_isdf_k(rcell, ref.aoR_k, kpts, c=2, keep_xi=True)
    f = isdf_k.build_isdf_k(cell, port.aoR_k, kpts, c=2, keep_xi=True)
    assert np.array_equal(f.ip_idx.numpy(), np.asarray(f0.ip_idx))
    assert rel(f.Ug, f0.Ug) < 1e-10 and rel(f.Wq, f0.Wq) < 1e-10
    dm = C @ C.conj().transpose(0, 2, 1)
    assert rel(isdf_k.get_k_kpts(f, torch.as_tensor(dm)),
               ref_isdf_k.get_k_kpts(f0, dm)) < 1e-10
    q, G = kpts[1] - kpts[0], cell.reciprocal_vectors()[2]
    assert rel(isdf_k.w_phased(f, cell, q, G, kpts),
               ref_isdf_k.w_phased(f0, rcell, q, G, kpts)) < 1e-10


@pytest.mark.parametrize("method", ["cholesky", "cholesky-blocked"])
def test_isdf_q_build(systems, method):
    rcell, ref, cell, port, kpts, _ = systems
    f0 = ref_isdf_q.build_isdf_q(rcell, ref.aoR_k, kpts, c=4, keep_x=True,
                                 method=method, blk=8)
    f = isdf_q.build_isdf_q(cell, port.aoR_k, kpts, c=4, keep_x=True,
                            method=method, blk=8)
    assert np.array_equal(f.ip_idx.numpy(), np.asarray(f0.ip_idx))
    for name in ("Ag", "Wq", "Xq", "VXq", "phase_q"):
        assert rel(getattr(f, name), getattr(f0, name)) < 1e-10, name


@pytest.fixture(scope="module")
def reference_factorization(systems):
    """The reference's c=8 factorization, the port's copy of it, a
    random Hermitian density and sqrt(occ)-scaled orbitals."""
    rcell, ref, cell, port, kpts, C = systems
    f0 = ref_isdf_q.build_isdf_q(rcell, ref.aoR_k, kpts, c=8, keep_x=True)
    f = isdfq_from_numpy(f0.Ag, f0.Wq, f0.qmap, f0.ip_idx, f0.Xq, f0.VXq,
                         f0.phase_q, device="cpu")
    return f0, f, C @ C.conj().transpose(0, 2, 1)


def test_isdf_q_exchange(systems, reference_factorization):
    _, ref, _, port, _, _ = systems
    f0, f, dm = reference_factorization
    dmt = torch.as_tensor(dm)
    pairs = [
        (isdf_q.get_j_kpts(f, dmt), ref_isdf_q.get_j_kpts(f0, dm)),
        (isdf_q.get_k_kpts(f, dmt), ref_isdf_q.get_k_kpts(f0, dm)),
        (isdf_q.get_k_kpts_robust(f, dmt, port.aoR_k, port.weight),
         ref_isdf_q.get_k_kpts_robust(f0, dm, ref.aoR_k, ref.weight)),
    ]
    for out, ref_out in pairs:
        assert rel(out, ref_out) < 1e-10


def test_deficit_certificates(systems, reference_factorization):
    rcell, ref, _, port, kpts, C = systems
    f0, f, _ = reference_factorization
    q_list, _ = ref_isdf_q.unique_q(rcell, kpts)
    coulG_q = np.stack([ref_coulomb.get_coulG(rcell, k=q, kpts=kpts) for q in q_list])
    psi = np.asarray(ref.aoR_k) @ C
    d0 = ref_isdf_q.deficit_robust(f0, jnp.asarray(psi), kpts, coulG_q,
                                   ref.mesh, ref.weight)
    d_dev = isdf_q.deficit_robust(f, torch.as_tensor(psi), kpts, coulG_q,
                                  port.mesh, port.weight)
    d_host = isdf_q.deficit_robust_numpy(f.Xq.numpy(), f.phase_q.numpy(), f.qmap,
                                         f.ip_idx.numpy(), psi, coulG_q,
                                         port.mesh, port.weight)
    assert d0 > 0
    assert abs(d_dev - d0) < 1e-10 * d0 and abs(d_host - d0) < 1e-10 * d0


def test_isdf_q_build_cvt(systems):
    """method='cvt': the selection runs on the primitive grid weighted by
    the k-averaged AO density (the reference's default rho, 1e-14), and
    with the reference's CVT points the build matches (c=4, 1e-10)."""
    from pyscf_isdf_tpu.ops import interp_points as ref_ip

    rcell, ref, cell, port, kpts, _ = systems
    f0 = ref_isdf_q.build_isdf_q(rcell, ref.aoR_k, kpts, c=4, keep_x=True,
                                 method="cvt")
    rho0 = np.asarray(jnp.mean(jnp.sum(jnp.abs(ref.aoR_k) ** 2, axis=2), axis=0))
    seen = {}

    def fixed_points(coords, rho, n_ip):
        seen.update(coords=coords, rho=rho, n_ip=n_ip)
        return torch.as_tensor(np.array(ref_ip.cvt_points(
            jnp.asarray(coords.numpy()), jnp.asarray(rho.numpy()), n_ip)))

    mp = pytest.MonkeyPatch()
    mp.setattr(isdf_q, "cvt_points", fixed_points)
    try:
        f = isdf_q.build_isdf_q(cell, port.aoR_k, kpts, c=4, keep_x=True, method="cvt")
    finally:
        mp.undo()
    assert seen["n_ip"] == 4 * cell.nao
    assert np.abs(seen["coords"].numpy() - rcell.uniform_grid()).max() < 1e-14
    assert np.abs(seen["rho"].numpy() - rho0).max() < 1e-14 * rho0.max()
    assert np.array_equal(f.ip_idx.numpy(), np.asarray(f0.ip_idx))
    for name in ("Ag", "Wq", "Xq", "VXq", "phase_q"):
        assert rel(getattr(f, name), getattr(f0, name)) < 1e-10, name

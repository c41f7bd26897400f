"""Port restricted open-shell and spinor SCF (rohf_kernel, krohf_kernel,
kghf_kernel) == JAX reference.

Gamma and k-points: the off-symmetry two-carbon cell of the other port
tests on a 10^3 mesh with (n_alpha, n_beta) = (6, 2) (the k-point cases on
its shifted (1,1,2) mesh); every case converges in 8-16 cycles. KGHF: the
same two-carbon cell from a non-collinear start, and the one-hydrogen
chain cell of tests/test_kghf.py for the port's exact limits. All float64 on the CPU.
Bars: SCF energies 1e-8 Ha with equal iteration counts, exchange matrices
1e-10 relative.

To keep the file cheap the reference's spin XC runs under one jax.jit for
LDA and takes the port's pointwise functional for PBE, PBE0 and HSE06
(held to the reference's own in tests/test_torch_xc.py), and its k-point
ISDF exchange, which jits a new closure on every call, runs as one jitted
function of the same products (held to the original at 1e-12 on its first
call), as in tests/test_torch_uhf.py.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.df import fftdf_k as ref_fftdf_k, isdf_k as ref_isdf_k  # noqa: E402
from pyscf_isdf_tpu.ops import xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.scf import krohf as ref_krohf_mod  # noqa: E402
from pyscf_isdf_tpu.scf import hf as ref_hf, khf as ref_khf  # noqa: E402
from pyscf_isdf_tpu.scf.kghf import kghf_kernel as ref_kghf  # noqa: E402
from pyscf_isdf_tpu.scf.rohf import rohf_kernel as ref_rohf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell, lattice  # noqa: E402
from pyscf_isdf_tpu_torch.df import fftdf_k, isdf_k  # noqa: E402
from pyscf_isdf_tpu_torch.ops import xc  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kghf_kernel, krohf_kernel, kscf_kernel,
    kuhf_kernel, rohf_kernel, scf_kernel, uhf_kernel,
)
from pyscf_isdf_tpu_torch.scf.krohf import _occupations  # noqa: E402

MESH = (10, 10, 10)
A = [[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834], [1.7834, 1.7834, 0.0]]
ATOMS = [["C", (0.0, 0.0, 0.0)], ["C", (0.93, 0.87, 0.90)]]
NELEC = (6, 2)
ISDF_C = 10        # one k-point factorization shape: the reference compiles once
TOL = 1e-8
PORT_XC = {"pbe", "pbe0", "hse06"}


def _cell(build):
    return build(A, ATOMS, "gth-szv", pseudo="gth-pade", mesh=MESH, unit="Angstrom")


def _h_chain(build):
    """tests/test_kghf.py's spin-1/2 chain, one H a cell (on a 12x12x8 mesh)."""
    return build(np.diag([6.0, 6.0, 3.0]), [["H", (3.0, 3.0, 1.5)]], basis="gth-szv",
                 pseudo="gth-pade", mesh=[12, 12, 8], spin=1)


def _ref_system(rcell, sys_):
    """The reference's SCFSystem on the port's setup arrays (held to the
    reference's own build in tests/test_torch_host.py, 1e-12)."""
    return ref_hf.SCFSystem(
        cell=rcell, S=sys_.S.numpy(), hcore=sys_.hcore.numpy(), X=sys_.X.numpy(),
        aoR=jnp.asarray(sys_.aoR.numpy()), coulG=sys_.coulG.numpy(),
        madelung=sys_.madelung, e_nuc=sys_.e_nuc, mesh=sys_.mesh, weight=sys_.weight,
        nelec=sys_.nelec, Gv=sys_.Gv.numpy())


def _ref_ksystem(rcell, sys_):
    """The reference's KSCFSystem on the port's setup arrays (held to the
    reference's own build in tests/test_torch_kscf.py, 1e-12): a second
    host build costs more than every comparison here."""
    return ref_khf.KSCFSystem(
        cell=rcell, kpts=sys_.kpts, S=sys_.S.numpy(), hcore=sys_.hcore.numpy(),
        X=np.stack([x.numpy() for x in sys_.X]), aoR_k=jnp.asarray(sys_.aoR_k.numpy()),
        coulG=sys_.coulG.numpy(), coulG_pairs=sys_.coulG_pairs.numpy(),
        expmikr=sys_.expmikr.numpy(), madelung=sys_.madelung, e_nuc=sys_.e_nuc,
        mesh=sys_.mesh, weight=sys_.weight, nelec_tot=sys_.nelec_tot)


def _port_spin_xc(name, args):
    out = xc.XCSpec(name).exc_vxc_spin(*(torch.as_tensor(np.array(a)) for a in args))
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), out)


@partial(jax.jit, static_argnums=3)
def _isdf_k_exchange(Ug, Wq, dm, qmap):
    """The reference's get_k_kpts products (pyscf_isdf_tpu/df/isdf_k.py:
    393-403) for all band k-points, in its order of summation."""
    nk = Ug.shape[0]
    M = [Ug[k] @ dm[k] @ Ug[k].conj().T for k in range(nk)]
    out = []
    for k1 in range(nk):
        acc = jnp.zeros((Ug.shape[2], Ug.shape[2]), Ug.dtype)
        for k2 in range(nk):
            acc = acc + Ug[k1].conj().T @ (M[k2] * Wq[qmap[k2][k1]].conj()) @ Ug[k1]
        out.append(acc / nk)
    return jnp.stack(out)


@pytest.fixture(scope="module", autouse=True)
def _reference_compiled_once():
    spin = jax.jit(ref_xc.XCSpec.exc_vxc_spin, static_argnums=0,
                   compiler_options={"xla_backend_optimization_level": 0})

    def exc_vxc_spin(self, *a):
        if self.name in PORT_XC:
            return _port_spin_xc(self.name, a)
        return spin(self, *a)

    get_k_kpts = ref_isdf_k.get_k_kpts
    checked = []

    def k_kpts(isdfk, dm_k, k1_idx=None):
        assert k1_idx is None
        out = _isdf_k_exchange(isdfk.Ug, isdfk.Wq, jnp.asarray(dm_k, isdfk.Ug.dtype),
                               tuple(map(tuple, np.asarray(isdfk.qmap).tolist())))
        if not checked:
            ref = np.asarray(get_k_kpts(isdfk, dm_k))
            assert np.abs(np.asarray(out) - ref).max() <= 1e-12 * np.abs(ref).max()
            checked.append(True)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_xc.XCSpec, "exc_vxc_spin", exc_vxc_spin)
    mp.setattr(ref_isdf_k, "get_k_kpts", k_kpts)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def gamma():
    sys_ = build_scf_system(_cell(build_cell), device="cpu")
    return _ref_system(_cell(ref_build_cell), sys_), sys_


@pytest.fixture(scope="module")
def kpoint():
    rcell = _cell(ref_build_cell)
    kpts = ref_lattice.make_kpts(rcell.a, [1, 1, 2], with_gamma_point=False)
    sys_ = build_kscf_system(_cell(build_cell), kpts, device="cpu")
    return _ref_ksystem(rcell, sys_), sys_


@pytest.fixture(scope="module")
def chain():
    cell = _h_chain(build_cell)
    kpts = lattice.make_kpts(cell.a, [1, 1, 2], with_gamma_point=True)
    return build_kscf_system(cell, kpts, device="cpu")


def _same(out, ref):
    assert out["converged"] and ref["converged"]
    assert out["niter"] == ref["niter"] > 2
    assert abs(out["e_tot"] - ref["e_tot"]) < TOL


@pytest.mark.parametrize("xc,df", [(None, "fftdf"), ("lda,vwn", "fftdf"), ("pbe", "fftdf"),
                                   ("pbe0", "isdf"), ("hse06", "isdf")])
def test_rohf_energy(gamma, xc, df):
    ref_sys, sys_ = gamma
    out = rohf_kernel(sys_, xc=xc, df=df, nelec=NELEC, conv_tol=1e-10, device="cpu")
    ref = ref_rohf(ref_sys, xc=xc, df=df, nelec=NELEC, conv_tol=1e-10)
    _same(out, ref)
    for f, r in zip(out["fock"], ref["fock"]):
        assert np.abs(f.numpy() - np.asarray(r)).max() < 1e-8


@pytest.mark.parametrize("xc,df", [(None, "isdf"), ("lda,vwn", "fftdf"), ("pbe", "fftdf"),
                                   ("hse06", "isdf")])
def test_krohf_energy(kpoint, xc, df):
    ref_sys, sys_ = kpoint
    kw = dict(xc=xc, df=df, nelec=NELEC, isdf_c=ISDF_C, conv_tol=1e-10)
    out = krohf_kernel(sys_, device="cpu", **kw)
    ref = ref_krohf_mod.krohf_kernel(ref_sys, **kw)
    _same(out, ref)
    for o, r in zip(out["mo_occ"], ref["mo_occ"]):
        assert np.array_equal(o, r)


def test_restricted_limits(gamma, kpoint):
    """Closed-shell ROHF == RHF and KROHF == KRHF; ROKS lies above UKS for
    the open shell (ROKS is constrained UKS)."""
    _, sys_ = gamma
    ro = rohf_kernel(sys_, xc=None, conv_tol=1e-10, device="cpu")
    assert abs(ro["e_tot"] - scf_kernel(sys_, xc=None, conv_tol=1e-10)["e_tot"]) < TOL
    ro = rohf_kernel(sys_, xc="lda,vwn", nelec=NELEC, conv_tol=1e-10, device="cpu")
    u = uhf_kernel(sys_, xc="lda,vwn", nelec=NELEC, conv_tol=1e-10)
    assert u["converged"] and 0.0 <= ro["e_tot"] - u["e_tot"] < 1e-1
    _, ksys = kpoint
    kro = krohf_kernel(ksys, xc="lda,vwn", conv_tol=1e-10, device="cpu")
    kr = kscf_kernel(ksys, xc="lda,vwn", conv_tol=1e-10, device="cpu")
    assert kro["converged"] and abs(kro["e_tot"] - kr["e_tot"]) < TOL


def test_rohf_one_electron_equals_uhf():
    """One electron: ROHF == UHF (tests/test_rohf.py's H atom, 15^3 mesh)."""
    cell = build_cell(np.eye(3) * 6.0, [["H", (3.0, 3.0, 3.0)]],
                      basis=[[0, (1.3, 1.0)], [0, (0.4, 1.0)]], mesh=[15] * 3, spin=1)
    sys_ = build_scf_system(cell, device="cpu")
    ro = rohf_kernel(sys_, conv_tol=1e-10, device="cpu")
    assert ro["converged"]
    assert abs(ro["e_tot"] - uhf_kernel(sys_, conv_tol=1e-10)["e_tot"]) < 1e-10


def test_krohf_degenerate_fill_count():
    """A degenerate last doubly occupied level: the reference's threshold
    fill puts 9 electrons in where 5 are asked (ROADMAP queue 3 (k)); the
    port counts exactly, in the order of a stable sort."""
    e_k = [np.array([-1.0, -0.5, -0.5, 0.2]), np.array([-0.5, 0.3, 0.4, 0.6])]
    out = _occupations(e_k, 2, 1)
    assert [o.tolist() for o in out] == [[2.0, 2.0, 1.0, 0.0], [0.0] * 4]
    ref = ref_krohf_mod._occupations(e_k, 2, 1)
    assert [o.tolist() for o in ref] == [[2.0, 2.0, 2.0, 1.0], [2.0, 0.0, 0.0, 0.0]]
    # no degeneracy at the fill: the two agree
    e_k = [np.array([-1.0, -0.6, -0.5, 0.2]), np.array([-0.9, -0.4, 0.3, 0.4])]
    for o, r in zip(_occupations(e_k, 3, 1), ref_krohf_mod._occupations(e_k, 3, 1)):
        assert np.array_equal(o, r)


def test_non_hermitian_block_exchange(kpoint):
    """A random non-Hermitian density through both k-point engines of both
    packages (the KGHF off-diagonal spin blocks): 1e-10 relative."""
    ref_sys, sys_ = kpoint
    nk, nao = sys_.S.shape[0], sys_.S.shape[1]
    rng = np.random.default_rng(7)
    dm = rng.standard_normal((nk, nao, nao)) + 1j * rng.standard_normal((nk, nao, nao))
    dm_t = torch.as_tensor(dm)
    kw = sys_.weight / nk
    out = fftdf_k.get_k_kpts(sys_.aoR_k, dm_t, sys_.coulG_pairs, sys_.expmikr, sys_.mesh, kw)
    ref = np.asarray(ref_fftdf_k.get_k_kpts(ref_sys.aoR_k, jnp.asarray(dm),
                                            jnp.asarray(ref_sys.coulG_pairs),
                                            jnp.asarray(ref_sys.expmikr), ref_sys.mesh, kw))
    assert np.abs(out.numpy() - ref).max() < 1e-10 * np.abs(ref).max()
    # complex-linear, not conjugate-linear: K[i D] = i K[D]
    assert np.abs(fftdf_k.get_k_kpts(sys_.aoR_k, 1j * dm_t, sys_.coulG_pairs, sys_.expmikr,
                                     sys_.mesh, kw).numpy() - 1j * ref).max() \
        < 1e-10 * np.abs(ref).max()
    fac = isdf_k.build_isdf_k(sys_.cell, sys_.aoR_k, sys_.kpts, c=ISDF_C)
    out = isdf_k.get_k_kpts(fac, dm_t).numpy()
    ref = np.asarray(_isdf_k_exchange(jnp.asarray(fac.Ug.numpy()), jnp.asarray(fac.Wq.numpy()),
                                      jnp.asarray(dm),
                                      tuple(map(tuple, np.asarray(fac.qmap).tolist()))))
    assert np.abs(out - ref).max() < 1e-10 * np.abs(ref).max()


def _spinor_dm(dm_a, dm_b, theta):
    """(D_a, D_b) in the diagonal blocks, rotated about y by ``theta``
    (populates the non-Hermitian off-diagonal blocks)."""
    nk, nao = dm_a.shape[0], dm_a.shape[1]
    dm = np.zeros((nk, 2 * nao, 2 * nao), dtype=np.complex128)
    dm[:, :nao, :nao], dm[:, nao:, nao:] = dm_a, dm_b
    U = np.kron(np.array([[np.cos(theta / 2), -np.sin(theta / 2)],
                          [np.sin(theta / 2), np.cos(theta / 2)]]), np.eye(nao))
    return np.einsum("ij,kjl,ml->kim", U, dm, U.conj())


def test_kghf(kpoint, chain):
    """KGHF from a non-collinear start (a (6, 2) KUHF density two cycles
    in, rotated about y) against the reference (isdf) and against the
    port's fftdf; its exact limits on the one-hydrogen chain: the
    collinear KUHF state = KUHF, the rotated one keeps the energy, the
    default start holds the odd electron count."""
    ref_sys, sys_ = kpoint
    u2 = kuhf_kernel(sys_, nelec=NELEC, max_cycle=2, df="isdf", device="cpu")
    start = _spinor_dm(u2["dm"][0].numpy(), u2["dm"][1].numpy(), 0.7)
    out = kghf_kernel(sys_, dm0=start, df="isdf", isdf_c=ISDF_C, conv_tol=1e-10,
                      device="cpu")
    ref = ref_kghf(ref_sys, dm0=start, df="isdf", isdf_c=ISDF_C, conv_tol=1e-10)
    _same(out, ref)
    assert np.allclose(out["spin"], ref["spin"], atol=1e-8) and abs(out["spin"][0]) > 0.1
    exact = kghf_kernel(sys_, dm0=start, conv_tol=1e-10, device="cpu")
    assert exact["converged"] and abs(exact["e_tot"] - out["e_tot"]) < 5e-7

    sys_ = chain
    u = kuhf_kernel(sys_, conv_tol=1e-11, device="cpu")
    col = kghf_kernel(sys_, dm0=_spinor_dm(u["dm"][0].numpy(), u["dm"][1].numpy(), 0.0),
                      conv_tol=1e-11, device="cpu")
    assert abs(col["e_tot"] - u["e_tot"]) < TOL and abs(col["spin"][2] - 0.5) < 1e-6
    rot = kghf_kernel(sys_, dm0=_spinor_dm(u["dm"][0].numpy(), u["dm"][1].numpy(), 0.7),
                      conv_tol=1e-11, device="cpu")
    assert abs(rot["e_tot"] - u["e_tot"]) < TOL and abs(rot["spin"][0]) > 0.1
    odd = kghf_kernel(sys_, conv_tol=1e-9, device="cpu")
    nk = sys_.S.shape[0]
    ne = sum(float(torch.trace(odd["dm"][k] @ torch.block_diag(sys_.S[k], sys_.S[k])).real)
             for k in range(nk)) / nk
    assert odd["converged"] and abs(ne - 1.0) < 1e-8


def test_kghf_closed_shell_equals_krhf(kpoint):
    _, sys_ = kpoint
    g = kghf_kernel(sys_, df="isdf", conv_tol=1e-10, device="cpu")
    r = kscf_kernel(sys_, df="isdf", conv_tol=1e-10, device="cpu")
    assert g["converged"] and abs(g["e_tot"] - r["e_tot"]) < TOL
    assert max(abs(s) for s in g["spin"]) < 1e-6


def test_options_raise(gamma, kpoint):
    ref_sys, sys_ = gamma
    with pytest.raises(ValueError, match="xc_grids"):
        rohf_kernel(sys_, xc="lda", xc_grids="lebedev", device="cpu")
    _, ksys = kpoint
    with pytest.raises(NotImplementedError):
        krohf_kernel(ksys, df="isdf", isdf_precision="dd", device="cpu")
    with pytest.raises(ValueError, match="meta-GGA"):
        krohf_kernel(ksys, xc="scan", device="cpu")
    for fn in (krohf_kernel, kghf_kernel):
        with pytest.raises(ValueError):
            fn(ksys, df="gdf", device="cpu")

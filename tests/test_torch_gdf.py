"""Port Gaussian density fitting on the grid (df/gdf.py, Gamma and k-point,
and ``df='gdf'`` in scf_kernel and kscf_kernel), the analytic pair
transforms (ops/ft_ao.ft_aopair) and AFTDF / KAFTDF == JAX reference.

Cells: the diamond primitive cell on a 9^3 mesh (Gamma, and the shifted
(1,1,2) k-mesh of the other k-point port tests), and the compact
two-carbon cell of tests/test_aftdf.py on a 12^3 mesh. Float64 on the
CPU. The port assembles j2c and j3c from the auxiliary functions'
potentials in real space (Parseval) where the reference contracts pair
transforms in G space, and each whitens by its own eigenvectors, whose
signs and rotations within degenerate spaces are arbitrary: the fits are
compared through the fitted ERIs and J/K at a density, never raw cderi.
Bars: 1e-12 for the auxiliary basis and ft_aopair; 1e-10 relative for
fitted ERIs and J/K; 1e-8 Ha for SCF energies converged to 1e-10, with
equal iteration counts.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.df import aftdf as ref_aftdf, gdf as ref_gdf  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.ops.ft_ao import ft_aopair as ref_ft_aopair  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf import scf_kernel as ref_scf  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_kbuild  # noqa: E402
from pyscf_isdf_tpu.scf.khf import kscf_kernel as ref_kscf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.df import aftdf, gdf  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ft_ao import ft_aopair  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, scf_kernel,
)

TOL = 1e-12
REL = 1e-10
E_TOL = 1e-8
MESH = (9, 9, 9)


@pytest.fixture(scope="module", autouse=True)
def _reference_xc_compiled_once():
    closed = jax.jit(ref_xc.XCSpec.exc_vxc, static_argnums=0)
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_xc.XCSpec, "exc_vxc", lambda self, *a: closed(self, *a))
    yield
    mp.undo()


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def _compact(build):
    return build(np.eye(3) * 5.0, [["C", (1.0, 2.0, 2.4)], ["C", (3.1, 2.2, 2.0)]],
                 basis=[[0, (2.0, 1.0)], [0, (0.9, 1.0)], [1, (1.1, 1.0)]],
                 pseudo="gth-pade", mesh=[12] * 3)


@functools.lru_cache(maxsize=None)
def _gamma():
    rcell, cell = ref_diamond(mesh=MESH), diamond_primitive(mesh=MESH)
    return rcell, ref_build(rcell), cell, build_scf_system(cell, device="cpu")


@functools.lru_cache(maxsize=None)
def _kpoint():
    rcell, cell = ref_diamond(mesh=MESH), diamond_primitive(mesh=MESH)
    kpts = ref_lattice.make_kpts(rcell.a, [1, 1, 2], with_gamma_point=False)
    return (rcell, ref_kbuild(rcell, kpts), cell,
            build_kscf_system(cell, kpts, device="cpu"), kpts)


def _density(n, seed, hermitian_k=0):
    rng = np.random.default_rng(seed)
    if not hermitian_k:
        d = rng.normal(size=(n, n))
        return d + d.T
    d = rng.normal(size=(hermitian_k, n, n)) + 1j * rng.normal(size=(hermitian_k, n, n))
    return d + d.conj().transpose(0, 2, 1)


def test_aux_basis():
    rcell, _, cell, _ = _gamma()
    assert gdf.aug_etb_spec(cell) == ref_gdf.aug_etb_spec(rcell)
    aux, raux = gdf.make_auxcell(cell), ref_gdf.make_auxcell(rcell)
    assert aux.nao == raux.nao
    for s, r in zip(aux.shells, raux.shells):
        assert s.l == r.l and np.abs(s.coeffs - r.coeffs).max() < TOL


def test_gdf_eri_and_jk():
    rcell, rsys, cell, sys_ = _gamma()
    ref = ref_gdf.build_gdf(rcell, rsys.aoR, jnp.asarray(rsys.coulG), rsys.mesh,
                            rsys.weight)
    out = gdf.build_gdf(cell, sys_.aoR, sys_.coulG, sys_.mesh, sys_.weight)
    assert out.naux == ref.naux
    assert _rel(gdf.get_eri(out), ref_gdf.get_eri(ref)) < REL
    dm = _density(cell.nao, 0)
    vj, vk = gdf.get_jk(out, torch.as_tensor(dm))
    vj0, vk0 = ref_gdf.get_jk(ref, jnp.asarray(dm))
    assert _rel(vj, vj0) < REL and _rel(vk, vk0) < REL


@pytest.mark.parametrize("xc", ["hse06"])
def test_gdf_scf(xc):
    """RKS on the fit, HSE06: the full-range fit and a second fit in the
    long-range metric."""
    _, rsys, _, sys_ = _gamma()
    ref = ref_scf(rsys, xc=xc, df="gdf", conv_tol=1e-10)
    out = scf_kernel(sys_, xc=xc, df="gdf", conv_tol=1e-10)
    assert ref["converged"] and out["converged"]
    assert abs(out["e_tot"] - ref["e_tot"]) < E_TOL
    assert out["niter"] == ref["niter"]
    assert 0 < out["gdf"].naux <= gdf.make_auxcell(sys_.cell).nao


def test_gdf_kscf():
    """KRHF on the k-point fit: every (k1, k2) pair's fit and J/K."""
    _, rsys, _, sys_, _ = _kpoint()
    ref = ref_kscf(rsys, xc=None, df="gdf", conv_tol=1e-10)
    out = kscf_kernel(sys_, xc=None, df="gdf", conv_tol=1e-10, device="cpu")
    assert ref["converged"] and out["converged"]
    assert abs(out["e_tot"] - ref["e_tot"]) < E_TOL
    assert out["niter"] == ref["niter"]


@pytest.mark.parametrize("q,kj", [(None, None), ((0.1, -0.2, 0.3), (0.3, 0.1, -0.2))])
def test_ft_aopair(q, kj):
    rcell, cell = _compact(ref_build_cell), _compact(build_cell)
    Gv = cell.get_Gv()[::7]
    kw = {} if q is None else dict(q=np.asarray(q), kj=np.asarray(kj))
    ref = ref_ft_aopair(rcell, Gv, **kw)
    out = ft_aopair(cell, Gv, **kw)
    assert np.abs(out - ref).max() < TOL


@pytest.mark.parametrize("exxdiv", [None, "ewald"])
def test_aftdf_jk(exxdiv):
    rcell, cell = _compact(ref_build_cell), _compact(build_cell)
    dm = _density(cell.nao, 2)
    vj0, vk0 = ref_aftdf.AFTDF(rcell).get_jk(dm, exxdiv=exxdiv)
    vj, vk = aftdf.AFTDF(cell, device="cpu").get_jk(dm, exxdiv=exxdiv)
    assert _rel(vj, vj0) < REL and _rel(vk, vk0) < REL


def test_kaftdf_jk():
    rcell, cell = _compact(ref_build_cell), _compact(build_cell)
    kpts = ref_lattice.make_kpts(rcell.a, [2, 1, 1], with_gamma_point=False)
    dm = _density(cell.nao, 3, hermitian_k=len(kpts))
    vj0, vk0 = ref_aftdf.KAFTDF(rcell, kpts).get_jk(dm, exxdiv="vcut_sph")
    vj, vk = aftdf.KAFTDF(cell, kpts, device="cpu").get_jk(dm, exxdiv="vcut_sph")
    assert _rel(vj, vj0) < REL and _rel(vk, vk0) < REL

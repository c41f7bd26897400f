"""Port Becke atomic-grid XC quadrature (ops/becke.py and the five drivers'
``xc_grids='becke[:n_rad,n_theta]'``) == JAX reference.

Cells: the diamond primitive cell on a 9^3 mesh (Gamma, and the shifted
(1,1,2) k-mesh of the other k-point port tests) and the off-symmetry
two-carbon cell of tests/test_torch_uhf.py on its 10^3 mesh with
(n_alpha, n_beta) = (6, 2), at small radial and angular grids
(12 x (5 x 10)). Float64 on the CPU. Bars: 1e-12 for the radial and
angular nodes, the point cloud, its weights, and the AO values (K1's plain
version on slabs with the 1e-16 cull) and gradients on it; 1e-8 Ha for SCF
energies converged to 1e-10, with equal iteration counts.

The reference builds its grid with one XLA compile per atom and jits its
AO evaluator anew for every call (2-4 s each on one core): here each of
its clouds and AO sets is built once and handed to its drivers again
(held by cell and arguments), its packed basis is one object per cell
(so its evaluator compiles once a cloud), and its closed-shell and spin
XC run under one jax.jit each.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import becke as ref_becke, xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf import scf_kernel as ref_scf  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_kbuild  # noqa: E402
from pyscf_isdf_tpu.scf.khf import kscf_kernel as ref_kscf  # noqa: E402
from pyscf_isdf_tpu.scf.rohf import rohf_kernel as ref_rohf  # noqa: E402
from pyscf_isdf_tpu.scf.uhf import uhf_kernel as ref_uhf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops import becke  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, rohf_kernel, scf_kernel,
    uhf_kernel,
)

TOL = 1e-12
E_TOL = 1e-8
GRIDS = "becke:12,5"
MESH = (9, 9, 9)
A = [[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834], [1.7834, 1.7834, 0.0]]
ATOMS = [["C", (0.0, 0.0, 0.0)], ["C", (0.93, 0.87, 0.90)]]


@pytest.fixture(scope="module", autouse=True)
def _reference_built_once():
    spin = jax.jit(ref_xc.XCSpec.exc_vxc_spin, static_argnums=0,
                   compiler_options={"xla_backend_optimization_level": 0})
    closed = jax.jit(ref_xc.XCSpec.exc_vxc, static_argnums=0)
    grids, aos = {}, {}
    build_grids, eval_ao_and_grad = ref_becke.build_becke_grids, ref_becke.eval_ao_and_grad

    def grids_once(cell, **kw):
        key = (id(cell), tuple(sorted(kw.items())))
        if key not in grids:
            grids[key] = build_grids(cell, **kw)
        return grids[key]

    def aos_once(cell, coords, kpt=None, dtype=None, need_grad=True):
        key = (id(cell), id(coords), None if kpt is None else tuple(np.ravel(kpt)))
        if key not in aos:
            aos[key] = eval_ao_and_grad(cell, coords, kpt=kpt, dtype=dtype)
        ao, grad = aos[key]
        return ao, (grad if need_grad else None)

    packed = {}
    from_cell = ref_becke.PackedBasis.from_cell

    class PackedOnce:
        """The reference's PackedBasis, one object per cell: its AO
        evaluator's jit is keyed by it, so each k-point and each call of a
        cloud reuses one compile."""

        @staticmethod
        def from_cell(cell):
            if id(cell) not in packed:
                packed[id(cell)] = from_cell(cell)
            return packed[id(cell)]

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_becke, "PackedBasis", PackedOnce)
    mp.setattr(ref_xc.XCSpec, "exc_vxc_spin", lambda self, *a: spin(self, *a))
    mp.setattr(ref_xc.XCSpec, "exc_vxc", lambda self, *a: closed(self, *a))
    mp.setattr(ref_becke, "build_becke_grids", grids_once)
    mp.setattr(ref_becke, "eval_ao_and_grad", aos_once)
    yield
    mp.undo()


def _c2(build):
    return build(A, ATOMS, "gth-szv", pseudo="gth-pade", mesh=(10, 10, 10), unit="Angstrom")


@functools.lru_cache(maxsize=None)
def _cells(name):
    """(reference cell, port cell), one pair per name for the module."""
    if name == "diamond":
        return ref_diamond(mesh=MESH), diamond_primitive(mesh=MESH)
    return _c2(ref_build_cell), _c2(build_cell)


CELLS = ("diamond", "c2")
KPTS = ref_lattice.make_kpts(_cells("diamond")[0].a, [1, 1, 2], with_gamma_point=False)


def test_radial_and_angular_nodes():
    for n, xi in ((12, 1.3), (50, 0.4)):
        r, w = becke.treutler_ahlrichs(n, xi)
        r0, w0 = ref_becke.treutler_ahlrichs(n, xi)
        assert np.abs(r - r0).max() < TOL * r0.max() and np.abs(w - w0).max() < TOL * w0.max()
    v, w = becke.angular_product(12)
    v0, w0 = ref_becke.angular_product(12)
    assert np.abs(v - v0).max() < TOL and np.abs(w - w0).max() < TOL
    assert abs(w.sum() - 4 * np.pi) < TOL


@pytest.fixture(scope="module", params=CELLS)
def clouds(request):
    ref_cell, cell = _cells(request.param)
    ref = ref_becke.build_becke_grids(ref_cell, n_rad=12, n_theta=5)
    out = becke.build_becke_grids(cell, n_rad=12, n_theta=5, device="cpu")
    return ref_cell, cell, ref, out


def test_grid_points_and_weights(clouds):
    """The same points survive the pruning, with the same weights; the
    partition runs over each point's nearest atoms here and over the
    whole neighbour list in the reference."""
    _, _, ref, out = clouds
    assert out.size == ref.size
    assert np.abs(out.coords - ref.coords).max() < TOL
    assert np.abs(out.weights - ref.weights).max() < TOL * ref.weights.max()


@pytest.mark.parametrize("name,ik", [("diamond", None), ("diamond", 0), ("c2", None)])
def test_ao_values_and_gradients(name, ik):
    """AO values (K1 at Gamma, the plain lattice sum at a k-point) and
    their gradients on the cloud."""
    ref_cell, cell = _cells(name)
    ref = ref_becke.build_becke_grids(ref_cell, n_rad=12, n_theta=5)
    kk = None if ik is None else KPTS[ik]
    ao0, g0 = ref_becke.eval_ao_and_grad(ref_cell, ref.coords, kpt=kk)
    ao, g = becke.eval_ao_and_grad(cell, ref.coords, kpt=kk, device="cpu")
    assert np.abs(ao.numpy() - np.asarray(ao0)).max() < TOL
    assert np.abs(g.numpy() - np.asarray(g0)).max() < TOL


def test_cell_volume_sum():
    """The default grid's weights sum to the cell volume to the
    reference's 2e-3 relative (tests/test_becke.py:79-82)."""
    cell = diamond_primitive(mesh=MESH)
    w = becke.build_becke_grids(cell, device="cpu").weights
    assert abs(w.sum() - cell.vol) < 2e-3 * cell.vol


def test_vacuum_truncation_is_the_reference_s():
    """Queue 3 (m): with the default r_cut (twice the largest
    nearest-neighbour distance) the grid of a molecule in a box covers a
    fraction of the box, so the weights fall short of its volume. The
    port keeps the reference's radius for parity: both clouds are the
    same and both sums fall short."""
    def n2(build):
        return build(np.eye(3) * 20.0, [["N", (10.0, 10.0, 10.0)], ["N", (10.0, 10.0, 12.07)]],
                     "gth-szv", pseudo="gth-pade", mesh=(8, 8, 8))
    ref = ref_becke.build_becke_grids(n2(ref_build_cell), n_rad=12, n_theta=5)
    out = becke.build_becke_grids(n2(build_cell), n_rad=12, n_theta=5, device="cpu")
    assert np.abs(out.weights - ref.weights).max() < TOL * ref.weights.max()
    assert out.weights.sum() < 0.1 * 20.0 ** 3


@pytest.mark.parametrize("kind,name,xc", [
    ("rks", "diamond", "lda,vwn"), ("rks", "diamond", "pbe"),
    ("uks", "c2", "lda,vwn"), ("roks", "c2", "lda,vwn"),
])
def test_gamma_scf(kind, name, xc):
    ref_cell, cell = _cells(name)
    kw = dict(xc=xc, xc_grids=GRIDS, conv_tol=1e-10)
    if kind != "rks":
        kw["nelec"] = (6, 2)
    fn = {"rks": (ref_scf, scf_kernel), "uks": (ref_uhf, uhf_kernel),
          "roks": (ref_rohf, rohf_kernel)}[kind]
    ref = fn[0](ref_build(ref_cell), **kw)
    port_kw = dict(kw, device="cpu") if kind == "roks" else kw
    out = fn[1](build_scf_system(cell, device="cpu"), **port_kw)
    assert ref["converged"] and out["converged"]
    assert abs(out["e_tot"] - ref["e_tot"]) < E_TOL
    assert out["niter"] == ref["niter"]


def test_krks():
    rcell, cell = _cells("diamond")
    kw = dict(xc="lda,vwn", xc_grids=GRIDS, conv_tol=1e-10)
    ref = ref_kscf(ref_kbuild(rcell, KPTS), **kw)
    out = kscf_kernel(build_kscf_system(cell, KPTS, device="cpu"), device="cpu", **kw)
    assert ref["converged"] and out["converged"]
    assert abs(out["e_tot"] - ref["e_tot"]) < E_TOL
    assert out["niter"] == ref["niter"]

"""Port AO collocation (K1's plain path, its planners, the dense evaluator,
spectral gradients) == JAX reference.

The auxiliary basis of Gaussian density fitting reaches l = 4, past the
Pallas kernel's l <= 3: its K1 cases hold the plain version to the
reference's host evaluator alone.

K1 runs on the CPU through its plain torch version (the CUDA kernel is
held against the same plain version on the card by chip_smoke.py), on the
brick plan of the uniform grid and on the reference's slab plan for
explicit coordinates. The reference is the float64 host evaluator and the
Pallas kernel in interpret mode. Tolerance 1e-12: both sides sum the same
Gaussians in float64, in different orders, and the brick plan drops terms
below 1e-16 each.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops.ao_eval import ao_gradient_fft as ref_grad  # noqa: E402
from pyscf_isdf_tpu.ops.ao_eval import eval_ao_numpy  # noqa: E402
from pyscf_isdf_tpu.ops.pallas_ao import eval_ao_pallas  # noqa: E402
from pyscf_isdf_tpu.ops.pallas_ao import plan_ao_blocks as ref_plan  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops import cuda_ao  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ao_eval import (  # noqa: E402
    PackedBasis, ao_gradient_fft, eval_ao,
)

TOL = 1e-12


def _h_box(build):
    # fewer lattice images than the 128-slot image list: dummy padding
    return build(np.eye(3) * 40.0, [["H", (20.0, 20.0, 20.0)]], "gth-szv",
                 mesh=(16, 16, 16))


CASES = {
    "szv": (lambda: ref_diamond(mesh=(16, 16, 16)),
            lambda: diamond_primitive(mesh=(16, 16, 16))),
    "dzvp": (lambda: ref_diamond(mesh=(12, 12, 12), basis="gth-dzvp"),
             lambda: diamond_primitive(mesh=(12, 12, 12), basis="gth-dzvp")),
    "few_images": (lambda: _h_box(ref_build_cell), lambda: _h_box(build_cell)),
    # 17 is no multiple of the 8-point brick: partial bricks
    "szv17": (lambda: ref_diamond(mesh=(17, 17, 17)),
              lambda: diamond_primitive(mesh=(17, 17, 17))),
}


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(dense host evaluator, Pallas kernel in interpret mode) aoR."""
    ref_cell = CASES[case][0]()
    return eval_ao_numpy(ref_cell), np.asarray(
        eval_ao_pallas(ref_cell, interpret=True, dtype=jnp.float64))


@pytest.mark.parametrize("case", sorted(CASES))
def test_culled_collocation(case):
    """The main path's brick plan (uniform grid, primitives culled)."""
    out = cuda_ao.make_ao_evaluator(CASES[case][1](), device="cpu")().numpy()
    for ref in _reference(case):
        assert np.abs(out - ref).max() < TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_slab_collocation(case):
    """Explicit coordinates take the reference's slab plan."""
    cell = CASES[case][1]()
    out = cuda_ao.make_ao_evaluator(cell, coords=cell.uniform_grid(),
                                    device="cpu")().numpy()
    for ref in _reference(case):
        assert np.abs(out - ref).max() < TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_reference(case):
    """Same culling: trip counts, image lists (dummy slots included) and
    AO columns per (shell, block)."""
    ref_plans, ref_nb, ref_NB = ref_plan(CASES[case][0]())
    plans, nb, NB = cuda_ao.plan_ao_blocks(CASES[case][1]())
    assert (nb, NB) == (ref_nb, ref_NB)
    assert len(plans) == len(ref_plans)
    for p, r in zip(plans, ref_plans):
        assert (p.l, p.ns, p.P, p.K) == (r.l, r.ns, r.P, r.K)
        assert np.array_equal(p.counts, r.counts)
        assert np.array_equal(p.imgs, r.imgs)
        assert np.array_equal(p.cols, r.cols)


def test_dense_eval_ao_and_gradient():
    ref_cell = ref_diamond(mesh=(10, 10, 10), basis="gth-dzvp")
    cell = diamond_primitive(mesh=(10, 10, 10), basis="gth-dzvp")
    ao = eval_ao(PackedBasis.from_cell(cell),
                 torch.as_tensor(cell.uniform_grid()),
                 torch.as_tensor(cell.lattice_images()))
    ref = eval_ao_numpy(ref_cell)
    assert np.abs(ao.numpy() - ref).max() < TOL
    g = ao_gradient_fft(ao, cell.mesh, torch.as_tensor(cell.get_Gv()))
    g_ref = np.asarray(ref_grad(jnp.asarray(ref), ref_cell.mesh,
                                jnp.asarray(ref_cell.get_Gv())))
    assert np.abs(g.numpy() - g_ref).max() < 1e-10 * np.abs(g_ref).max()


@functools.lru_cache(maxsize=None)
def _aux_cells():
    """The GDF auxiliary cells (l up to 4) of the diamond primitive cell."""
    from pyscf_isdf_tpu.df.gdf import make_auxcell as ref_make_auxcell

    from pyscf_isdf_tpu_torch.df.gdf import make_auxcell

    ref_aux = ref_make_auxcell(ref_diamond(mesh=(9, 9, 9)))
    aux = make_auxcell(diamond_primitive(mesh=(9, 9, 9)))
    assert max(sh.l for sh in aux.shells) == 4
    return ref_aux, aux, eval_ao_numpy(ref_aux)


@pytest.mark.parametrize("plan", ["bricks", "slabs"])
def test_collocation_l4(plan):
    """K1's plain version at l = 4 (the GDF auxiliary basis), on the brick
    plan and on the slab plan, with the auxiliary basis's image radius."""

    ref_aux, aux, ref = _aux_cells()
    coords = None if plan == "bricks" else aux.uniform_grid()
    out = cuda_ao.make_ao_evaluator(aux, coords=coords, device="cpu",
                                    rcut_precision=cuda_ao.TIGHT_RCUT_PRECISION)()
    assert np.abs(out.numpy() - ref).max() < TOL


"""K1's brick planner (compact grid bricks, per-image primitive cull) and
its work counts, on the CPU.

The bricks must tile the uniform grid exactly once without spanning the
FFT-order wrap; the primitive cull may move each output by at most the
dropped terms' bound (DROP each); the needed-work count must equal a
brute-force count. Agreement of the bricked aoR with the JAX reference is
in test_torch_ao.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401

from pyscf_isdf_tpu_torch.models import (  # noqa: E402
    diamond_primitive, diamond_supercell,
)
from pyscf_isdf_tpu_torch.ops import cuda_ao  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ao_eval import shell_rcut  # noqa: E402


@pytest.mark.parametrize("n", [10, 12, 16, 17, 48])
def test_bricks_cover_grid_once(n):
    mesh = (n, n, n)
    slots = cuda_ao.brick_slots(mesh)
    assert slots.shape[1] == cuda_ao.BRICK ** 3
    pts = slots[slots >= 0]
    assert np.array_equal(np.sort(pts), np.arange(n ** 3))
    half = -(-n // 2)              # fftfreq jumps from +1/2 to -1/2 here
    for row in slots:
        live = row >= 0
        assert live[:live.sum()].all()          # points first, then padding
        for axis in np.unravel_index(row[live], mesh):
            run = np.unique(axis)
            assert run.size <= cuda_ao.BRICK
            assert run[-1] - run[0] + 1 == run.size          # contiguous
            assert (run < half).all() or (run >= half).all()  # one side


def test_bricks_are_compact():
    """Every brick spans a small region of the cell (no wrap), at 17^3."""
    cell = diamond_primitive(mesh=(17, 17, 17))
    slots = cuda_ao.brick_slots(cell.mesh)
    coords = cell.uniform_grid()
    spacing = np.linalg.norm(np.asarray(cell.a), axis=1).max() / 17
    for row in slots:
        pts = coords[row[row >= 0]]
        diam = np.linalg.norm(pts[:, None] - pts[None], axis=-1).max()
        assert diam <= np.sqrt(3) * 2 * cuda_ao.BRICK * spacing


def test_main_cell_plan():
    """Diamond 3x3x3 at 48^3, planning only: the bricks and the cull cut
    the exponentials the kernel evaluates well below the slab plan's."""
    cell = diamond_supercell((3, 3, 3), mesh=(48, 48, 48))
    bricks, dest = cuda_ao.plan_ao_bricks(cell)
    slabs, nb, NB = cuda_ao.plan_ao_blocks(cell)
    assert dest.shape == (216, 512) and (dest >= 0).all()

    def n_exp(plans, npts):
        return sum(int((p.nprim.sum(axis=2) * npts).sum()) for p in plans)

    assert n_exp(bricks, 512) * 5 < n_exp(slabs, NB)
    for b, s in zip(bricks, slabs):
        assert b.imgs.shape[3] % 128 == 0
        assert b.counts.max() < s.counts.max() / 2
        assert b.nprim.max() <= b.P
        # listed images come first, each with at least one primitive
        slot = np.arange(b.imgs.shape[3])
        live = slot[None, None] < b.counts[..., None]
        assert ((b.nprim > 0) == live).all()
        assert (b.imgs.transpose(0, 1, 3, 2)[~live] == 1e6).all()


def _rows(cell, drop):
    plans, dest = cuda_ao.plan_ao_bricks(cell, drop=drop)
    coords = cell.uniform_grid()
    coordsT = torch.as_tensor(np.ascontiguousarray(
        coords[np.maximum(dest.ravel(), 0)].T))
    dest_t = torch.as_tensor(dest.ravel().astype(np.int32))
    out = []
    for p in plans:
        out.append(cuda_ao.collocate_plain(
            p.l, torch.as_tensor(p.counts), torch.as_tensor(p.nprim),
            *(torch.as_tensor(a) for a in (p.cuts, p.centers, p.exps, p.coeffs)),
            coordsT, dest_t, torch.as_tensor(p.imgs), cell.ngrids).numpy())
    return plans, dest, out


@pytest.mark.parametrize("basis,n", [("gth-szv", 12), ("gth-dzvp", 10)])
def test_primitive_cull_bound(basis, n):
    """The same bricks with every primitive of every image kept and no
    per-point cut: each output moves by no more than DROP per term of the
    full sum (each dropped term is below DROP), plus the rounding of a sum
    taken in another order (8 ulp of the largest value)."""
    cell = diamond_primitive(mesh=(n, n, n), basis=basis)
    culled, dest, out = _rows(cell, cuda_ao.DROP)
    full, _, ref = _rows(cell, 0.0)
    block = np.full(cell.ngrids, -1)
    block[dest[dest >= 0]] = np.nonzero(dest >= 0)[0]
    block = block // dest.shape[1]                 # brick of each point
    dropped_any = False
    for c, f, o, r in zip(culled, full, out, ref):
        assert np.isneginf(f.cuts).all() and np.isfinite(c.cuts).all()
        dropped = f.nprim.sum(axis=2) - c.nprim.sum(axis=2)     # (ns, nb)
        assert (dropped >= 0).all()
        dropped_any |= bool(dropped.any())
        M = 2 * c.l + 1
        terms = f.nprim.sum(axis=2)                             # (ns, nb)
        limit = np.repeat(terms[:, block], c.K * M, axis=0) * cuda_ao.DROP
        slack = 8 * np.finfo(float).eps * np.abs(r).max()
        assert (np.abs(o - r) <= limit + slack).all()
    assert dropped_any


def _needed_brute(cell, grid=None):
    """Direct count over every (shell, point, image, primitive)."""
    if grid is None:
        grid = cell.uniform_grid()
    images = cell.lattice_images()
    n = 0
    for sh in cell.shells:
        ctr = cell.coords[sh.atom]
        r = np.linalg.norm(grid[:, None] - (ctr + images)[None], axis=-1)
        cmax = np.abs(sh.coeffs).max(axis=1)
        for a, c in zip(sh.exps, cmax):
            term = c * np.exp(-a * r * r) * np.maximum(1.0, r) ** sh.l
            n += int(((r <= shell_rcut(sh)) & (term >= cuda_ao.DROP)).sum())
    return n


@pytest.mark.parametrize("basis", ["gth-szv", "gth-dzvp"])
def test_needed_work_brute_force(basis):
    cell = diamond_primitive(mesh=(6, 6, 6), basis=basis)
    plans, dest = cuda_ao.plan_ao_bricks(cell)
    work = cuda_ao.collocation_work(cell, plans, dest, device="cpu")
    need, done = work["needed"], work["evaluated"]
    assert need["exp"] == _needed_brute(cell)
    # the brick plan evaluates a superset of what the inputs need
    assert need["exp"] <= done["exp"] and need["pairs"] <= done["pairs"]
    assert 0 < need["fp64_instr"] <= done["fp64_instr"]
    # the needed work does not depend on the blocks
    slabs, _, _ = cuda_ao.plan_ao_blocks(cell, block=64)
    assert cuda_ao.collocation_work(cell, slabs, cuda_ao.slab_slots(
        cell.ngrids, 64), device="cpu")["needed"] == need


@pytest.mark.parametrize("basis", ["gth-szv", "gth-dzvp"])
def test_needed_work_on_coords(basis):
    """The count on explicit points (a cloud reaching past the cell, as an
    atomic grid's does) against the direct one, under the culled slab plan."""
    cell = diamond_primitive(mesh=(6, 6, 6), basis=basis)
    rng = np.random.default_rng(7)
    coords = rng.uniform(-2.0, 1.0, (300, 3)) @ cell.a
    ev = cuda_ao.make_ao_evaluator(cell, coords=coords, block=64, device="cpu",
                                   drop=cuda_ao.DROP)
    work = cuda_ao.collocation_work(cell, ev.plans, ev.dest, device="cpu",
                                    coords=coords)
    need, done = work["needed"], work["evaluated"]
    assert need["exp"] == _needed_brute(cell, coords)
    assert need["exp"] <= done["exp"] and need["pairs"] <= done["pairs"]
    assert 0 < need["fp64_instr"] <= done["fp64_instr"]

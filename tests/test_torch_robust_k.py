"""Planner of kernel K2's float64 (DMMA) and float32 paths, on the CPU.

The kernel itself runs only on the card (chip_smoke.py holds it against its
plain version there); what the CPU can check is the pure-Python planner that
sizes its blocks: the shared memory of a block stays within what Hopper
gives one block, the columns a block holds fit its warps' registers, and
the grid writes every (P, nu, g) exactly once. The kernel computes its
block ranges from blockIdx as PlanF64.blocks does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401

from pyscf_isdf_tpu_torch.ops import cuda_robust_k as rk  # noqa: E402

SHAPES = [(ng, nao, nip)
          for nao in (11, 37, 216, 702)
          for ng, nip in ((110592, 3456), (4099, 333), (777, 70), (35, 1))]


@pytest.mark.parametrize("ng,nao,nip", SHAPES)
@pytest.mark.parametrize("slots", [132, 117])
def test_plan_f64_fits_the_block(ng, nao, nip, slots):
    p = rk.plan_f64(ng, nao, nip, slots)
    kp = -(-nao // 8) * 8
    assert p.smem == rk.smem_bytes_f64(p.stages, p.width, p.cs)
    assert p.smem <= rk.SMEM_LIMIT == 232448
    assert p.stages in (2, 3) and 1 <= p.cs <= rk.MAX_CLUSTER
    # every rank of a cluster holds 8 to 256 columns, a multiple of 8
    assert p.width % 8 == 0 and p.width <= rk.MAX_WIDTH
    assert (p.cs - 1) * p.width < kp <= p.cs * p.width
    # g slices: whole chunks, none empty, all of g covered
    assert p.g_per_split % rk.TG64 == 0
    assert (p.nsplit - 1) * p.g_per_split < ng <= p.nsplit * p.g_per_split
    assert 1 <= p.nsplit <= rk.MAX_SPLITS


@pytest.mark.parametrize("nao,block", [(11, (1, 3, 16)), (37, (1, 3, 40)),
                                       (216, (1, 3, 216)), (217, (1, 2, 224)),
                                       (702, (3, 2, 240))])
def test_block_f64_choices(nao, block):
    """One block with three stages up to nao=216 (the main path), then two,
    then the smallest cluster that fits."""
    cs, stages, width, _ = rk.block_f64(nao)
    assert (cs, stages, width) == block


def test_plan_f64_main_shape():
    p = rk.plan_f64(110592, 216, 3456, 132)
    assert (p.cs, p.stages, p.width, p.smem) == (1, 3, 216, 231936)
    assert p.nsplit * p.grid(3456)[0] >= 132    # every SM gets a block


def test_plan_f64_rejects_what_does_not_fit():
    with pytest.raises(NotImplementedError):
        rk.plan_f64(1000, 2000, 64, 132)


def _covered_once(plan, ng, nao, nip):
    """Each (P, g, nu) in exactly one block: count on the grid of the
    blocks' own boundaries, where every cell lies wholly inside or outside
    each block."""
    boxes = list(plan.blocks(ng, nao, nip))
    nx, ny = plan.grid(nip)
    assert len(boxes) == nx * ny
    cuts = [sorted({0, n} | {e for b in boxes for e in b[axis]})
            for axis, n in enumerate((nip, ng, nao))]
    count = np.zeros([len(c) - 1 for c in cuts], dtype=np.int64)
    for box in boxes:
        idx = []
        for axis, (lo, hi) in enumerate(box):
            assert 0 <= lo <= hi <= cuts[axis][-1]
            idx.append(slice(cuts[axis].index(lo), cuts[axis].index(hi)))
        count[tuple(idx)] += 1
    return bool((count == 1).all())


@pytest.mark.parametrize("ng,nao,nip", [(4099, 37, 333), (777, 11, 70),
                                        (1000, 300, 90), (3001, 702, 130),
                                        (110592, 216, 3456), (35, 702, 1)])
def test_grid_covers_each_element_once(ng, nao, nip):
    assert _covered_once(rk.plan_f64(ng, nao, nip, 132), ng, nao, nip)


@pytest.mark.parametrize("nao", [11, 37, 216, 702])
def test_plan_f32_fits_the_block(nao):
    tp, nsplit = rk.plan_f32(4099, nao, 333, 132)
    assert rk.smem_bytes(tp, nao, 4) <= rk.SMEM_LIMIT
    assert 1 <= nsplit <= -(-4099 // rk.TG)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    aoR, B = rng.standard_normal((50, 9)), rng.standard_normal((7, 9))
    Vxi = rng.standard_normal((7, 50))
    out = rk.robust_k_cross(*map(torch.as_tensor, (aoR, B, Vxi)))
    ref = np.einsum("pg,gm,pm,gn->pn", Vxi, aoR, B, aoR)
    assert np.abs(out.numpy() - ref).max() < 1e-12 * np.abs(ref).max()

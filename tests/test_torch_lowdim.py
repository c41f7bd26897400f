"""Port low-dimensional Coulomb (slab, wire, isolated cell), the
Wigner-Seitz exchange kernel ('vcut_ws') and particle-mesh Ewald == JAX
reference.

Cells are the reference's own (tests/test_lowdim.py, test_pme.py,
test_scf_rhf.py) at small meshes. Float64 on the CPU. Bars: 1e-12 for the
Coulomb kernels, Ewald sums, PME and the slab's local pseudopotential (the
same closed forms on the host); 1e-8 Ha for SCF energies converged to
1e-10, with equal iteration counts; the slab RKS also against its
published golden (pyscf/pbc/dft/test/test_rks.py:121-141) to 1e-7.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.ops import coulomb as ref_coulomb, pp as ref_pp  # noqa: E402
from pyscf_isdf_tpu.ops.pme import particle_mesh_ewald as ref_pme  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf import scf_kernel as ref_scf  # noqa: E402
from pyscf_isdf_tpu.scf.khf import build_kscf_system as ref_kbuild  # noqa: E402
from pyscf_isdf_tpu.scf.khf import kscf_kernel as ref_kscf  # noqa: E402
from pyscf_isdf_tpu.scf.kuhf import kuhf_kernel as ref_kuhf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.ops import coulomb, pp  # noqa: E402
from pyscf_isdf_tpu_torch.ops.pme import particle_mesh_ewald  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, kuhf_kernel, scf_kernel,
)

TOL = 1e-12
E_TOL = 1e-8
SLAB_GOLDEN = -0.6252695697315944
BASIS3 = [[0, (3.0, 1.0)], [0, (0.8, 1.0)], [0, (0.25, 1.0)]]


def _slab(build):
    a = np.eye(3) * 4.0
    a[2, 2] = 12.0
    return build(a, "H 0 0 0; H .8 .8 0",
                 basis=[[0, (4.0, 1.0)], [0, (1.0, 1.0)]], dimension=2)


def _slab_pp(build):
    a = np.eye(3) * 4.0
    a[2, 2] = 10.0
    return build(a, "C 0 0 0; C .8 .8 0.3", basis="gth-szv", pseudo="gth-pade",
                 mesh=[9, 9, 21], dimension=2)


def _he_golden_slab(build):
    cell = build(np.eye(3) * 4, "He 0 0 0; He 0 1 1", basis=[[0, (1.0, 1.0)]],
                 mesh=[9, 9, 60], dimension=2)
    return dataclasses.replace(cell, rcut=3.6)


def _mixed_slab(build):
    a = np.eye(3) * 3
    a[0, 1] = 0.2
    return build(a, "H 0 0.1 0; H 1.1 2.0 0; He 1.2 .3 0.2", basis=[[0, (1.0, 1.0)]],
                 mesh=[15] * 3, dimension=2, unit="Angstrom")


def _wire(build):
    return build(np.diag([6.0, 8.0, 8.0]), [["He", (3.0, 4.0, 4.0)]], basis=BASIS3,
                 mesh=[16, 20, 20], dimension=1)


def _pair_wire(build):
    cell = build(np.diag([20.0, 12.0, 12.0]), [["H", (1.0, 6.0, 6.0)],
                                               ["H", (3.0, 6.0, 6.0)]],
                 basis=[[0, (1.0, 1.0)]], mesh=[8, 8, 8], dimension=1)
    return dataclasses.replace(cell, charges=np.array([1.0, -1.0]))


def _box(build):
    return build(np.eye(3) * 8.0, [["He", (4.0, 4.0, 4.0)]], basis=BASIS3,
                 mesh=[20] * 3, dimension=0)


def _he2(build):
    return build(np.eye(3) * 4.0, "He 0 0 0; He 1 1 1",
                 basis=[[0, (1.0, 1.0)], [0, (0.5, 1.0)]], mesh=[9, 9, 9])


def _mixed_3d(build):
    a = np.array([[6.1, 0.3, 0.0], [0.0, 5.7, 0.4], [0.2, 0.0, 6.6]])
    return build(a, [["Li", (1.1, 2.0, 3.0)], ["H", (4.0, 1.5, 2.2)],
                     ["He", (2.5, 4.4, 5.0)]],
                 basis="gth-szv", pseudo="gth-pade", mesh=[16] * 3)


def _diamond(build):
    return (ref_diamond if build is ref_build_cell else diamond_primitive)(mesh=(9,) * 3)


CELLS = {"slab": _slab, "slab_pp": _slab_pp, "he_slab": _he_golden_slab,
         "mixed_slab": _mixed_slab, "wire": _wire, "pair_wire": _pair_wire,
         "box": _box, "he2": _he2, "diamond": _diamond, "mixed_3d": _mixed_3d}


def _both(name):
    return CELLS[name](ref_build_cell), CELLS[name](build_cell)


@pytest.mark.parametrize("name,exxdiv,k", [
    ("slab", None, None), ("slab", "ewald", (0.1, 0.2, 0.0)),
    ("wire", None, None), ("wire", "ewald", (0.2, 0.0, 0.0)),
    ("box", None, None), ("diamond", "vcut_ws", (0.1, -0.2, 0.3)),
    ("diamond", "vcut_sph", (0.1, -0.2, 0.3)),
])
def test_coulomb_kernel(name, exxdiv, k):
    """Truncated kernels of each dimension and the exchange treatments, at
    Gamma and at a momentum transfer (the k-mesh of two points)."""
    ref_cell, cell = _both(name)
    kpts = None if k is None else np.array([[0.0, 0.0, 0.0], k])
    kk = None if k is None else np.asarray(k)
    out = coulomb.get_coulG(cell, k=kk, exxdiv=exxdiv, kpts=kpts)
    ref = ref_coulomb.get_coulG(ref_cell, k=kk, exxdiv=exxdiv, kpts=kpts)
    assert np.abs(out - ref).max() < TOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", ["he_slab", "mixed_slab", "slab", "pair_wire",
                                  "wire", "box"])
def test_ewald(name):
    """Slab, wire and isolated nuclear repulsion; the slab goldens of
    pyscf/pbc/gto/test/test_cell.py:214-230 as the reference holds them."""
    ref_cell, cell = _both(name)
    e = coulomb.ewald(cell)
    assert abs(e - ref_coulomb.ewald(ref_cell)) < TOL
    golden = {"he_slab": -5.1194779101355596, "mixed_slab": -3.0902098018260418}
    if name in golden:
        assert abs(e - golden[name]) < 1e-9


def test_slab_local_pp():
    ref_cell, cell = _both("slab_pp")
    ref = ref_pp.gth_vlocG(ref_cell, ref_cell.get_Gv())
    out = pp.gth_vlocG(cell, cell.get_Gv())
    assert np.abs(out - ref).max() < TOL * np.abs(ref).max()


@pytest.mark.parametrize("name,order", [("diamond", 10), ("mixed_3d", 6)])
def test_pme(name, order):
    """The B-spline PME reciprocal sum on the device (the CPU here) against
    the reference's PME, and against the exact structure-factor Ewald."""
    ref_cell, cell = _both(name)
    e = particle_mesh_ewald(cell, order=order, device="cpu")
    assert abs(e - ref_pme(ref_cell, order=order)) < TOL * abs(e)
    assert abs(e - coulomb.ewald(cell)) < (1e-7 if order == 10 else 1e-4)


@pytest.mark.parametrize("name,kw", [
    ("slab", dict(xc="lda,vwn")),
    ("box", dict(xc=None, exxdiv=None)),
    ("wire", dict(xc=None, exxdiv="ewald")),
    ("he2", dict(xc=None, exxdiv="vcut_ws")),
])
def test_scf(name, kw):
    """Slab RKS, isolated and wire RHF, and RHF with Wigner-Seitz exchange."""
    ref_cell, cell = _both(name)
    ref = ref_scf(ref_build(ref_cell), conv_tol=1e-10, **kw)
    out = scf_kernel(build_scf_system(cell, device="cpu"), conv_tol=1e-10, **kw)
    assert ref["converged"] and out["converged"]
    assert abs(out["e_tot"] - ref["e_tot"]) < E_TOL
    assert out["niter"] == ref["niter"]
    if name == "slab":
        assert abs(out["e_tot"] - SLAB_GOLDEN) < 1e-7


@pytest.fixture
def ref_isdf_k_compiled_once(monkeypatch):
    """The reference's k-point ISDF exchange jits a new closure on every
    call (ROADMAP queue 3 (h)), so every SCF cycle recompiles it: here the
    reference's own get_k_kpts under one outer jit (its ISDFK is a pytree
    with qmap static), compiled once for the test."""
    from pyscf_isdf_tpu.df import isdf_k as ref_isdf_k

    monkeypatch.setattr(ref_isdf_k, "get_k_kpts",
                        jax.jit(ref_isdf_k.get_k_kpts, static_argnames=("k1_idx",)))


def test_vcut_at_k_points(ref_isdf_k_compiled_once):
    """'vcut_sph' in the k-point drivers: KRHF (isdf) against the
    reference, and the closed-shell KUHF equal to it on both engines.
    Queue 3 (n): the reference's kuhf_kernel takes 'vcut_*' into its isdf
    kernels only, and with df='fftdf' exchanges with the plain kernel (one
    cycle from the core guess gives the same energy as exxdiv=None); the
    port truncates both engines' kernels."""
    rcell, cell = _both("diamond")
    kpts = ref_lattice.make_kpts(rcell.a, [1, 1, 2], with_gamma_point=False)
    rsys, sys_ = ref_kbuild(rcell, kpts), build_kscf_system(cell, kpts, device="cpu")
    kw = dict(xc=None, df="isdf", exxdiv="vcut_sph", conv_tol=1e-10)
    ref = ref_kscf(rsys, **kw)
    out = kscf_kernel(sys_, device="cpu", **kw)
    assert abs(out["e_tot"] - ref["e_tot"]) < E_TOL and out["niter"] == ref["niter"]
    for df in ("isdf", "fftdf"):
        u = kuhf_kernel(sys_, nelec=(4, 4), device="cpu", **dict(kw, df=df))
        r = out if df == "isdf" else kscf_kernel(sys_, device="cpu", **dict(kw, df=df))
        assert abs(u["e_tot"] - r["e_tot"]) < E_TOL
    one = dict(xc=None, nelec=(4, 4), max_cycle=1)
    assert ref_kuhf(rsys, exxdiv="vcut_sph", **one)["e_tot"] == \
        ref_kuhf(rsys, exxdiv=None, **one)["e_tot"]


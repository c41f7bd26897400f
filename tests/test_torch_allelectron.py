"""Port all-electron analytic stack == JAX reference: the STO-nG and
NWChem bases, the McMurchie-Davidson integrals (ops/md_int.py,
ops/md_int_k.py), the analytic all-electron fit and core Hamiltonian
(df/aegdf.py with ``build_scf_system(ae=True)``,
``build_kscf_system(ae=True)`` and ``df='aegdf'`` in scf_kernel,
kscf_kernel and uhf_kernel) and the sfX2C-1e core Hamiltonian
(scf/x2c.py).

Cells: the reference's all-electron He solid (simple cubic, a = 6 bohr,
sto-3g; tests/test_aegdf*.py), its 2x1x1 k-mesh and its doubled
supercell, and H2 in a 200-bohr box (dimension 0). Float64 on the
CPU. Bars: 1e-12 for basis data and integrals (the same host code);
1e-10 relative for J/K from the fit at a density (each package whitens by
its own eigenvectors); 1e-8 Ha for SCF energies converged to 1e-10, with
equal iteration counts.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.basis import gth as ref_gth  # noqa: E402
from pyscf_isdf_tpu.df import aegdf as ref_aegdf, gdf as ref_gdf  # noqa: E402
from pyscf_isdf_tpu.ops import md_int as ref_md, md_int_k as ref_mdk  # noqa: E402
from pyscf_isdf_tpu.scf import build_scf_system as ref_build  # noqa: E402
from pyscf_isdf_tpu.scf import scf_kernel as ref_scf  # noqa: E402
from pyscf_isdf_tpu.scf import x2c as ref_x2c  # noqa: E402
from pyscf_isdf_tpu.scf.uhf import uhf_kernel as ref_uhf  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.basis import gth  # noqa: E402
from pyscf_isdf_tpu_torch.df import aegdf, gdf  # noqa: E402
from pyscf_isdf_tpu_torch.ops import md_int, md_int_k  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, scf_kernel, uhf_kernel,
)
from pyscf_isdf_tpu_torch.scf import x2c  # noqa: E402

TOL = 1e-12
REL = 1e-10
E_TOL = 1e-8
OMEGA = 0.4


def _he(build):
    return build(np.eye(3) * 6.0, [["He", (0.0, 0.0, 0.0)]], "sto-3g", mesh=(8, 8, 8))


def _he2(build):
    return build(np.diag([12.0, 6.0, 6.0]), [["He", (0.0, 0.0, 0.0)], ["He", (6.0, 0.0, 0.0)]],
                 "sto-3g", mesh=(8, 8, 8))


def _h2(build):
    return build(np.eye(3) * 200.0, [["H", (0.0, 0.0, 0.0)], ["H", (0.0, 0.0, 1.4)]],
                 "sto-3g", mesh=(4, 4, 4), dimension=0, unit="Bohr")


@functools.lru_cache(maxsize=None)
def _cells(name):
    make = {"he": _he, "he2": _he2, "h2": _h2}[name]
    return make(ref_build_cell), make(build_cell)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("basis,symbol", [("sto-3g", "Si"), ("sto-6g", "O"),
                                          ("cc-pvdz", "He"), ("6-31gs", "C"),
                                          ("def2-svp", "N")])
def test_load_basis(basis, symbol):
    """The STO-nG table and the NWChem files through the port's parser."""
    out, ref = gth.load_basis(basis, symbol), ref_gth.load_basis(basis, symbol)
    assert len(out) == len(ref)
    for (l, e, c), (l0, e0, c0) in zip(out, ref):
        assert l == l0 and np.array_equal(e, e0) and np.abs(c - c0).max() < TOL


@pytest.mark.parametrize("kind", ["overlap", "kinetic", "int2c", "int3c", "vne"])
def test_md_int(kind):
    ref_cell, cell = _cells("he2")
    aux, ref_aux = gdf.make_auxcell(cell), ref_gdf.make_auxcell(ref_cell)
    args = {"overlap": ((cell,), (ref_cell,)), "kinetic": ((cell,), (ref_cell,)),
            "int2c": ((aux, OMEGA), (ref_aux, OMEGA)),
            "int3c": ((cell, aux, OMEGA), (ref_cell, ref_aux, OMEGA)),
            "vne": ((cell, OMEGA), (ref_cell, OMEGA))}[kind]
    out, ref = getattr(md_int, kind)(*args[0]), getattr(ref_md, kind)(*args[1])
    assert np.abs(out - ref).max() < TOL * max(1.0, np.abs(ref).max())


def test_md_int_molecular():
    ref_cell, cell = _cells("h2")
    ref = ref_md.int2e_molecular(ref_cell)
    assert np.abs(md_int.int2e_molecular(cell) - ref).max() < TOL * np.abs(ref).max()


@pytest.mark.parametrize("kind", ["int2c_q", "int3c_kq", "vne_k"])
def test_md_int_k(kind):
    ref_cell, cell = _cells("he")
    kpts = ref_lattice.make_kpts(ref_cell.a, [2, 1, 1], with_gamma_point=False)
    q = np.array([[0.0, 0.0, 0.0], kpts[1] - kpts[0]])
    aux, ref_aux = gdf.make_auxcell(cell), ref_gdf.make_auxcell(ref_cell)
    args = {"int2c_q": ((aux, q, OMEGA), (ref_aux, q, OMEGA)),
            "int3c_kq": ((cell, aux, kpts, q, OMEGA), (ref_cell, ref_aux, kpts, q, OMEGA)),
            "vne_k": ((cell, kpts, OMEGA), (ref_cell, kpts, OMEGA))}[kind]
    out, ref = getattr(md_int_k, kind)(*args[0]), getattr(ref_mdk, kind)(*args[1])
    assert np.abs(out - ref).max() < TOL * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("at_k", [False, True])
def test_ae_hcore(at_k):
    ref_cell, cell = _cells("he2")
    if at_k:
        kpts = ref_lattice.make_kpts(ref_cell.a, [2, 1, 1], with_gamma_point=False)
        S0, h0 = ref_aegdf.ae_hcore_kpts(ref_cell, kpts, OMEGA)
        S, h = aegdf.ae_hcore_kpts(cell, kpts, OMEGA, device="cpu")
    else:
        S0, h0 = ref_aegdf.ae_hcore(ref_cell, OMEGA)
        S, h = aegdf.ae_hcore(cell, OMEGA, device="cpu")
    assert np.abs(S.numpy() - S0).max() < TOL and np.abs(h.numpy() - h0).max() < TOL


@pytest.mark.parametrize("name,omega", [("he2", OMEGA), ("h2", None)])
def test_ae_fit_jk(name, omega):
    """J/K from the periodic fit and from the molecular (1/r) fit."""
    ref_cell, cell = _cells(name)
    ref = ref_aegdf.build_ae_gdf(ref_cell, omega=omega)
    out = aegdf.build_ae_gdf(cell, omega=omega, device="cpu")
    assert out.naux == ref.naux
    rng = np.random.default_rng(0)
    dm = rng.normal(size=(cell.nao,) * 2)
    dm = dm + dm.T
    vj, vk = gdf.get_jk(out, torch.as_tensor(dm))
    vj0, vk0 = ref_gdf.get_jk(ref, jnp.asarray(dm))
    assert _rel(vj, vj0) < REL and _rel(vk, vk0) < REL


@pytest.mark.parametrize("kind", ["aehf", "uhf", "aekhf", "x2c"])
def test_ae_scf(kind):
    """The all-electron RHF and KRHF (2x1x1) wrappers (the shared drivers
    with get_jk on the fit), UHF with df='aegdf', and RHF with df='aegdf'
    on the sfX2C-1e core Hamiltonian."""
    ref_cell, cell = _cells("he")
    kw = dict(xc=None, df="aegdf", conv_tol=1e-10)
    if kind == "aehf":
        ref = ref_aegdf.aehf_kernel(ref_cell, omega=OMEGA)
        out = aegdf.aehf_kernel(cell, omega=OMEGA, device="cpu")
    elif kind == "aekhf":
        kpts = ref_lattice.make_kpts(ref_cell.a, [2, 1, 1])
        ref = ref_aegdf.aekhf_kernel(ref_cell, kpts, omega=OMEGA)
        out = aegdf.aekhf_kernel(cell, kpts, omega=OMEGA, device="cpu")
    else:
        rsys, sys_ = ref_build(ref_cell, ae=True), build_scf_system(cell, device="cpu",
                                                                     ae=True)
        if kind == "x2c":
            import dataclasses

            h0 = ref_x2c.sfx2c1e_hcore(ref_cell, OMEGA)[1]
            S, h = x2c.sfx2c1e_hcore(cell, OMEGA, device="cpu")
            assert np.abs(h.numpy() - h0).max() < TOL
            rsys = dataclasses.replace(rsys, hcore=h0)
            sys_ = dataclasses.replace(sys_, hcore=h)
        fns = (ref_uhf, uhf_kernel) if kind == "uhf" else (ref_scf, scf_kernel)
        ref, out = fns[0](rsys, **kw), fns[1](sys_, **kw)
    assert ref["converged"] and out["converged"]
    assert abs(out["e_tot"] - ref["e_tot"]) < E_TOL
    assert out["niter"] == ref["niter"]


def test_krhf_matches_supercell():
    """KRHF (df='aegdf') on the 2x1x1 k-mesh equals Gamma RHF on the
    doubled cell (per cell) in the port alone, as the reference's own
    oracle holds it."""
    _, cell = _cells("he")
    _, sc = _cells("he2")
    kpts = ref_lattice.make_kpts(cell.a, [2, 1, 1])
    ek = kscf_kernel(build_kscf_system(cell, kpts, device="cpu", ae=True), xc=None,
                     df="aegdf", conv_tol=1e-10, device="cpu")["e_tot"]
    eg = scf_kernel(build_scf_system(sc, device="cpu", ae=True), xc=None, df="aegdf",
                    conv_tol=1e-10)["e_tot"]
    assert abs(ek - eg / 2) < 1e-6

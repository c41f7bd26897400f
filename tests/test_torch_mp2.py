"""Port MP2 family (df/fft_ao2mo, mp/mp2, mp/thc, mp/kmp2) == JAX reference.

Each comparison hands the same inputs to both packages: the port's
converged orbitals (so SCF round-off does not enter), its grid arrays
(AO values, kernels) in a namespace the reference's functions read, and
the reference's own ISDF / ISDF-K factors carried into the port by
``convert`` (so the interpolation-point selection does not enter). The
port runs on the CPU in float64.

Cells: the Be cell of tests/test_mp2.py (Gamma and 3x1x1, the goldens of
pyscf/pbc/mp/test/test_kpoint.py), the off-symmetry two-carbon cell at
10^3 for the Gamma THC form (nocc 4), and the diamond primitive cell of
tests/test_kmp2.py at 15^3 with a shifted 2x1x1 k-mesh for THC-KMP2,
frozen core, padding and KUMP2. Bars: the ERI transforms 1e-12 relative
to their largest element, the energies 1e-12 Ha (THC-KMP2 1e-10 Ha), the
goldens 1e-9 Ha.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.df import fft_ao2mo as ref_ao2mo  # noqa: E402
from pyscf_isdf_tpu.df import isdf as ref_isdf, isdf_k as ref_isdf_k  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.mp import kmp2 as ref_kmp2  # noqa: E402
from pyscf_isdf_tpu.mp import mp2 as ref_mp2, thc as ref_thc  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.convert import isdf_from_numpy, isdfk_from_numpy  # noqa: E402
from pyscf_isdf_tpu_torch.df import fft_ao2mo, isdf as isdf_mod  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.mp import mp2_energy, thc_mp2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.mp.kmp2 import kmp2_energy, kump2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.mp.thc import thc_kmp2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    build_kscf_system, build_scf_system, kscf_kernel, kuhf_kernel, scf_kernel,
)

L = 7.0
BE_A = L * np.eye(3) + np.array([[0, 0, 0], [5.0, 0, 0], [0, 0, 0]])
BE_ATOM = [["Be", (L / 2.0, L / 2.0, L / 2.0)]]
EMP2_BE = -5.44597932944397e-06           # tests/test_mp2.py:37
EMP2_BE_311 = -7.9832274354253814e-06     # tests/test_kmp2.py:26


def _be(build):
    return build(BE_A, BE_ATOM, basis="gth-szv", pseudo="gth-pade-q2", mesh=[12] * 3)


def _host(res):
    """A result's orbitals as numpy (per k where listed)."""
    def h(x):
        return [h(y) for y in x] if isinstance(x, (list, tuple)) else np.asarray(x)
    return {k: h(res[k]) for k in ("mo_energy", "mo_coeff", "mo_occ") if k in res}


def _ref_gamma(cell, sys_):
    """The port's Gamma arrays in the shape the reference's functions read."""
    return SimpleNamespace(cell=cell, aoR=jnp.asarray(sys_.aoR.numpy()),
                           coulG=sys_.coulG.numpy(), mesh=tuple(sys_.mesh),
                           weight=sys_.weight, nelec=sys_.nelec)


def _ref_k(cell, sys_):
    return SimpleNamespace(cell=cell, kpts=sys_.kpts, aoR_k=jnp.asarray(sys_.aoR_k.numpy()),
                           mesh=tuple(sys_.mesh), weight=sys_.weight)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def be_gamma():
    sys_ = build_scf_system(_be(build_cell), device="cpu")
    res = scf_kernel(sys_, xc=None, exxdiv="ewald", conv_tol=1e-12)
    return _ref_gamma(_be(ref_build_cell), sys_), sys_, _host(res)


@pytest.fixture(scope="module")
def be_k():
    cell = _be(build_cell)
    kpts = ref_lattice.make_kpts(cell.a, [3, 1, 1], wrap_around=True)
    sys_ = build_kscf_system(cell, kpts, device="cpu")
    res = kscf_kernel(sys_, xc=None, exxdiv="ewald", conv_tol=1e-12, device="cpu")
    return _ref_k(_be(ref_build_cell), sys_), sys_, _host(res)


@pytest.fixture(scope="module")
def diamond_k():
    """tests/test_kmp2.py's THC-KMP2 cell: diamond 15^3, shifted 2x1x1."""
    cell = diamond_primitive(mesh=(15, 15, 15))
    kpts = ref_lattice.make_kpts(cell.a, [2, 1, 1], with_gamma_point=False)
    sys_ = build_kscf_system(cell, kpts, device="cpu")
    res = kscf_kernel(sys_, xc=None, exxdiv="ewald", conv_tol=1e-11, device="cpu")
    return _ref_k(ref_diamond(mesh=(15, 15, 15)), sys_), sys_, res


def test_general_and_get_eri(be_gamma):
    """Gamma transforms on MO blocks of four different widths."""
    ref, sys_, _ = be_gamma
    rng = np.random.default_rng(0)
    aoR = sys_.aoR.numpy()
    mos = [aoR @ rng.standard_normal((aoR.shape[1], n)) for n in (2, 3, 1, 2)]
    out = fft_ao2mo.general(*(torch.as_tensor(m) for m in mos), sys_.coulG, sys_.mesh,
                            sys_.weight, chunk=4)
    ref_out = ref_ao2mo.general(*(jnp.asarray(m) for m in mos), jnp.asarray(ref.coulG),
                                ref.mesh, ref.weight)
    assert out.shape == (6, 2)
    assert _rel(out.numpy(), ref_out) < 1e-12
    eri = fft_ao2mo.get_eri(sys_.aoR, sys_.coulG, sys_.mesh, sys_.weight)
    ref_eri = ref_ao2mo.get_eri(ref.aoR, jnp.asarray(ref.coulG), ref.mesh, ref.weight)
    assert _rel(eri.numpy(), ref_eri) < 1e-12


def test_mp2_golden_and_parity(be_gamma):
    ref, sys_, res = be_gamma
    e = mp2_energy(sys_, res, device="cpu")
    assert abs(e - EMP2_BE) < 1e-9
    assert abs(e - ref_mp2.mp2_energy(ref, res)) < 1e-12
    # THC at c=10 reproduces it (tests/test_mp2.py:40); the THC parity
    # with the reference is test_thc_factored_form_matches_per_pair_form
    fac = isdf_mod.build_isdf(sys_.aoR, sys_.coulG, sys_.mesh, sys_.weight, c=10)
    e_thc = thc_mp2_energy(fac, res["mo_coeff"], res["mo_energy"], 1, device="cpu")
    assert abs(e_thc - e) < 1e-11


def test_thc_factored_form_matches_per_pair_form():
    """The factored L^T (W L) against the reference's vmap over (i, j)
    pairs, on a cell with nocc 4 > 1 (so the i != j blocks and the
    exchange transpose both enter)."""
    a = [[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834], [1.7834, 1.7834, 0.0]]
    atoms = [["C", (0.0, 0.0, 0.0)], ["C", (0.93, 0.87, 0.90)]]
    cell = build_cell(a, atoms, "gth-szv", pseudo="gth-pade", mesh=(10, 10, 10),
                      unit="Angstrom")
    sys_ = build_scf_system(cell, device="cpu")
    res = _host(scf_kernel(sys_, xc=None, conv_tol=1e-10))
    ref = _ref_gamma(None, sys_)
    fac = ref_isdf.build_isdf(ref.aoR, jnp.asarray(ref.coulG), ref.mesh, ref.weight, c=6)
    port_fac = isdf_from_numpy(fac.aoRg, fac.W, fac.ip_idx, device="cpu")
    nocc = sys_.nelec // 2
    assert nocc >= 3
    e = thc_mp2_energy(port_fac, res["mo_coeff"], res["mo_energy"], nocc, device="cpu")
    e0 = ref_thc.thc_mp2_energy(fac, res["mo_coeff"], res["mo_energy"], nocc=nocc)
    assert e < 0 and abs(e - e0) < 1e-12
    assert abs(e - mp2_energy(sys_, res, device="cpu")) < 1e-4


def test_get_eri_kpts_cases(be_k):
    ref, sys_, _ = be_k
    kconserv = ref_kmp2.get_kconserv(ref.cell.a, sys_.kpts)
    for case in [(0, 0, 0, 0), (0, 0, 1, 1), (0, 1, 1, 0),
                 (0, 1, 2, int(kconserv[0, 1, 2]))]:
        out = fft_ao2mo.get_eri_kpts(sys_, case, device="cpu")
        assert _rel(out.numpy(), ref_ao2mo.get_eri_kpts(ref, case)) < 1e-12, case
    with pytest.raises(ValueError, match="momentum conservation"):
        fft_ao2mo.get_eri_kpts(sys_, (0, 1, 0, 0), device="cpu")


def test_ao2mo_7d(be_k):
    ref, sys_, res = be_k
    out = fft_ao2mo.ao2mo_7d(sys_, res["mo_coeff"], device="cpu")
    assert _rel(out.numpy(), ref_ao2mo.ao2mo_7d(ref, res["mo_coeff"])) < 1e-12


def test_kmp2_golden_and_parity(be_k):
    """The golden, and a ragged per-k occupation (both Be orbitals
    occupied at Gamma, one at +-k) padded as the reference pads it. (A
    ragged split between k-points that time reversal relates would put
    exactly degenerate levels on both sides of the gap: zero
    denominators.)"""
    ref, sys_, res = be_k
    e = kmp2_energy(sys_, res, device="cpu")
    assert abs(e - EMP2_BE_311) < 1e-9
    assert abs(e - ref_kmp2.kmp2_energy(ref, res)) < 1e-12
    ragged = kmp2_energy(sys_, res, nocc=[2, 1, 1], device="cpu")
    assert np.isfinite(ragged) and ragged != e
    assert abs(ragged - ref_kmp2.kmp2_energy(ref, res, nocc=[2, 1, 1])) < 1e-12


def test_kmp2_frozen_and_padding(diamond_k):
    """frozen=1 == dropping the lowest column by hand, a ragged per-k
    occupation padded as the reference pads it, and both against the
    reference (tests/test_ao2mo_kmp2.py:99,115)."""
    ref, sys_, res = diamond_k
    nocc = sys_.cell.nelectron // 2
    e_frozen = kmp2_energy(sys_, res, frozen=1, device="cpu")
    trunc = {"mo_coeff": [c[:, 1:] for c in res["mo_coeff"]],
             "mo_energy": [e[1:] for e in res["mo_energy"]]}
    assert abs(e_frozen - kmp2_energy(sys_, trunc, nocc=nocc - 1, device="cpu")) < 1e-12
    host = _host(res)
    assert abs(e_frozen - ref_kmp2.kmp2_energy(ref, host, frozen=1)) < 1e-12
    e = kmp2_energy(sys_, res, device="cpu")
    assert abs(kmp2_energy(sys_, res, nocc=[nocc] * 2, device="cpu") - e) < 1e-14
    assert abs(e - ref_kmp2.kmp2_energy(ref, host)) < 1e-12


def test_kump2_closed_shell(diamond_k):
    ref, sys_, res = diamond_k
    res_u = kuhf_kernel(sys_, xc=None, exxdiv="ewald", conv_tol=1e-11, device="cpu")
    assert abs(res_u["e_tot"] - res["e_tot"]) < 1e-8
    e_u = kump2_energy(sys_, res_u, device="cpu")
    assert abs(e_u - kmp2_energy(sys_, res, device="cpu")) < 1e-8
    host = {"mo_energy": tuple([np.asarray(e) for e in s] for s in res_u["mo_energy"]),
            "mo_coeff": tuple([np.asarray(c) for c in s] for s in res_u["mo_coeff"])}
    assert abs(e_u - ref_kmp2.kump2_energy(ref, host)) < 1e-12


def test_thc_kmp2(diamond_k):
    """The reference's c=10 k-point factors (with xi, for the phased
    kernels of the G != 0 blocks) through both THC-KMP2 assemblies."""
    ref, sys_, res = diamond_k
    fac = ref_isdf_k.build_isdf_k(ref.cell, ref.aoR_k, sys_.kpts, c=10, keep_xi=True)
    port_fac = isdfk_from_numpy(fac.Ug, fac.Wq, fac.qmap, fac.ip_idx, xi=fac.xi,
                                device="cpu")
    e = thc_kmp2_energy(sys_, res, port_fac, device="cpu")
    assert abs(e - ref_thc.thc_kmp2_energy(ref, _host(res), fac)) < 1e-10
    assert abs(e - kmp2_energy(sys_, res, device="cpu")) < 1e-8


def test_entry_points_default_to_cuda(be_gamma, be_k):
    """device=None means the GPU: without CUDA that raises, and a system
    built on the CPU is refused on the card."""
    _, sys_, res = be_gamma
    _, ksys, kres = be_k
    for call in (lambda: mp2_energy(sys_, res), lambda: kmp2_energy(ksys, kres),
                 lambda: fft_ao2mo.ao2mo_7d(ksys, kres["mo_coeff"])):
        with pytest.raises((RuntimeError, ValueError)):
            call()

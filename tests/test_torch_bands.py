"""Port band structure (get_bands, fftdf_k.get_k_band, 'vcut_sph' at a
k-point, analysis) and staggered-mesh KMP2 == JAX reference.

Both packages get the same converged density or orbitals (the port's SCF
handed to the reference), so each comparison holds one layer: the
diamond primitive cell on the shifted (2,1,1) k-mesh at 8^3 and at Gamma
at 9^3, band k-points on and off the SCF set (LDA, PBE, PBE0, HSE06 and
HF between the two); the staggered KMP2 on tests/test_kmp2_stagger.py's
H2 cell on a 10^3 mesh. Bars: 1e-12
relative for kernels and band AOs, 1e-10 for exchange matrices and band
energies, 1e-10 Ha for the staggered MP2 on the same orbitals.

The reference's band Fock takes vrho and vsigma of the converged
density: for LDA from its own functional under one jax.jit, for PBE, PBE0
and HSE06 from the port's pointwise functional (held to the reference's
own in tests/test_torch_xc.py), which spares a compile a functional, and
its band k-points' S and T are the port's closed forms (held to the
reference's at k-points in tests/test_torch_kscf.py, 1e-12), which spares
0.3 s of host loops a band k-point. The
Gamma cases run on a 9^3 mesh: on an even mesh the real Gamma SCF's
spectral AO gradient drops the Nyquist component that the band
k-point's complex one keeps (in both packages), which moves GGA band
energies at Gamma off the SCF's by 1e-7.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pyscf_isdf_tpu import build_cell as ref_build_cell  # noqa: E402
from pyscf_isdf_tpu import lattice as ref_lattice  # noqa: E402
from pyscf_isdf_tpu.df import fftdf_k as ref_fftdf_k  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.mp import kmp2_stagger as ref_stagger_mod  # noqa: E402
from pyscf_isdf_tpu.mp.kmp2_stagger import kmp2_stagger_energy as ref_stagger  # noqa: E402
from pyscf_isdf_tpu.ops import coulomb as ref_coulomb, xc as ref_xc  # noqa: E402
from pyscf_isdf_tpu.ops.ao_eval import eval_ao_numpy  # noqa: E402
from pyscf_isdf_tpu.scf import analysis as ref_analysis  # noqa: E402
from pyscf_isdf_tpu.scf import hf as ref_hf, khf as ref_khf  # noqa: E402
from pyscf_isdf_tpu.scf import bands as ref_bands_mod  # noqa: E402
from pyscf_isdf_tpu.scf.bands import get_bands as ref_bands  # noqa: E402

from pyscf_isdf_tpu_torch import build_cell, lattice  # noqa: E402
from pyscf_isdf_tpu_torch.df import fftdf_k  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.mp.kmp2 import kmp2_energy  # noqa: E402
from pyscf_isdf_tpu_torch.mp.kmp2_stagger import _mp_size, kmp2_stagger_energy  # noqa: E402
from pyscf_isdf_tpu_torch.ops import coulomb, xc  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ao_eval import eval_ao_kpts  # noqa: E402
from pyscf_isdf_tpu_torch.ops.ft_ao import overlap_and_kinetic as port_st  # noqa: E402
from pyscf_isdf_tpu_torch.scf import (  # noqa: E402
    analysis, build_kscf_system, build_scf_system, get_bands, kscf_kernel, scf_kernel,
)

MESH = (8, 8, 8)
TOL = 1e-10


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


PORT_XC = {"pbe", "pbe0", "hse06"}


@pytest.fixture(scope="module", autouse=True)
def _reference_compiled_once():
    closed = jax.jit(ref_xc.XCSpec.exc_vxc, static_argnums=0)

    def exc_vxc(self, *a):
        if self.name in PORT_XC:
            out = xc.XCSpec(self.name).exc_vxc(*(torch.as_tensor(np.array(x)) for x in a))
            return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), out)
        return closed(self, *a)

    def overlap_and_kinetic(cell, kpt=None):
        return tuple(t.numpy() for t in port_st(cell, kpt=kpt, device="cpu"))

    mp = pytest.MonkeyPatch()
    mp.setattr(ref_xc.XCSpec, "exc_vxc", exc_vxc)
    mp.setattr(ref_bands_mod, "overlap_and_kinetic", overlap_and_kinetic)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def kpoint():
    rcell = ref_diamond(mesh=MESH)
    kpts = ref_lattice.make_kpts(rcell.a, [2, 1, 1], with_gamma_point=False)
    sys_ = build_kscf_system(diamond_primitive(mesh=MESH), kpts, device="cpu")
    return _ref_ksystem(rcell, sys_), sys_, kpts


@pytest.fixture(scope="module")
def gamma():
    sys_ = build_scf_system(diamond_primitive(mesh=(9, 9, 9)), device="cpu")
    return _ref_system(ref_diamond(mesh=(9, 9, 9)), sys_), sys_


def _numpy(res):
    return {"dm": np.asarray(res["dm"])}


def test_vcut_sph_at_k(kpoint):
    """'vcut_sph' at a transfer off the SCF set, Rc from the SCF k-mesh."""
    _, _, kpts = kpoint
    rcell, cell = ref_diamond(mesh=MESH), diamond_primitive(mesh=MESH)
    q = kpts[1] - 0.3 * kpts[0]
    ref = ref_coulomb.get_coulG(rcell, k=q, exxdiv="vcut_sph", kpts=kpts)
    out = coulomb.get_coulG(cell, k=q, exxdiv="vcut_sph", kpts=kpts)
    assert np.abs(out - ref).max() < 1e-12 * np.abs(ref).max()
    nk_rc = (3 * 2 * cell.vol / (4 * np.pi)) ** (1 / 3)
    g0 = coulomb.get_coulG(cell, exxdiv="vcut_sph", kpts=kpts)[0]
    assert abs(g0 - 2 * np.pi * nk_rc**2) < 1e-12 * g0


def test_band_aos_and_k_band(kpoint):
    """Band AOs at off-mesh k-points (1e-12 relative) and the exchange at
    one and at several band k-points against the reference's (1e-10)."""
    ref_sys, sys_, kpts = kpoint
    cell = sys_.cell
    kb = np.array([0.5 * (kpts[0] + kpts[1]), [0.1, -0.2, 0.3]])
    ao = eval_ao_kpts(cell, kb, device="cpu").numpy()
    for i, k in enumerate(kb):
        ref = eval_ao_numpy(ref_sys.cell, kpt=k)
        assert np.abs(ao[i] - ref).max() < 1e-12 * np.abs(ref).max()
    rng = np.random.default_rng(3)
    nk, nao = sys_.S.shape[:2]
    dm = rng.standard_normal((nk, nao, nao)) + 1j * rng.standard_normal((nk, nao, nao))
    coords = cell.uniform_grid()
    cG = np.stack([[coulomb.get_coulG(cell, k=k2 - k, kpts=kpts) for k2 in kpts] for k in kb])
    ph = np.exp(-1j * np.einsum("gx,bkx->bkg", coords, kpts[None] - kb[:, None]))
    w = sys_.weight / nk
    out = fftdf_k.get_k_band(torch.as_tensor(ao), sys_.aoR_k, torch.as_tensor(dm),
                             torch.as_tensor(cG), torch.as_tensor(ph), MESH, w).numpy()
    for i in range(len(kb)):
        ref = np.asarray(ref_fftdf_k.get_k_band(
            jnp.asarray(ao[i]), jnp.asarray(ref_sys.aoR_k), jnp.asarray(dm),
            jnp.asarray(cG[i]), jnp.asarray(ph[i]), MESH, w))
        assert np.abs(out[i] - ref).max() < TOL * np.abs(ref).max()
        one = fftdf_k.get_k_band(torch.as_tensor(ao[i]), sys_.aoR_k, torch.as_tensor(dm),
                                 torch.as_tensor(cG[i]), torch.as_tensor(ph[i]), MESH, w)
        assert np.abs(one.numpy() - ref).max() < TOL * np.abs(ref).max()


@pytest.mark.parametrize("xc", ["lda,vwn", "pbe0", "hse06", None])
def test_bands_kpoint(kpoint, xc):
    """The band Fock from one converged k-point density in both packages:
    at the SCF k-points (the ewald shift) and off them; at the SCF
    k-points the SCF's own eigenvalues."""
    ref_sys, sys_, kpts = kpoint
    res = kscf_kernel(sys_, xc=xc, conv_tol=1e-12, device="cpu")
    kb = np.vstack([kpts[1:], 0.5 * (kpts[0] + kpts[1])])
    es, cs = get_bands(sys_, res, kb, xc=xc, device="cpu")
    ref, _ = ref_bands(ref_sys, _numpy(res), kb, xc=xc)
    assert np.abs(es.numpy() - ref).max() < TOL
    assert np.abs(es[0].numpy() - res["mo_energy"][1].numpy()).max() < 1e-8
    assert len(cs) == 2 and cs[0].shape == (sys_.S.shape[1],) * 2


def test_bands_vcut_sph(kpoint):
    """The staggered MP2's band step: exchange with the truncated kernel."""
    ref_sys, sys_, kpts = kpoint
    res = kscf_kernel(sys_, xc=None, conv_tol=1e-10, device="cpu")
    kb = np.vstack([kpts[:1], kpts[:1] + 0.25])
    es, _ = get_bands(sys_, res, kb, exxdiv="vcut_sph", device="cpu")
    ref, _ = ref_bands(ref_sys, _numpy(res), kb, exxdiv="vcut_sph")
    assert np.abs(es.numpy() - ref).max() < TOL


@pytest.mark.parametrize("xc", ["pbe", "hse06"])
def test_bands_gamma(gamma, xc):
    """A Gamma system: bands at Gamma reproduce the SCF and match the
    reference there and off Gamma."""
    ref_sys, sys_ = gamma
    res = scf_kernel(sys_, xc=xc, conv_tol=1e-12)
    kb = np.array([[0.0, 0.0, 0.0], [0.2, 0.1, -0.3]])
    es, _ = get_bands(sys_, res, kb, xc=xc, device="cpu")
    ref, _ = ref_bands(ref_sys, _numpy(res), kb, xc=xc)
    assert np.abs(es.numpy() - ref).max() < TOL
    assert np.abs(es[0].numpy() - res["mo_energy"].numpy()).max() < 1e-8


def test_bands_meta_gga_raises(gamma):
    """The reference's band Fock has no tau term: a meta-GGA raises there
    (ValueError from its functional) and in the port."""
    ref_sys, sys_ = gamma
    dm = scf_kernel(sys_, xc="lda,vwn", conv_tol=1e-8)["dm"]
    with pytest.raises(ValueError):
        ref_bands(ref_sys, {"dm": dm.numpy()}, np.zeros((1, 3)), xc="scan")
    with pytest.raises(ValueError, match="meta-GGA"):
        get_bands(sys_, {"dm": dm}, np.zeros((1, 3)), xc="scan", device="cpu")


def test_analysis(gamma, kpoint):
    ref_sys, sys_ = gamma
    res = scf_kernel(sys_, xc="lda,vwn", conv_tol=1e-10)
    pop, q = analysis.mulliken_pop(sys_.cell, res["dm"], sys_.S)
    pop0, q0 = ref_analysis.mulliken_pop(ref_sys.cell, res["dm"].numpy(), ref_sys.S)
    assert np.abs(pop.numpy() - pop0).max() < 1e-12 and np.abs(q.numpy() - q0).max() < 1e-12
    assert abs(float(q.sum())) < 1e-8
    spin = torch.stack([0.5 * res["dm"], 0.5 * res["dm"]])
    assert torch.allclose(analysis.mulliken_pop(sys_.cell, spin, sys_.S)[1], q)
    _, ksys, _ = kpoint
    kres = kscf_kernel(ksys, xc="lda,vwn", conv_tol=1e-10, device="cpu")
    e_k = torch.stack(kres["mo_energy"])
    nocc = ksys.cell.nelectron // 2
    assert analysis.homo_lumo_gap(e_k, 2 * nocc) == pytest.approx(
        ref_analysis.homo_lumo_gap(e_k.numpy(), 2 * nocc), abs=1e-14)
    assert analysis.homo_lumo_gap(kres["mo_energy"], 2 * nocc)[2] > 0
    grid, dos = analysis.density_of_states(e_k, sigma=0.02, npts=200)
    grid0, dos0 = ref_analysis.density_of_states(e_k.numpy(), sigma=0.02, npts=200)
    assert np.abs(grid.numpy() - grid0).max() < 1e-14
    assert np.abs(dos.numpy() - dos0).max() < 1e-12 * dos0.max()
    for path in ("LGXG", "GXWKGL"):
        for a, b in zip(analysis.band_path(ksys.cell, path, npoints=7),
                        ref_analysis.band_path(ref_sys.cell, path, npoints=7)):
            assert np.array_equal(a, b)


def _h2(build):
    return build(6.0 * np.eye(3), [["H", (3.0, 3.0, 2.10)], ["H", (3.0, 3.0, 3.90)]],
                 basis="gth-szv", pseudo="gth-pade", mesh=[10, 10, 10])


@pytest.mark.parametrize("flag_submesh,nks", [(True, [2, 2, 2]), (False, [2, 1, 1])])
def test_kmp2_stagger(flag_submesh, nks):
    """Both modes against the reference on the same orbitals (the port's
    KRHF handed to both) on tests/test_kmp2_stagger.py's H2 cell: the
    submesh mode on its 2x2x2 mesh, the non-SCF bands on a 2x1x1 one (4
    band k-points for 16); the submesh energy lies below the standard
    KMP2, as in the reference's goldens."""
    kpts = lattice.make_kpts(_h2(build_cell).a, nks, with_gamma_point=True)
    sys_ = build_kscf_system(_h2(build_cell), kpts, device="cpu")
    res = kscf_kernel(sys_, xc=None, conv_tol=1e-11, device="cpu")
    ref_res = {"dm": np.asarray(res["dm"]),
               "mo_energy": [e.numpy() for e in res["mo_energy"]],
               "mo_coeff": [c.numpy() for c in res["mo_coeff"]]}
    out = kmp2_stagger_energy(sys_, res, flag_submesh=flag_submesh, device="cpu")
    ref = ref_stagger(_ref_ksystem(_h2(ref_build_cell), sys_), ref_res,
                      flag_submesh=flag_submesh)
    assert abs(out - ref) < TOL
    e_std = kmp2_energy(sys_, res, device="cpu")
    assert out < e_std if flag_submesh else out < 0


def test_stagger_submesh_needs_even_mesh():
    cell = diamond_primitive(mesh=MESH)
    sys_ = SimpleNamespace(cell=cell, kpts=lattice.make_kpts(cell.a, [3, 1, 1]),
                           aoR_k=torch.zeros(1))
    with pytest.raises(RuntimeError, match="even mesh"):
        kmp2_stagger_energy(sys_, {}, flag_submesh=True, device="cpu")


def test_mp_size_on_fcc_mesh():
    """The mesh size read off the k-points (ROADMAP queue 3 (l)): the
    reference wraps the fractional coordinates into [0, 1) before it
    rounds them, so the -1e-17 of a Gamma-centred diamond (fcc) mesh
    becomes 1.0 and every axis reads one point too long; the port rounds
    first. On the cubic H2 cell the two agree."""
    cell = diamond_primitive(mesh=MESH)
    for nks, ref in (([2, 2, 2], [3, 3, 3]), ([3, 3, 3], [4, 4, 4]), ([2, 1, 1], [2, 2, 2])):
        kpts = lattice.make_kpts(cell.a, nks)
        assert _mp_size(cell.a, kpts).tolist() == nks
        assert ref_stagger_mod._mp_size(cell.a, kpts).tolist() == ref
    h2 = _h2(build_cell)
    kpts = lattice.make_kpts(h2.a, [2, 2, 2])
    assert _mp_size(h2.a, kpts).tolist() == ref_stagger_mod._mp_size(h2.a, kpts).tolist() \
        == [2, 2, 2]

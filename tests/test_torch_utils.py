"""Port tools and utils (tools.py, utils/) == JAX reference.

Checkpoints round-trip bit-exactly in both directions between the packages
(one file format); ``super_cell`` equals the JAX one to 1e-14; the config
tier reads the same environment variables as the JAX package's;
``fingerprint`` equals the reference's ``lib.fp`` form; the logger's
levels; and ``utils.profiling.trace`` writes a CPU trace holding the
``annotate`` range.
"""
import importlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401

from pyscf_isdf_tpu import tools as ref_tools  # noqa: E402
from pyscf_isdf_tpu.models import diamond_primitive as ref_diamond  # noqa: E402
from pyscf_isdf_tpu.utils import chkfile as ref_chk  # noqa: E402
from pyscf_isdf_tpu.utils import config as ref_config  # noqa: E402
from pyscf_isdf_tpu.utils import misc as ref_misc  # noqa: E402

from pyscf_isdf_tpu_torch import tools  # noqa: E402
from pyscf_isdf_tpu_torch.models import diamond_primitive  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system, scf_kernel  # noqa: E402
from pyscf_isdf_tpu_torch.utils import chkfile, config, logger, misc, profiling  # noqa: E402

MESH = (9, 9, 9)


@pytest.fixture(scope="module")
def state():
    cell = diamond_primitive(mesh=MESH)
    sys_ = build_scf_system(cell, device="cpu")
    return cell, sys_, scf_kernel(sys_, xc="lda,vwn", conv_tol=1e-10)


def _same_cell(a, b):
    for f in ("a", "coords", "charges"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in ("symbols", "mesh", "precision", "rcut", "ke_cutoff", "spin", "charge",
              "dimension"):
        assert getattr(a, f) == getattr(b, f), f
    assert len(a.shells) == len(b.shells)
    for s, t in zip(a.shells, b.shells):
        assert (s.atom, s.l) == (t.atom, t.l)
        assert np.array_equal(s.exps, t.exps) and np.array_equal(s.coeffs, t.coeffs)
    assert {k: (p.nelec, p.rloc, p.cexp, p.proj_rl, p.proj_h) for k, p in a.pseudos.items()} \
        == {k: (p.nelec, p.rloc, p.cexp, p.proj_rl, p.proj_h) for k, p in b.pseudos.items()}


def test_cell_json_is_the_reference_format(state):
    cell = state[0]
    s = chkfile.dumps_cell(cell)
    assert s == ref_chk.dumps_cell(ref_diamond(mesh=MESH))
    _same_cell(chkfile.loads_cell(s), cell)
    _same_cell(ref_chk.loads_cell(s), ref_diamond(mesh=MESH))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_scf_checkpoint_round_trip(state, tmp_path, writer):
    """A file either package writes loads bit-exactly in both."""
    cell, sys_, res = state
    path = str(tmp_path / "scf.npz")
    if writer == "port":
        chkfile.save_scf(path, cell, res)
    else:
        host = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in res.items()}
        ref_chk.save_scf(path, ref_diamond(mesh=MESH), host)
    for load in (chkfile.load_scf, ref_chk.load_scf):
        c, out = load(path)
        _same_cell(c, cell)
        assert out["e_tot"] == res["e_tot"]
        for key in ("mo_energy", "mo_coeff", "dm"):
            assert np.array_equal(out[key], res[key].numpy()), key
        assert bool(out["converged"]) and int(out["niter"]) == res["niter"]
    dm0 = chkfile.init_guess_by_chkfile(path)
    assert np.array_equal(dm0, res["dm"].numpy())
    again = scf_kernel(sys_, xc="lda,vwn", conv_tol=1e-10, dm0=torch.as_tensor(dm0))
    assert again["niter"] <= 2
    assert abs(again["e_tot"] - res["e_tot"]) < 1e-10


def test_super_cell_matches_reference():
    nrep = (2, 1, 3)
    sc = tools.super_cell(diamond_primitive(mesh=(6, 6, 6)), nrep)
    ref = ref_tools.super_cell(ref_diamond(mesh=(6, 6, 6)), nrep)
    assert np.abs(sc.a - ref.a).max() < 1e-14
    assert np.abs(sc.coords - ref.coords).max() < 1e-14
    assert sc.symbols == ref.symbols and sc.mesh == ref.mesh == (12, 6, 18)
    assert np.array_equal(sc.charges, ref.charges)
    assert sc.nao == ref.nao and sc.nelectron == ref.nelectron
    assert [(s.atom, s.l) for s in sc.shells] == [(s.atom, s.l) for s in ref.shells]
    for s, t in zip(sc.shells, ref.shells):
        assert np.abs(s.coeffs - t.coeffs).max() < 1e-14


def test_config_reads_the_shared_environment(tmp_path, monkeypatch):
    conf = tmp_path / "conf.py"
    conf.write_text("EXTRA_SETTING = 'from file'\nVERBOSE = 5\n")
    monkeypatch.setenv("PYSCF_ISDF_TPU_MAX_MEMORY", "1234")
    monkeypatch.setenv("PYSCF_ISDF_TPU_ISDF_C", "12.5")
    monkeypatch.setenv("PYSCF_ISDF_TPU_CONFIG_FILE", str(conf))
    try:
        for mod in (importlib.reload(config), importlib.reload(ref_config)):
            assert mod.MAX_MEMORY == 1234 and mod.ISDF_DEFAULT_C == 12.5
            assert mod.VERBOSE == 5 and mod.get("EXTRA_SETTING") == "from file"
            assert mod.get("NO_SUCH", 7) == 7
    finally:
        monkeypatch.undo()
        for mod in (config, ref_config):
            vars(mod).pop("EXTRA_SETTING", None)
            importlib.reload(mod)
    assert config.MAX_MEMORY == ref_config.MAX_MEMORY != 1234


def test_fingerprint():
    a = np.random.default_rng(3).normal(size=(5, 7))
    assert misc.fingerprint(a) == ref_misc.fingerprint(a)
    assert misc.fingerprint(torch.as_tensor(a)) == ref_misc.fingerprint(a)


def test_logger_levels():
    buf = io.StringIO()
    log = logger.Logger(verbose=logger.INFO, stdout=buf)
    log.info("shown %d", 1)
    log.debug("hidden")
    log.warn("careful")
    t = log.timer("stage")
    assert buf.getvalue().splitlines() == ["shown 1", "WARN: careful"]
    assert len(t) == 2
    logger.Logger(verbose=logger.DEBUG, stdout=buf).timer("stage", t)
    assert "CPU time for stage" in buf.getvalue()


def test_profiler_trace_writes_file(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("isdf_probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "isdf_probe" for e in events)
    assert any(k.key == "isdf_probe" for k in prof.key_averages())

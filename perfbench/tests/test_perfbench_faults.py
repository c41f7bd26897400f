"""The check fails a run whose timed path is broken underneath: each fault
is planted in the program, the rest of the run is driven as on the card
(on the CPU, at the test size), and ``correct`` must come out false. A
fault between chips cannot occur: every cell takes one card."""
import time

import pytest
import torch

from perfbench import harness, registry


def _state_unchanged(monkeypatch):
    """Every SCF step hands back the density it was given."""
    from pyscf_isdf_tpu_torch.scf import hf

    first = {}
    real = hf.make_rdm1

    def stuck(mo_coeff, nocc):
        return first.setdefault("dm", real(mo_coeff, nocc))

    monkeypatch.setattr(hf, "make_rdm1", stuck)


def _half_batch(monkeypatch):
    """J from every other grid point, the mean taken over the rest."""
    from pyscf_isdf_tpu_torch.df import fftdf

    def half_j(aoR, dm, coulG, mesh, weight):
        rho = fftdf.get_rho(aoR, dm)
        vR = fftdf.ifft3(coulG * fftdf.fft3(fftdf._complex(rho), mesh), mesh).real
        a = aoR[::2]
        return 2.0 * weight * ((a.T * vR[::2]) @ a)

    monkeypatch.setattr(fftdf, "get_j", half_j)


def _answer_altered(monkeypatch):
    """The solve's energy altered by 1 micro-Hartree where it is produced."""
    from pyscf_isdf_tpu_torch.scf import hf

    real = hf.scf_kernel

    def altered(*a, **kw):
        res = real(*a, **kw)
        res["e_tot"] += 1e-6
        return res

    monkeypatch.setattr(hf, "scf_kernel", altered)


def _wrong_pivot(monkeypatch):
    """One interpolation point that is not a greedy choice."""
    from pyscf_isdf_tpu_torch.df import isdf

    real = isdf.pivoted_cholesky_points

    def wrong(aoR, n_ip):
        idx, d = real(aoR, n_ip)
        idx = idx.clone()
        worst = int(torch.argmin((aoR * aoR).sum(1)))
        if worst not in idx.tolist():
            idx[3] = worst
        return idx, d

    monkeypatch.setattr(isdf, "pivoted_cholesky_points", wrong)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "wrong_pivot": _wrong_pivot}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["prim9.scf", "prim9.geom"])
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    bench, base = tiny
    FAULTS[fault](monkeypatch)
    r = harness.run_cell(bench, registry.find_workload(bench, cell), 2**31 + 99, 0.3,
                         False, "cpu", time.perf_counter(), base=base)
    assert not r["correct"], r["checks"]

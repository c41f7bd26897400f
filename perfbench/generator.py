"""The one generator of the benchmark's traffic: a closed loop with one
caller, driven by a mix's parameters (``traffic/<name>.json``).

A unit of work is one converged SCF solve of the program. The mix says

* ``geometry``: ``fixed`` (the snapshot of the mix's ``geometry_seed``,
  built in set-up) or ``fresh`` (every unit builds the system of its own
  snapshot, drawn from the run's seed and the unit's step);
* ``exchange``: ``setup-factorization`` (set-up builds one robust ISDF
  factorization and every solve calls the J and K engines through a
  ``get_jk`` hook) or ``in-program`` (the solve builds its factorization
  inside ``scf_kernel(df='isdf-robust')``);
* ``start``: ``core`` (the core-Hamiltonian guess) or ``previous`` (the
  density of the unit before);
* ``warmup_units``: units run in set-up, which warm every shape the
  window uses.

Every key of the configuration and of the mix is honoured or refused in
set-up, before the window: a configuration may state only the values
that these paths run (``REALISES``), and a key that nothing reads and
that is no note is an error.
"""
from __future__ import annotations

import contextlib
import time

import torch

from . import geometry

GEOMETRIES = ("fixed", "fresh")
EXCHANGES = ("setup-factorization", "in-program")
STARTS = ("core", "previous")
# Configuration keys the benchmark reads, the one value of each key that
# the generator's paths run (robust K through ``get_k_robust`` or
# ``df='isdf-robust'``, greedy pivoted-Cholesky points), and notes.
READS = frozenset({"lattice", "basis", "pseudo", "mesh", "xc", "exxdiv", "isdf_c",
                   "dtype", "conv_tol", "displacement_sigma_bohr", "reference"})
REALISES = {"isdf_fit": "robust", "isdf_selection": "greedy"}
NOTES = frozenset({"source", "description", "reduced", "assumed", "guarantees"})
MIX_KEYS = frozenset({"description", "geometry", "geometry_seed", "exchange", "start",
                      "warmup_units", "per_unit_metric", "traced_units", "stage_timer",
                      "checked_units"})


def check_inputs(config, mix):
    """Refuse a configuration or mix that asks for what the generator does
    not run."""
    unknown = set(config) - READS - set(REALISES) - NOTES
    if unknown:
        raise ValueError(f"configuration keys nothing reads: {sorted(unknown)}")
    for key, value in REALISES.items():
        if config.get(key) != value:
            raise ValueError(f"configuration {key}={config.get(key)!r}: "
                             f"the generator runs {key}={value!r} only")
    unknown = set(mix) - MIX_KEYS
    if unknown:
        raise ValueError(f"traffic keys nothing reads: {sorted(unknown)}")
    for key, allowed in (("geometry", GEOMETRIES), ("exchange", EXCHANGES),
                         ("start", STARTS)):
        if mix[key] not in allowed:
            raise ValueError(f"traffic {key}={mix[key]!r}: use one of {allowed}")


class Generator:
    def __init__(self, config, mix, seed, device, dtype=None):
        from pyscf_isdf_tpu_torch import build_cell
        from pyscf_isdf_tpu_torch.df import fftdf, isdf
        from pyscf_isdf_tpu_torch.scf import hf

        check_inputs(config, mix)
        self.build_cell, self.fftdf, self.isdf, self.hf = build_cell, fftdf, isdf, hf
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.dtype = getattr(torch, dtype or config["dtype"])
        self.tracing = False
        self.system = self.fac = self.prev_dm = None
        self.shapes = {}

    def _range(self, name):
        return (torch.profiler.record_function(name) if self.tracing
                else contextlib.nullcontext())

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _build(self, step, timer):
        cfg = self.config
        geo = geometry.unit_geometry(cfg, self.mix, self.seed, step)
        self.system = self.fac = None
        with self._range("perfbench.build_system"):
            cell = self.build_cell(geo["a"], [[s, tuple(c)] for s, c in
                                              zip(geo["symbols"], geo["coords"])],
                                   cfg["basis"], pseudo=cfg["pseudo"],
                                   mesh=tuple(cfg["mesh"]), unit="Bohr")
            self.system = self.hf.build_scf_system(cell, device=self.device,
                                                   dtype=self.dtype, timer=timer)
        if self.mix["exchange"] == "setup-factorization":
            s = self.system
            with self._range("perfbench.build_isdf"):
                self.fac = self.isdf.build_isdf(s.aoR, s.coulG, s.mesh, s.weight,
                                                c=cfg["isdf_c"], keep_v=True, timer=timer)

    def _get_jk(self, dm, with_k):
        s = self.system
        dmj = dm.to(s.aoR.dtype)
        with self._range("perfbench.get_j"):
            vj = self.fftdf.get_j(s.aoR, dmj, s.coulG, s.mesh, s.weight)
        if not with_k:
            return vj, None
        with self._range("perfbench.get_k"):
            vk = self.isdf.get_k_robust(self.fac, s.aoR, dmj, s.weight)
        return vj, vk

    def setup(self):
        """Set-up: the fixed geometry's system and factorization, then the
        warm-up units (step 0). Returns the seconds of the two parts."""
        t0 = time.perf_counter()
        if self.mix["geometry"] == "fixed":
            self._build(0, None)
        self.sync()
        t1 = time.perf_counter()
        for _ in range(self.mix["warmup_units"]):
            self.unit(0)
        return {"system_and_factorization": t1 - t0, "warmup": time.perf_counter() - t1}

    def unit(self, k, timer=None):
        """Run unit ``k`` (geometry step ``k`` of a fresh mix); returns its
        record. ``timer`` is a StageTimer for this unit or None."""
        cfg = self.config
        step = 0 if self.mix["geometry"] == "fixed" else k
        t0 = time.perf_counter()
        with self._range("perfbench.unit"):
            if self.mix["geometry"] == "fresh":
                self._build(step, timer)
            kw = dict(xc=cfg["xc"], exxdiv=cfg["exxdiv"], conv_tol=cfg["conv_tol"],
                      dm0=self.prev_dm if self.mix["start"] == "previous" else None,
                      timer=timer)
            with self._range("perfbench.solve"):
                if self.mix["exchange"] == "setup-factorization":
                    res = self.hf.scf_kernel(self.system, get_jk=self._get_jk, **kw)
                else:
                    res = self.hf.scf_kernel(self.system, df="isdf-robust",
                                             isdf_c=cfg["isdf_c"], **kw)
            self.sync()
        seconds = time.perf_counter() - t0
        pivots = (self.fac if self.fac is not None else res["isdf"]).ip_idx
        self.shapes = dict(ng=int(self.system.aoR.shape[0]),
                           nao=int(self.system.aoR.shape[1]), nip=int(pivots.numel()))
        self.prev_dm = res["dm"]
        return dict(k=k, step=step, seconds=seconds, e_tot=float(res["e_tot"]),
                    dm=res["dm"], niter=int(res["niter"]),
                    converged=bool(res["converged"]), pivots=pivots)

    def release(self):
        """Free the program's state (the records keep their outputs)."""
        self.system = self.fac = self.prev_dm = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

"""Deciding ``correct``: the program's solves against the plain reference.

The reference that the configuration names (``reference/<name>.py``, a
module with ``SOLVES`` and ``solve``) works every system out again from the
seeded geometry, judges the program's interpolation points step by step
(``pivot_gap``), builds its own factorization on them and runs its own
SCF from the core guess. The numbers compared, each against its limit in
``limits/<cell>.json``:

* ``pivot_gap``: the largest relative shortfall of a program pivot's
  residual below the greedy maximum;
* ``e_gap_ha``: the largest |E_program - E_reference| over the checked
  solves (Ha);
* ``dm_gap``: the largest |D_program - D_reference| entry over them;
* ``unconverged``: window solves that did not converge (limit 0).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import geometry, registry


def reference_for(config):
    """The configuration's plain reference, refused in set-up when it does
    not solve what the configuration states."""
    ref = registry.load_reference(config["reference"])
    other = {k: config.get(k) for k, v in ref.SOLVES.items() if config.get(k) != v}
    if other:
        raise ValueError(f"reference {config['reference']!r} solves {ref.SOLVES}, "
                         f"not {other}")
    return ref


def chosen(records, mix, seed):
    """The records checked: all, or a sample drawn from the seed."""
    n = mix["checked_units"]
    if n == "all" or n >= len(records):
        return list(records)
    rng = np.random.default_rng([seed % 2**64, 1])
    return [records[i] for i in sorted(rng.choice(len(records), n, replace=False))]


def judge(config, mix, records, seed, device, reference):
    """The numbers compared (see the module docstring), against the
    ``reference`` module."""
    numbers = dict(pivot_gap=0.0, e_gap_ha=0.0, dm_gap=0.0,
                   unconverged=float(sum(not r["converged"] for r in records)))
    groups = {}
    for r in chosen(records, mix, seed):
        groups.setdefault((r["step"], id(r["pivots"])), []).append(r)
    for group in groups.values():
        geo = geometry.unit_geometry(config, mix, seed, group[0]["step"])
        ref = reference.solve(geo, config, device, group[0]["pivots"])
        numbers["pivot_gap"] = max(numbers["pivot_gap"], ref["pivot_gap"])
        for r in group:
            if ref["e_tot"] is None or not math.isfinite(r["e_tot"]):
                numbers["e_gap_ha"] = numbers["dm_gap"] = math.inf
                continue
            dm = r["dm"].to(device=ref["dm"].device, dtype=torch.float64)
            numbers["e_gap_ha"] = max(numbers["e_gap_ha"], abs(r["e_tot"] - ref["e_tot"]))
            numbers["dm_gap"] = max(numbers["dm_gap"], float((dm - ref["dm"]).abs().max()))
        del ref
    return numbers


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}}) over the numbers that the
    cell's ``limits`` file holds a limit for: every one at or under its
    limit, a number that is not finite failing."""
    out, ok = {}, True
    for name, limit in limits["limits"].items():
        value, limit = numbers[name], float(limit)
        ok = ok and math.isfinite(value) and value <= limit
        out[name] = {"value": value if math.isfinite(value) else 1e300, "limit": limit}
    return ok, out

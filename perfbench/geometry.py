"""Seeded geometries: the configuration's equilibrium crystal plus a
Gaussian displacement of every atom, drawn from (seed, step), and for a
``fixed`` mix a rigid shift by whole grid steps, drawn from the seed.

The benchmark hands the same lattice rows and positions (Bohr) to the
program and to the reference.
"""
from __future__ import annotations

import numpy as np

BOHR = 0.52917721092      # Angstrom per Bohr (CODATA 2010)


def equilibrium(config):
    """(a, symbols, coords) of the configuration's supercell, Bohr."""
    lat = config["lattice"]
    a0 = np.asarray(lat["primitive_a_angstrom"], dtype=np.float64)
    nrep = lat["supercell"]
    atoms = []
    for i in range(nrep[0]):
        for j in range(nrep[1]):
            for k in range(nrep[2]):
                shift = i * a0[0] + j * a0[1] + k * a0[2]
                for sym, pos in lat["basis_angstrom"]:
                    atoms.append((sym, np.asarray(pos, dtype=np.float64) + shift))
    a = a0 * np.asarray(nrep, dtype=np.float64)[:, None] / BOHR
    coords = np.array([p for _, p in atoms]) / BOHR
    return a, tuple(s for s, _ in atoms), coords


def snapshot(config, seed, step):
    """The geometry of ``step`` under ``seed``: every Cartesian component of
    every atom displaced by N(0, sigma^2), sigma from the configuration."""
    a, symbols, coords = equilibrium(config)
    rng = np.random.default_rng([seed % 2**64, step])
    disp = rng.normal(0.0, config["displacement_sigma_bohr"], coords.shape)
    return {"a": a, "symbols": symbols, "coords": coords + disp}


def grid_shift(config, geo, seed):
    """``geo`` moved rigidly by a whole number of grid steps along each
    lattice row, drawn from ``seed``, and wrapped into the cell: the same
    problem on a cyclically shifted grid, so the same work in another
    order."""
    a = np.asarray(geo["a"], dtype=np.float64)
    mesh = np.asarray(config["mesh"])
    rng = np.random.default_rng([seed % 2**64, 1, 7])
    frac = geo["coords"] @ np.linalg.inv(a) + rng.integers(0, mesh) / mesh
    return dict(geo, coords=(frac - np.floor(frac)) @ a)


def unit_geometry(config, mix, seed, step):
    """The geometry of a mix's unit ``step``. A ``fixed`` mix solves the one
    snapshot of its own ``geometry_seed``, moved by the run seed's
    :func:`grid_shift`: a fresh displacement changed the work there (a
    solve's iteration count follows its geometry), a shift does not."""
    if mix["geometry"] == "fixed":
        return grid_shift(config, snapshot(config, mix["geometry_seed"], 0), seed)
    return snapshot(config, seed, step)

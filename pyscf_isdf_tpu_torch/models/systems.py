"""Canonical benchmark/validation systems.

Geometries match the reference test-suite cells so golden energies carry
over directly (e.g. pyscf/pbc/dft/test/test_krks.py:28-63 diamond cells).
"""
from __future__ import annotations

import numpy as np

from pyscf_isdf_tpu_torch.cell import BOHR, build_cell


def diamond_primitive(mesh=(17, 17, 17), basis="gth-szv", pseudo="gth-pade",
                      ke_cutoff=None, **kw):
    """2-atom fcc diamond primitive cell (a = 3.5668 A)."""
    return build_cell(
        a=[[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834], [1.7834, 1.7834, 0.0]],
        atom=[["C", (0.0, 0.0, 0.0)], ["C", (0.8917, 0.8917, 0.8917)]],
        basis=basis, pseudo=pseudo, mesh=mesh, ke_cutoff=ke_cutoff,
        unit="Angstrom", **kw,
    )


def diamond_cubic(mesh=(17, 17, 17), basis="gth-szv", pseudo="gth-pade", **kw):
    """8-atom conventional cubic diamond cell (a = 3.5668 A)."""
    a = 3.5668
    h = a / 4
    frac = [
        (0, 0, 0), (1, 1, 1), (2, 2, 0), (3, 3, 1),
        (2, 0, 2), (3, 1, 3), (0, 2, 2), (1, 3, 3),
    ]
    atoms = [["C", (x * h, y * h, z * h)] for x, y, z in frac]
    return build_cell(a=np.eye(3) * a, atom=atoms, basis=basis, pseudo=pseudo,
                      mesh=mesh, unit="Angstrom", **kw)


def diamond_supercell(nrep=(2, 2, 2), mesh=None, basis="gth-szv",
                      pseudo="gth-pade", ke_cutoff=None, **kw):
    """n x n x n repetition of the primitive diamond cell (Gamma supercell)."""
    a0 = np.array([[0.0, 1.7834, 1.7834], [1.7834, 0.0, 1.7834],
                   [1.7834, 1.7834, 0.0]])
    base = [np.zeros(3), np.array([0.8917, 0.8917, 0.8917])]
    nrep = np.asarray(nrep)
    atoms = []
    for i in range(nrep[0]):
        for j in range(nrep[1]):
            for k in range(nrep[2]):
                shift = i * a0[0] + j * a0[1] + k * a0[2]
                for b in base:
                    atoms.append(["C", tuple(b + shift)])
    return build_cell(a=a0 * nrep[:, None], atom=atoms, basis=basis,
                      pseudo=pseudo, mesh=mesh, ke_cutoff=ke_cutoff,
                      unit="Angstrom", **kw)


def graphene(mesh=None, basis="gth-szv", pseudo="gth-pade", vacuum=20.0,
             ke_cutoff=None, **kw):
    """Graphene sheet in a 3D cell with ``vacuum`` Bohr of separation.

    (3D periodic treatment with large c; the reference's 2D coulomb kernel
    is a separate low-dimension feature.)
    """
    # standard hexagonal lattice: a = 2.46 A (C-C bond 1.42 A)
    a = 2.46
    lat = np.array([[a, 0, 0], [-a / 2, a * np.sqrt(3) / 2, 0],
                    [0, 0, vacuum * BOHR]])
    atoms = [["C", (0.0, 0.0, 0.0)],
             ["C", (0.0, a / np.sqrt(3), 0.0)]]
    return build_cell(a=lat, atom=atoms, basis=basis, pseudo=pseudo,
                      mesh=mesh, ke_cutoff=ke_cutoff, unit="Angstrom", **kw)

"""Cell manipulation utilities.

``super_cell`` replicates a cell into an n1 x n2 x n3 Gamma supercell
(reference: pyscf/pbc/tools/pbc.py:595-650), the workhorse of the
supercell-against-k-mesh equivalence checks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from pyscf_isdf_tpu_torch.cell import Cell, build_cell


def super_cell(cell: Cell, nrep, mesh=None) -> Cell:
    """Replicate ``cell`` into a prod(nrep) Gamma supercell.

    The default supercell FFT mesh replicates the primitive mesh per axis
    (the same plane-wave resolution, so the supercell at Gamma matches the
    primitive cell sampled on the corresponding k-mesh).
    """
    nrep = np.asarray(nrep, dtype=int)
    a = cell.a * nrep[:, None]
    atoms = []
    for i in range(nrep[0]):
        for j in range(nrep[1]):
            for k in range(nrep[2]):
                shift = i * cell.a[0] + j * cell.a[1] + k * cell.a[2]
                for ia in range(cell.natm):
                    atoms.append([cell.symbols[ia], tuple(cell.coords[ia] + shift)])
    if mesh is None:
        mesh = tuple(int(n * m) for n, m in zip(nrep, cell.mesh))

    # the shells carry normalized coefficients already: graft them onto
    # the replicated atoms instead of loading the basis again
    shells_per_atom = {}
    for sh in cell.shells:
        shells_per_atom.setdefault(sh.atom, []).append(sh)
    sc = build_cell(
        a, atoms,
        basis={s: [] for s in dict.fromkeys(cell.symbols)},
        mesh=mesh, precision=cell.precision,
    )
    new_shells = []
    ncells = int(np.prod(nrep))
    for rep in range(ncells):
        for ia in range(cell.natm):
            for sh in shells_per_atom.get(ia, []):
                new_shells.append(dataclasses.replace(sh, atom=rep * cell.natm + ia))
    charges = np.tile(cell.charges, ncells)
    return dataclasses.replace(
        sc, shells=tuple(new_shells), pseudos=dict(cell.pseudos),
        charges=charges, rcut=cell.rcut, ke_cutoff=cell.ke_cutoff,
        spin=cell.spin * ncells,
    )

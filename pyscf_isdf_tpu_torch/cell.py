"""Crystal cell: geometry + basis + pseudopotential container (host side).

``build_cell`` does all host-side, float64 setup work once per geometry:
basis parsing/normalization, FFT-mesh selection from the kinetic-energy
cutoff, lattice-sum radius estimation, and electron counting. The resulting
:class:`Cell` is an immutable plain-Python object whose arrays feed the
device-side compute path.

Mesh/rcut heuristics mirror the reference so default grids agree
(reference: pyscf/pbc/gto/cell.py:390-460, 1437-1447).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.basis import Shell, load_basis, load_pseudo, gth
from pyscf_isdf_tpu_torch.utils import charge_of

BOHR = 0.52917721092  # Angstrom per Bohr (CODATA-2010, as used by the reference)


def _estimate_ke_cutoff(alpha, l, c, precision):
    """Plane-wave cutoff so density-collocation errors stay below precision."""
    norm_ang = (2 * l + 1) / (4 * np.pi)
    fac = 32 * np.pi**2 * (2 * np.pi) ** 1.5 * c**2 * norm_ang \
        / (2 * alpha) ** (2 * l + 0.5) / precision
    Ecut = 20.0
    Ecut = np.log(fac * (Ecut * 2) ** (l - 0.5) + 1.0) * 4 * alpha
    Ecut = np.log(fac * (Ecut * 2) ** (l - 0.5) + 1.0) * 4 * alpha
    return Ecut


def _estimate_rcut(alpha, l, c, precision):
    """Lattice-sum radius from overlap/kinetic integral decay."""
    theta = alpha * 0.5
    a1 = (alpha * 2) ** -0.5
    norm_ang = (2 * l + 1) / (4 * np.pi)
    fac = 2 * np.pi * c**2 * norm_ang / theta / precision
    fac *= 4 * alpha**2
    r0 = 20.0
    r0 = (np.log(fac * r0 * (r0 * 0.5 + a1) ** (2 * l + 2) + 1.0) / theta) ** 0.5
    r0 = (np.log(fac * r0 * (r0 * 0.5 + a1) ** (2 * l + 2) + 1.0) / theta) ** 0.5
    return r0


@dataclass(frozen=True)
class Cell:
    """Immutable periodic-system description (host-side, float64)."""

    a: np.ndarray                 # (3,3) lattice vectors, rows, Bohr
    coords: np.ndarray            # (natm, 3) atom positions, Bohr
    symbols: tuple                # element symbols, len natm
    charges: np.ndarray           # (natm,) effective nuclear charges (Zion)
    shells: tuple                 # tuple[Shell]
    pseudos: dict                 # symbol -> PseudoPotential ({} = all-electron)
    mesh: tuple                   # FFT mesh (nx, ny, nz)
    precision: float
    rcut: float
    ke_cutoff: float
    spin: int = 0                 # 2S = nalpha - nbeta
    charge: int = 0
    dimension: int = 3

    @property
    def natm(self) -> int:
        return len(self.symbols)

    @property
    def vol(self) -> float:
        return lattice.cell_volume(self.a)

    @property
    def ngrids(self) -> int:
        return int(np.prod(self.mesh))

    @cached_property
    def nao(self) -> int:
        return sum(sh.nao for sh in self.shells)

    @cached_property
    def ao_loc(self) -> np.ndarray:
        """Offsets of each shell's first AO, length nshell+1."""
        return np.cumsum([0] + [sh.nao for sh in self.shells])

    @property
    def nelectron(self) -> int:
        return int(self.charges.sum()) - self.charge

    def reciprocal_vectors(self) -> np.ndarray:
        return lattice.reciprocal_vectors(self.a)

    def get_Gv(self, mesh=None) -> np.ndarray:
        return lattice.get_Gv(self.a, mesh or self.mesh)

    def get_SI(self, mesh=None, Gv=None) -> np.ndarray:
        if Gv is not None:
            return lattice.get_SI(self.a, self.coords, Gv=Gv)
        return lattice.get_SI(self.a, self.coords, mesh=mesh or self.mesh)

    def uniform_grid(self, mesh=None) -> np.ndarray:
        return lattice.uniform_grid(self.a, mesh or self.mesh)

    def lattice_images(self, rcut=None) -> np.ndarray:
        # the AO basis stays 3D-periodic in every dimension mode (low-dim
        # treatments truncate only the Coulomb kernel); reduced-dimension
        # image sets are an Ewald-sum concern (ops/coulomb.py)
        return lattice.lattice_images(self.a, rcut or self.rcut, 3)

    @property
    def grid_weight(self) -> float:
        return self.vol / self.ngrids

    def madelung_cell(self) -> "Cell":
        """Unit-point-charge cell used for the exchange probe-charge shift."""
        return Cell(
            a=self.a,
            coords=np.zeros((1, 3)),
            symbols=("H",),
            charges=np.array([1.0]),
            shells=(),
            pseudos={},
            mesh=self.mesh,
            precision=self.precision,
            rcut=self.rcut,
            ke_cutoff=self.ke_cutoff,
            dimension=self.dimension,
        )


def _parse_atoms(atom, unit: str):
    """Accept [['C', (x,y,z)], ...] or 'C x y z; C x y z' formats."""
    if isinstance(atom, str):
        entries = []
        for seg in atom.replace("\n", ";").split(";"):
            toks = seg.split()
            if not toks:
                continue
            entries.append([toks[0], tuple(float(t) for t in toks[1:4])])
        atom = entries
    symbols = tuple(a[0] for a in atom)
    coords = np.array([a[1] for a in atom], dtype=np.float64).reshape(-1, 3)
    if unit.lower().startswith(("a",)):  # Angstrom
        coords = coords / BOHR
    return symbols, coords


def _resolve_basis(basis, symbols):
    """Return dict symbol -> [(l, exps, coeffs-normalized)] from any accepted form."""
    out = {}
    uniq = dict.fromkeys(symbols)
    for s in uniq:
        if isinstance(basis, str):
            out[s] = load_basis(basis, s)
        elif isinstance(basis, dict):
            ent = basis[s]
            if isinstance(ent, str):
                out[s] = load_basis(ent, s)
            else:
                out[s] = _normalize_inline(ent)
        else:
            out[s] = _normalize_inline(basis)
    return out


def _normalize_inline(entry):
    """Normalize inline basis data [[l, (e, c), (e, c), ...], ...]."""
    shells = []
    for block in entry:
        l = block[0]
        rows = np.array(block[1:], dtype=np.float64)
        exps = rows[:, 0]
        coeffs = rows[:, 1:]
        shells.append((l, exps, gth.normalize_shell(l, exps, coeffs)))
    return shells


def build_cell(a, atom, basis, pseudo=None, mesh=None, ke_cutoff=None,
               precision=1e-8, unit="Bohr", spin=0, charge=0,
               dimension=3) -> Cell:
    """Construct a :class:`Cell`.

    Args:
        a: (3,3) lattice vectors (rows), in ``unit``.
        atom: ``[['C', (x, y, z)], ...]`` or ``'C 0 0 0; C 1 1 1'``.
        basis: basis-set name (e.g. ``'gth-szv'``), dict per element, or
            inline ``[[l, (exp, coef), ...], ...]``.
        pseudo: pseudopotential family name (e.g. ``'gth-pade'``) or None.
        mesh: explicit FFT mesh; otherwise derived from ``ke_cutoff`` or the
            basis-driven cutoff estimate at ``precision``.
    """
    a = np.asarray(a, dtype=np.float64).reshape(3, 3)
    if unit.lower().startswith("a"):
        a = a / BOHR
    symbols, coords = _parse_atoms(atom, unit)

    basis_tab = _resolve_basis(basis, symbols)
    shells = []
    for ia, s in enumerate(symbols):
        for (l, exps, coeffs) in basis_tab[s]:
            shells.append(Shell(atom=ia, l=l, exps=exps, coeffs=coeffs))

    pseudos = {}
    charges = np.array([charge_of(s) for s in symbols], dtype=np.float64)
    if pseudo is not None:
        for s in dict.fromkeys(symbols):
            if isinstance(pseudo, dict):
                if s in pseudo:
                    pseudos[s] = load_pseudo(pseudo[s], s)
            else:
                pseudos[s] = load_pseudo(pseudo, s)
        charges = np.array(
            [pseudos[s].zion if s in pseudos else charge_of(s) for s in symbols],
            dtype=np.float64,
        )

    # mesh selection: explicit mesh > ke_cutoff > basis-driven estimate
    if mesh is None:
        if ke_cutoff is None:
            imax = [np.argmax(sh.exps) for sh in shells]
            ke_cutoff = max(
                _estimate_ke_cutoff(sh.exps[i], sh.l, np.abs(sh.coeffs[i]).max(), precision)
                for sh, i in zip(shells, imax)
            )
        mesh = tuple(int(n) for n in lattice.cutoff_to_mesh(a, ke_cutoff))
    else:
        mesh = tuple(int(n) for n in mesh)
        if ke_cutoff is None:
            ke_cutoff = float(np.min(lattice.mesh_to_cutoff(a, mesh)))

    # lattice-sum radius: per-shell most-diffuse primitive
    rcuts = []
    for sh in shells:
        i = np.argmin(sh.exps)
        rcuts.append(_estimate_rcut(sh.exps[i], sh.l, np.abs(sh.coeffs[i]).max(), precision))
    rcut = float(max(rcuts)) if rcuts else 0.01

    return Cell(
        a=a, coords=coords, symbols=symbols, charges=charges,
        shells=tuple(shells), pseudos=pseudos, mesh=mesh,
        precision=precision, rcut=rcut, ke_cutoff=float(ke_cutoff),
        spin=spin, charge=charge, dimension=dimension,
    )

"""Cell geometry, basis and pseudopotential for the plain reference.

Frozen, trimmed copy (3-D periodic, Gamma point, GTH bases) of
``pyscf_isdf_tpu_torch/lattice.py``, ``cell.py`` and ``basis/gth.py`` at
commit 0f4080748bdaf2cf81cd310235eeac9d4311d481. The basis and
pseudopotential parameters come from ``data/carbon_gth.json``, a frozen
copy of the package's carbon entries, so nothing here reads the program.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from functools import cached_property

import numpy as np
from scipy.special import gammaln

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                     "carbon_gth.json")


# ----------------------------------------------------------------- lattice
def reciprocal_vectors(a):
    return 2 * np.pi * np.linalg.inv(np.asarray(a, dtype=np.float64).T)


def cartesian_prod(*arrays):
    grids = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def get_Gv(a, mesh):
    """(ngrids, 3) G-vectors in FFT ordering."""
    base = cartesian_prod(*(np.fft.fftfreq(n, 1.0 / n) for n in mesh))
    return base @ reciprocal_vectors(a)


def get_SI(coords, Gv):
    return np.exp(-1j * np.asarray(coords, dtype=np.float64) @ Gv.T)


def uniform_grid(a, mesh):
    """Wrap-around grid coordinates in FFT ordering."""
    return cartesian_prod(*(np.fft.fftfreq(n) for n in mesh)) @ np.asarray(a)


def _reduced_heights(a):
    b = reciprocal_vectors(a)
    rx = np.linalg.qr(b[[1, 2, 0]].T)[1][2, 2]
    ry = np.linalg.qr(b[[2, 0, 1]].T)[1][2, 2]
    rz = np.linalg.qr(b.T)[1][2, 2]
    return np.abs(np.array([rx, ry, rz]))


def cutoff_to_mesh(a, ke_cutoff):
    return np.ceil(np.sqrt(2.0 * ke_cutoff) / _reduced_heights(a)).astype(int) * 2 + 1


def lattice_images(a, rcut):
    """Translations whose cell can reach within ``rcut`` of the home cell."""
    a = np.asarray(a, dtype=np.float64)
    heights = 2 * np.pi / np.linalg.norm(reciprocal_vectors(a), axis=1)
    nmax = np.ceil(rcut / heights).astype(int) + 1
    Ts = cartesian_prod(*(np.arange(-n, n + 1) for n in nmax)) @ a
    keep = np.linalg.norm(Ts, axis=1) <= rcut + np.linalg.norm(a.sum(axis=0))
    return Ts[keep]


# ------------------------------------------------------------------- basis
def gaussian_int(n, alpha):
    n1 = (np.asarray(n, dtype=np.float64) + 1) * 0.5
    return np.exp(gammaln(n1)) / (2.0 * np.asarray(alpha, dtype=np.float64) ** n1)


def gto_norm(l, expnt):
    return 1.0 / np.sqrt(gaussian_int(l * 2 + 2, 2 * np.asarray(expnt, dtype=np.float64)))


def normalize_shell(l, exps, coeffs):
    cs = np.asarray(coeffs, dtype=np.float64) * gto_norm(l, exps)[:, None]
    ee = gaussian_int(l * 2 + 2, exps[:, None] + exps[None, :])
    return cs / np.sqrt(np.einsum("pi,pq,qi->i", cs, ee, cs))[None, :]


@dataclass(frozen=True)
class Shell:
    atom: int
    l: int
    exps: np.ndarray
    coeffs: np.ndarray       # (nprim, nctr), normalized

    @property
    def nctr(self):
        return self.coeffs.shape[1]

    @property
    def nao(self):
        return self.nctr * (2 * self.l + 1)


@dataclass(frozen=True)
class Pseudo:
    nelec: tuple
    rloc: float
    cexp: tuple
    proj_rl: tuple
    proj_h: tuple

    @property
    def zion(self):
        return int(sum(self.nelec))


def _load(kind, name, symbol):
    with open(_DATA) as f:
        return json.load(f)[kind][name][symbol]


def load_basis(name, symbol):
    shells = []
    for entry in _load("basis", name, symbol):
        rows = np.array(entry[1:], dtype=np.float64)
        exps, coeffs = rows[:, 0], rows[:, 1:]
        coeffs = coeffs[:, np.any(coeffs != 0.0, axis=0)]
        if coeffs.shape[1]:
            shells.append((entry[0], exps, normalize_shell(entry[0], exps, coeffs)))
    return shells


def load_pseudo(name, symbol):
    d = _load("pseudo", name, symbol)
    return Pseudo(nelec=tuple(d["nelec"]), rloc=float(d["rloc"]),
                  cexp=tuple(d["cexp"]),
                  proj_rl=tuple(p["rl"] for p in d["proj"]),
                  proj_h=tuple(tuple(tuple(r) for r in p["h"]) for p in d["proj"]))


def _estimate_rcut(alpha, l, c, precision):
    theta = alpha * 0.5
    a1 = (alpha * 2) ** -0.5
    fac = 2 * np.pi * c**2 * (2 * l + 1) / (4 * np.pi) / theta / precision
    fac *= 4 * alpha**2
    r0 = 20.0
    for _ in range(2):
        r0 = (np.log(fac * r0 * (r0 * 0.5 + a1) ** (2 * l + 2) + 1.0) / theta) ** 0.5
    return r0


@dataclass(frozen=True)
class Cell:
    a: np.ndarray            # (3, 3) rows, Bohr
    coords: np.ndarray       # (natm, 3) Bohr
    symbols: tuple
    charges: np.ndarray      # Zion
    shells: tuple
    pseudos: dict
    mesh: tuple
    precision: float
    rcut: float

    @property
    def natm(self):
        return len(self.symbols)

    @property
    def vol(self):
        return abs(np.linalg.det(self.a))

    @property
    def ngrids(self):
        return int(np.prod(self.mesh))

    @cached_property
    def nao(self):
        return sum(sh.nao for sh in self.shells)

    @cached_property
    def ao_loc(self):
        return np.cumsum([0] + [sh.nao for sh in self.shells])

    @property
    def nelectron(self):
        return int(self.charges.sum())

    def get_Gv(self):
        return get_Gv(self.a, self.mesh)

    def lattice_images(self):
        return lattice_images(self.a, self.rcut)


def build_cell(a, symbols, coords, basis, pseudo, mesh, precision=1e-8):
    """A :class:`Cell` from Bohr lattice rows and atom positions."""
    a = np.asarray(a, dtype=np.float64).reshape(3, 3)
    coords = np.asarray(coords, dtype=np.float64).reshape(-1, 3)
    table = {s: load_basis(basis, s) for s in dict.fromkeys(symbols)}
    pseudos = {s: load_pseudo(pseudo, s) for s in dict.fromkeys(symbols)}
    shells = tuple(Shell(atom=ia, l=l, exps=e, coeffs=c)
                   for ia, s in enumerate(symbols) for (l, e, c) in table[s])
    rcut = max(_estimate_rcut(sh.exps[np.argmin(sh.exps)], sh.l,
                              np.abs(sh.coeffs[np.argmin(sh.exps)]).max(), precision)
               for sh in shells)
    return Cell(a=a, coords=coords, symbols=tuple(symbols),
                charges=np.array([pseudos[s].zion for s in symbols], dtype=np.float64),
                shells=shells, pseudos=pseudos, mesh=tuple(int(n) for n in mesh),
                precision=precision, rcut=float(rcut))

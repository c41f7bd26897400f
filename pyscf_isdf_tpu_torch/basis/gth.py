"""GTH basis sets and pseudopotentials.

Loads the JSON parameter tables under ``basis/data`` (extracted from the
public CP2K GTH parameter files by ``tools/extract_gth_data.py``) and applies
the standard Gaussian normalization conventions so that AO values match the
reference implementation exactly:

  * primitive radial normalization ``N(l, a) = 1/sqrt(int g^2 r^2 dr)`` for
    ``g = r^l exp(-a r^2)`` (reference: pyscf/gto/mole.py:121-151),
  * contracted self-overlap normalization (pyscf/gto/mole.py:1014-1023).

A *shell* is one (atom, l) block with ``nprim`` primitives and ``nctr``
contracted functions; each contracted function spans ``2l+1`` real
spherical-harmonic components.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
from scipy.special import gammaln

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
_cache: dict[str, dict] = {}


def _load_json(name: str) -> dict:
    if name not in _cache:
        with open(os.path.join(_DATA_DIR, name)) as f:
            _cache[name] = json.load(f)
    return _cache[name]


def gaussian_int(n: float, alpha) -> np.ndarray:
    r"""\int_0^\infty r^n \exp(-\alpha r^2) dr = \Gamma((n+1)/2) / (2 \alpha^{(n+1)/2})."""
    n1 = (np.asarray(n, dtype=np.float64) + 1) * 0.5
    return np.exp(gammaln(n1)) / (2.0 * np.asarray(alpha, dtype=np.float64) ** n1)


def gto_norm(l: int, expnt) -> np.ndarray:
    """Radial normalization of a primitive ``r^l exp(-a r^2)``."""
    return 1.0 / np.sqrt(gaussian_int(l * 2 + 2, 2 * np.asarray(expnt, dtype=np.float64)))


@dataclass(frozen=True)
class Shell:
    """One (atom, l) contracted-Gaussian block with normalized coefficients."""

    atom: int            # atom index within the cell
    l: int               # angular momentum
    exps: np.ndarray     # (nprim,)
    coeffs: np.ndarray   # (nprim, nctr), includes all normalization factors

    @property
    def nctr(self) -> int:
        return self.coeffs.shape[1]

    @property
    def nao(self) -> int:
        return self.nctr * (2 * self.l + 1)


@dataclass(frozen=True)
class PseudoPotential:
    """GTH pseudopotential parameters for one element.

    Data layout follows Goedecker-Teter-Hutter PRB 54, 1703 (1996) /
    Hartwigsen-Goedecker-Hutter PRB 58, 3641 (1998):
    local part (rloc, cexp[0:4]), nonlocal projectors per l: (rl, h[i,j]).
    """

    nelec: tuple          # valence electrons per l channel
    rloc: float
    cexp: tuple           # C1..C4 coefficients of the local part
    proj_rl: tuple        # per-l projector radii (l = 0, 1, 2, ...)
    proj_h: tuple = field(default=())   # per-l h matrices as nested tuples

    @property
    def zion(self) -> int:
        return int(sum(self.nelec))

    @property
    def nproj_types(self) -> int:
        return len(self.proj_rl)


def normalize_shell(l: int, exps: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Apply primitive + contracted normalization to raw CP2K coefficients."""
    es = np.asarray(exps, dtype=np.float64)
    cs = np.asarray(coeffs, dtype=np.float64)
    cs = cs * gto_norm(l, es)[:, None]
    ee = gaussian_int(l * 2 + 2, es[:, None] + es[None, :])
    s1 = 1.0 / np.sqrt(np.einsum("pi,pq,qi->i", cs, ee, cs))
    return cs * s1[None, :]


def load_basis(basis_name: str, symbol: str) -> list[tuple[int, np.ndarray, np.ndarray]]:
    """Return [(l, exps, normalized_coeffs), ...] for one element.

    Zero-coefficient contraction columns are dropped (the reference's
    ``remove_zero`` behavior, pyscf/gto/basis/parse_nwchem.py).
    """
    key = basis_name.lower()
    if key.startswith("sto-"):
        entries = _load_json("sto_basis.json").get(key, {}).get(symbol)
    elif key.startswith("gth"):
        entries = _load_json("gth_basis.json").get(key, {}).get(symbol)
    else:
        # general all-electron families (cc-pVnZ, def2, Pople, ...):
        # NWChem-format data files through the general parser
        from pyscf_isdf_tpu_torch.basis import nwchem

        table = nwchem.load(key)
        if table is None:
            raise KeyError(
                f"unknown basis {basis_name!r}; have GTH families, "
                f"STO-nG, and {nwchem.available()}")
        entries = table.get(symbol)
    if entries is None:
        raise KeyError(f"no {basis_name} entry for element {symbol}")
    shells = []
    for entry in entries:
        l = entry[0]
        rows = np.array(entry[1:], dtype=np.float64)
        exps = rows[:, 0]
        coeffs = rows[:, 1:]
        nonzero = np.any(coeffs != 0.0, axis=0)
        coeffs = coeffs[:, nonzero]
        if coeffs.shape[1] == 0:
            continue
        shells.append((l, exps, normalize_shell(l, exps, coeffs)))
    return shells


def load_pseudo(pseudo_name: str, symbol: str) -> PseudoPotential:
    import re

    table = _load_json("gth_pp.json")
    key = pseudo_name.lower()
    entry_key = symbol
    m = re.search(r"-(q\d+)$", key)
    if m:
        key = key[: m.start()]            # family, e.g. 'gth-pade'
        entry_key = f"{symbol}-{m.group(1)}"  # e.g. 'Be-q2'
    if key not in table:
        raise KeyError(f"unknown pseudopotential {pseudo_name!r}; have {sorted(table)}")
    if entry_key not in table[key]:
        raise KeyError(f"no {pseudo_name} entry for element {symbol}")
    d = table[key][entry_key]
    return PseudoPotential(
        nelec=tuple(d["nelec"]),
        rloc=float(d["rloc"]),
        cexp=tuple(d["cexp"]),
        proj_rl=tuple(p["rl"] for p in d["proj"]),
        proj_h=tuple(tuple(tuple(row) for row in p["h"]) for p in d["proj"]),
    )

"""General NWChem-format basis-set parser and the shipped basis library.

The reference exposes its full basis library through an NWChem text
parser (pyscf/gto/basis/parse_nwchem.py dispatched from
pyscf/gto/basis/__init__.py); this module is this package's analog:
a from-scratch parser for the published EMSL/NWChem text format plus a
data directory (``basis/data/nwchem/*.dat``) holding the extracted
families (published basis-set DATA, same extraction posture as the GTH
and STO tables — see tools/extract_nwchem_basis.py).

Format handled (everything the shipped families use):

  * comment lines (``#``), ``BASIS``/``END`` framing lines;
  * element blocks ``<Symbol> <SHELL>`` with SHELL in S/P/D/F/G/H/I or a
    fused Pople shell (SP, SPD): one coefficient column per l;
  * general contractions: a single-l block with several coefficient
    columns is several contracted functions sharing the exponent set
    (zero columns are dropped per contracted function downstream);
  * Fortran ``D`` exponents;
  * an ``ECP`` section terminates AO-basis parsing (ECPs are not part of
    this framework's all-electron stack — the GTH pseudopotential path
    covers effective-core needs).

Raw (exponent, coefficient) rows are returned unnormalized; the caller
(basis/gth.py load_basis) applies the same primitive + contracted
normalization pipeline used for every other basis family.
"""
from __future__ import annotations

import os

_L_LETTERS = "SPDFGHI"
_DATA_DIR = os.path.join(os.path.dirname(__file__), "data", "nwchem")


def _shell_ls(tag: str) -> list[int] | None:
    """Map a shell tag to its l list: 'D' -> [2], 'SP' -> [0, 1]."""
    tag = tag.upper()
    if len(tag) == 1:
        if tag in _L_LETTERS:
            return [_L_LETTERS.index(tag)]
        return None
    # fused shells must be a prefix of SPDF... starting at S
    if all(t == _L_LETTERS[i] for i, t in enumerate(tag)):
        return list(range(len(tag)))
    return None


def parse(text: str, elements=None) -> dict:
    """Parse NWChem basis text into ``{symbol: [[l, [e, c...], ...], ...]}``.

    Each entry is one contracted shell: leading angular momentum followed
    by rows of ``[exponent, coeff_1, ..., coeff_nctr]`` (the inline-basis
    layout the rest of the framework consumes). Fused SP/SPD blocks are
    split into one entry per l; multi-column same-l blocks are kept as a
    general contraction (one entry, several coefficient columns).
    """
    table: dict[str, list] = {}
    header = None           # (symbol, [l, ...])
    rows: list[list[float]] = []

    def flush():
        nonlocal rows
        if header is None or not rows:
            rows = []
            return
        symb, ls = header
        if elements is not None and symb not in elements:
            rows = []
            return
        ncol = len(rows[0]) - 1
        if any(len(r) - 1 != ncol for r in rows):
            raise ValueError(
                f"ragged coefficient table for {symb} {ls}")
        ent = table.setdefault(symb, [])
        if len(ls) == 1:
            # general contraction: all columns belong to the one l
            ent.append([ls[0]] + [list(r) for r in rows])
        else:
            if ncol != len(ls):
                raise ValueError(
                    f"fused shell {symb}: {ncol} columns for {len(ls)} l")
            for col, l in enumerate(ls):
                ent.append([l] + [[r[0], r[1 + col]] for r in rows])
        rows = []

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        up = line.upper()
        if up.startswith("BASIS") or up.startswith("END"):
            continue
        if up == "ECP" or up.startswith("ECP "):
            break                       # AO section is over
        toks = line.split()
        if toks[0][0].isalpha():
            flush()
            if len(toks) != 2:
                raise ValueError(f"unrecognized basis line: {raw!r}")
            ls = _shell_ls(toks[1])
            if ls is None:
                raise ValueError(f"unknown shell tag {toks[1]!r}")
            header = (toks[0], ls)
        else:
            rows.append([float(t.replace("D", "E").replace("d", "e"))
                         for t in toks])
    flush()
    return table


_cache: dict[str, dict] = {}


def available() -> list[str]:
    if not os.path.isdir(_DATA_DIR):
        return []
    return sorted(f[:-4] for f in os.listdir(_DATA_DIR)
                  if f.endswith(".dat"))


def load(name: str) -> dict | None:
    """Load a shipped family by canonical name (lowercase, '*' -> 's'),
    or None if the family is not in the data directory."""
    key = name.lower().replace("*", "s").replace("+", "p")
    if key in _cache:
        return _cache[key]
    path = os.path.join(_DATA_DIR, key + ".dat")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        _cache[key] = parse(f.read())
    return _cache[key]

"""Checkpoint and restart: serialize cells and SCF results.

The reference persists SCF state per cycle into HDF5 chkfiles
(pyscf/lib/chkfile.py:28-190; pyscf/pbc/scf/hf.py:782-795 restores an
initial guess from them). Here cells serialize to JSON (geometry, basis and
pseudopotential, self-contained) and SCF results to ``.npz`` bundles; both
round-trip bit-exactly, in the JAX package's format, so a file either
package writes loads in the other. Tensors are written from the host
(``load_scf`` returns numpy arrays).
"""
from __future__ import annotations

import json

import numpy as np

from pyscf_isdf_tpu_torch.basis import PseudoPotential, Shell
from pyscf_isdf_tpu_torch.cell import Cell
from pyscf_isdf_tpu_torch.device import to_host


def dumps_cell(cell: Cell) -> str:
    d = {
        "a": cell.a.tolist(),
        "coords": cell.coords.tolist(),
        "symbols": list(cell.symbols),
        "charges": cell.charges.tolist(),
        "mesh": list(cell.mesh),
        "precision": cell.precision,
        "rcut": cell.rcut,
        "ke_cutoff": cell.ke_cutoff,
        "spin": cell.spin,
        "charge": cell.charge,
        "dimension": cell.dimension,
        "shells": [
            {"atom": sh.atom, "l": sh.l, "exps": sh.exps.tolist(),
             "coeffs": sh.coeffs.tolist()}
            for sh in cell.shells
        ],
        "pseudos": {
            s: {"nelec": list(p.nelec), "rloc": p.rloc, "cexp": list(p.cexp),
                "proj_rl": list(p.proj_rl),
                "proj_h": [[list(r) for r in h] for h in p.proj_h]}
            for s, p in cell.pseudos.items()
        },
    }
    return json.dumps(d)


def loads_cell(s: str) -> Cell:
    d = json.loads(s)
    shells = tuple(
        Shell(atom=sh["atom"], l=sh["l"],
              exps=np.array(sh["exps"]), coeffs=np.array(sh["coeffs"]))
        for sh in d["shells"]
    )
    pseudos = {
        s: PseudoPotential(
            nelec=tuple(p["nelec"]), rloc=p["rloc"], cexp=tuple(p["cexp"]),
            proj_rl=tuple(p["proj_rl"]),
            proj_h=tuple(tuple(tuple(r) for r in h) for h in p["proj_h"]))
        for s, p in d["pseudos"].items()
    }
    return Cell(
        a=np.array(d["a"]), coords=np.array(d["coords"]),
        symbols=tuple(d["symbols"]), charges=np.array(d["charges"]),
        shells=shells, pseudos=pseudos, mesh=tuple(d["mesh"]),
        precision=d["precision"], rcut=d["rcut"], ke_cutoff=d["ke_cutoff"],
        spin=d["spin"], charge=d["charge"], dimension=d["dimension"],
    )


def _host(v):
    """A result entry as a numpy array (a tensor, or a list or tuple of them
    stacked, as a per-k or per-spin entry)."""
    if isinstance(v, (list, tuple)):
        return np.asarray([to_host(x) for x in v])
    return to_host(v)


def save_scf(path: str, cell: Cell, scf_res: dict) -> None:
    """Persist a converged SCF result and its cell to an .npz checkpoint."""
    payload = {"cell_json": np.array(dumps_cell(cell))}
    for key in ("e_tot", "mo_energy", "mo_coeff", "dm", "converged", "niter"):
        if key in scf_res and scf_res[key] is not None:
            payload[key] = _host(scf_res[key])
    np.savez(path, **payload)


def load_scf(path: str):
    """Load (cell, result dict of numpy arrays) from an .npz checkpoint."""
    with np.load(path, allow_pickle=False) as f:
        cell = loads_cell(str(f["cell_json"]))
        res = {k: f[k] for k in f.files if k != "cell_json"}
    if "e_tot" in res:
        res["e_tot"] = float(res["e_tot"])
    return cell, res


def init_guess_by_chkfile(path: str):
    """Density-matrix restart: the reference's from_chk path
    (pyscf/pbc/scf/hf.py:782). Returns a numpy array."""
    _, res = load_scf(path)
    return np.asarray(res["dm"])

"""DFT+U (rotationally invariant Dudarev scheme) for k-point KS-DFT (torch).

Reference counterpart: pyscf/pbc/dft/krkspu.py — a Hubbard correction on
selected local subspaces,

    E_U = sum_I (U_I/2) [Tr n_I - Tr n_I n_I],
    V_U(k) = sum_I U_I  P_I(k) (1/2 - n_I) P_I(k)^H   (in the S-metric),

with n_I the k-averaged local occupation matrix of subspace I. Projectors
are the cell's own AOs of the chosen (atom, l) shells, Loewdin-
orthonormalized in the overlap metric at each k. They are built once per
geometry as (nk, nao, m) tensors on the overlap's device; E_U and V_U are
batched over k.

The correction is variational: dE/dU at fixed density equals
(Tr n - Tr n^2)/2.
"""
from __future__ import annotations

import numpy as np
import torch


def _subspace_ao_indices(cell, atom: int, l: int):
    """AO column indices of the first (atom, l) shell's m components (one
    m-multiplet; further contractions of the same channel would double
    count)."""
    ao_loc = cell.ao_loc
    for ish, sh in enumerate(cell.shells):
        if sh.atom == atom and sh.l == l:
            return list(range(ao_loc[ish], ao_loc[ish] + (2 * l + 1)))
    return []


def parse_hubbard(cell, specs):
    """Normalize U specs: [(atom_sel, l, U_ha)] with atom_sel an index or
    an element symbol (applies to every matching atom). Returns
    [(ao indices (m,) int64 numpy, U)]."""
    out = []
    for sel, l, U in specs:
        if isinstance(sel, str):
            atoms = [ia for ia, s in enumerate(cell.symbols) if s == sel]
        else:
            atoms = [int(sel)]
        for ia in atoms:
            idx = _subspace_ao_indices(cell, ia, l)
            if not idx:
                raise ValueError(f"no l={l} shell on atom {ia}")
            out.append((np.asarray(idx, dtype=np.int64), float(U)))
    return out


class HubbardU:
    """Per-geometry projectors and the per-cycle E_U / V_U evaluation.

    ``S_k``: (nk, nao, nao) or (nao, nao) overlap tensor; the projectors
    live on its device.
    """

    def __init__(self, cell, S_k, specs):
        self.subspaces = parse_hubbard(cell, specs)
        S_k = torch.as_tensor(S_k)
        if S_k.dim() == 2:
            S_k = S_k[None]
        self.nk = S_k.shape[0]
        # S C_orth per subspace, (nk, nao, m), with C_orth^H S C_orth = 1
        self.proj = []
        for idx, _ in self.subspaces:
            sel = torch.as_tensor(idx, device=S_k.device)
            M = S_k[:, sel][:, :, sel]                           # C^H S C
            w, v = torch.linalg.eigh(M)
            Mm12 = (v / torch.sqrt(torch.clamp(w, min=1e-14))[:, None, :]) \
                @ v.conj().transpose(1, 2)
            self.proj.append(S_k[:, :, sel] @ Mm12)

    def energy_and_potential(self, dm_k):
        """E_U (a float) and V_U(k) (nk, nao, nao) for the density
        matrices (nk, nao, nao).

        n_I = (1/nk) sum_k P^H D P with P = S C_orth; spin-traced closed
        shell convention: n_s = n/2 per spin channel,
        E_U = sum_s (U/2)[Tr n_s - Tr n_s^2].
        """
        dm_k = torch.as_tensor(dm_k)
        if dm_k.dim() == 2:
            dm_k = dm_k[None]
        e_u = 0.0
        v_u = torch.zeros_like(dm_k)
        for (idx, U), P in zip(self.subspaces, self.proj):
            P = P.to(dm_k.dtype)
            ns = 0.5 * (P.conj().transpose(1, 2) @ dm_k @ P).sum(0) / self.nk
            e_u += U * float((torch.trace(ns) - torch.trace(ns @ ns)).real)
            eye = torch.eye(len(idx), dtype=ns.dtype, device=ns.device)
            v_u += P @ (U * (0.5 * eye - ns)) @ P.conj().transpose(1, 2)
        return e_u, v_u

"""Space-group symmetry and IBZ k-point reduction (host set-up, torch
expansion).

Counterpart of the reference's ``KPoints`` machinery
(pyscf/pbc/lib/kpts.py:32 make_kpts_ibz, :369 density symmetrization,
:441-631 MO/DM transforms, consumed by pbc/scf/khf_ksymm.py). The
operations, the k-point reduction and the AO rotation matrices are
one-time float64 numpy set-up; the expansion of IBZ density matrices and
orbitals to the full zone takes and returns tensors on their device, one
batched product per call, so the per-cycle expansion of the IBZ SCF stays
on the device.

Conventions (matching ops/ao_eval.py):
  - Bloch AOs  phi^k_mu(r) = sum_T e^{i k.T} chi_mu(r - tau_a - T); hence
    phi^{k+G} == phi^k identically (no e^{ikr} split), so k-points are
    matched modulo reciprocal-lattice vectors with no extra phases.
  - A space-group op g = {R|t} maps  phi^k_mu -> e^{-i(Rk).T0} sum_{m'}
    D^l_{m'm}(R) phi^{Rk}_{mu'}  with mu' the same shell on atom
    a' = perm[a] and T0 = R tau_a + t - tau_{a'} (a lattice vector).
    Therefore  C^{Rk} = P C^k  and  dm^{Rk} = P dm^k P^H.
  - Time reversal: dm^{-k} = conj(dm^k) (real AOs, no SOC).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.ops.solid_harmonics import solid_harmonics


@dataclass(frozen=True)
class SpaceGroupOp:
    """One space-group operation {R|t} with its atom permutation."""

    R: np.ndarray        # (3,3) Cartesian rotation (orthogonal)
    t: np.ndarray        # (3,) Cartesian fractional translation
    perm: np.ndarray     # (natm,) atom a maps onto atom perm[a]
    W: np.ndarray        # (3,3) integer rotation in lattice-vector basis


def lattice_rotations(a: np.ndarray) -> list[np.ndarray]:
    """All Cartesian point-group rotations of the Bravais lattice.

    Enumerates integer matrices W (entries in {-1,0,1}; sufficient for
    reduced cells, the standard spglib assumption) with W g W^T = g where
    g = a a^T is the row-vector metric; R = a^T W^T (a^T)^{-1}.
    """
    a = np.asarray(a, dtype=np.float64).reshape(3, 3)
    g = a @ a.T
    vals = np.array([-1, 0, 1])
    grids = np.meshgrid(*([vals] * 9), indexing="ij")
    W_all = np.stack([w.ravel() for w in grids], axis=1).reshape(-1, 3, 3)
    det = np.linalg.det(W_all)
    W_all = W_all[np.abs(np.abs(det) - 1.0) < 1e-9]
    M = np.einsum("nij,jk,nlk->nil", W_all.astype(np.float64), g, W_all)
    keep = np.all(np.abs(M - g) < 1e-9 * max(1.0, np.abs(g).max()), axis=(1, 2))
    Ws = W_all[keep]
    ainvT = np.linalg.inv(a.T)
    return [(a.T @ W.T @ ainvT, W) for W in Ws]


def space_group_ops(cell, tol: float = 1e-6) -> list[SpaceGroupOp]:
    """Space-group operations {R|t} of the crystal (incl. identity).

    For each lattice rotation, candidate translations are generated from
    the images of atom 0 (covers non-symmorphic groups and supercell
    translations); an op is kept if it permutes the full atom list with
    matching species.
    """
    a = np.asarray(cell.a, dtype=np.float64)
    ainv = np.linalg.inv(a)
    coords = np.asarray(cell.coords, dtype=np.float64)
    symbols = list(cell.symbols)
    natm = len(symbols)
    frac = coords @ ainv

    ops = []
    seen = set()
    for R, W in lattice_rotations(a):
        rot_frac = (coords @ R.T) @ ainv            # fractional coords of R.tau
        for b in range(natm):
            if symbols[b] != symbols[0]:
                continue
            t_frac = frac[b] - rot_frac[0]
            # match every atom: R tau_a + t == tau_{perm[a]} (mod lattice)
            img = rot_frac + t_frac
            d = img[:, None, :] - frac[None, :, :]
            d -= np.round(d)
            ok = np.linalg.norm(d @ a, axis=2) < tol
            perm = np.full(natm, -1, dtype=np.int64)
            good = True
            for ia in range(natm):
                hits = np.nonzero(ok[ia])[0]
                hits = [h for h in hits if symbols[h] == symbols[ia]]
                if len(hits) != 1:
                    good = False
                    break
                perm[ia] = hits[0]
            if not good or len(set(perm.tolist())) != natm:
                continue
            key = (W.tobytes(), tuple(np.round(t_frac - np.floor(t_frac), 8)))
            if key in seen:
                continue
            seen.add(key)
            ops.append(SpaceGroupOp(R=R, t=(t_frac - np.floor(t_frac)) @ a,
                                    perm=perm, W=W))
    return ops


def wigner_d_real(l: int, R: np.ndarray) -> np.ndarray:
    """Real-solid-harmonic rotation matrix D with
    S_lm(R^{-1} u) = sum_{m'} D[m', m] S_lm'(u).

    Computed numerically by sampling (robust for any l the basis uses,
    independent of m-ordering conventions).
    """
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(12345 + l)
    u = rng.normal(size=(4 * l + 6, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    B = solid_harmonics(l, u, np)                    # (ns, 2l+1): S_lm'(u_i)
    A = solid_harmonics(l, u @ R, np)                # S_lm(R^{-1}u) = S(u R)
    # A[i, m] = sum_m' B[i, m'] D[m', m]
    D, *_ = np.linalg.lstsq(B, A, rcond=None)
    return D


def ao_rotation_matrix(cell, op: SpaceGroupOp, kpt: np.ndarray) -> np.ndarray:
    """P with dm^{Rk} = P dm^k P^H (k the *source* k-point, Cartesian)."""
    nao = cell.nao
    ao_loc = cell.ao_loc
    # shell index on the target atom for each source shell: shells are laid
    # out per atom in identical per-symbol order, so match by position
    atom_shells: dict[int, list[int]] = {}
    for ish, sh in enumerate(cell.shells):
        atom_shells.setdefault(sh.atom, []).append(ish)

    Rk = op.R @ np.asarray(kpt, dtype=np.float64)
    Dcache = {}
    P = np.zeros((nao, nao), dtype=np.complex128)
    for ish, sh in enumerate(cell.shells):
        a = sh.atom
        a2 = int(op.perm[a])
        pos = atom_shells[a].index(ish)
        ish2 = atom_shells[a2][pos]
        if sh.l not in Dcache:
            Dcache[sh.l] = wigner_d_real(sh.l, op.R)
        D = Dcache[sh.l]
        T0 = op.R @ cell.coords[a] + op.t - cell.coords[a2]
        phase = np.exp(-1j * Rk @ T0)
        m = 2 * sh.l + 1
        r0, r2 = ao_loc[ish], ao_loc[ish2]
        for k in range(sh.nctr):
            P[r2 + k * m:r2 + (k + 1) * m, r0 + k * m:r0 + (k + 1) * m] = \
                phase * D
    return P


@dataclass(frozen=True)
class IBZInfo:
    """IBZ reduction of a full-BZ k-point set."""

    kpts: np.ndarray          # (nk, 3) the full set
    ibz_idx: np.ndarray       # (nk_ibz,) indices into kpts
    weights: np.ndarray       # (nk_ibz,) integer orbit sizes (sum = nk)
    bz2ibz: np.ndarray        # (nk,) full index -> position in ibz_idx
    op_idx: np.ndarray        # (nk,) which op maps k_ibz -> (+/-) k_full
    tr: np.ndarray            # (nk,) bool: time reversal applied
    ops: tuple                # tuple[SpaceGroupOp]

    @property
    def nk(self) -> int:
        return len(self.kpts)

    @property
    def nk_ibz(self) -> int:
        return len(self.ibz_idx)


def make_kpts_ibz(cell, kpts, time_reversal: bool = True,
                  tol: float = 1e-8) -> IBZInfo:
    """Reduce a k-point set to its irreducible wedge.

    For every full-BZ point k_j the result records an (op, tr) pair with
    k_j = (-1)^tr R_op k_i (mod G) for its representative k_i, so that
    dm^{k_j} = [conj if tr](P_op dm^{k_i} P_op^H).
    """
    kpts = np.reshape(np.asarray(kpts, dtype=np.float64), (-1, 3))
    nk = len(kpts)
    ops = space_group_ops(cell)
    b = lattice.reciprocal_vectors(cell.a)
    binv = np.linalg.inv(b)
    kf = kpts @ binv                     # fractional (units of b rows)

    def find(kcart):
        f = kcart @ binv
        d = f[None, :] - kf
        d -= np.round(d)
        hits = np.nonzero(np.linalg.norm(d, axis=1) < tol)[0]
        return int(hits[0]) if len(hits) else -1

    bz2ibz = np.full(nk, -1, dtype=np.int64)
    op_idx = np.zeros(nk, dtype=np.int64)
    tr = np.zeros(nk, dtype=bool)
    ibz_list: list[int] = []
    for i in range(nk):
        if bz2ibz[i] >= 0:
            continue
        rep = len(ibz_list)
        ibz_list.append(i)
        # the representative maps to itself with the identity
        for iop, op in enumerate(ops):
            for use_tr in ((False, True) if time_reversal else (False,)):
                img = op.R @ kpts[i]
                if use_tr:
                    img = -img
                j = find(img)
                if j >= 0 and bz2ibz[j] < 0:
                    bz2ibz[j] = rep
                    op_idx[j] = iop
                    tr[j] = use_tr
    ibz_idx = np.array(ibz_list, dtype=np.int64)
    weights = np.array([(bz2ibz == r).sum() for r in range(len(ibz_list))],
                       dtype=np.float64)
    return IBZInfo(kpts=kpts, ibz_idx=ibz_idx, weights=weights,
                   bz2ibz=bz2ibz, op_idx=op_idx, tr=tr, ops=tuple(ops))


def _rotation_table(cell, info: IBZInfo, device) -> torch.Tensor:
    """P_j for every full-zone k_j: the AO rotation of op_idx[j] at its
    representative k-point, (nk, nao, nao) complex128 on ``device``, one
    matrix per (op, source-k) pair computed."""
    cache: dict[tuple[int, int], np.ndarray] = {}
    out = np.empty((info.nk, cell.nao, cell.nao), dtype=np.complex128)
    for j in range(info.nk):
        i = int(info.ibz_idx[int(info.bz2ibz[j])])
        key = (int(info.op_idx[j]), i)
        if key not in cache:
            cache[key] = ao_rotation_matrix(cell, info.ops[key[0]], info.kpts[i])
        out[j] = cache[key]
    return torch.as_tensor(out, device=device)


def _expand(info, x_ibz, P, rotate):
    """rotate(P_j, x at the representative of k_j), conjugated where time
    reversal maps it, for every full-zone k_j."""
    x = x_ibz[torch.as_tensor(info.bz2ibz, device=x_ibz.device)]
    out = rotate(P.to(x_ibz.device), x.to(torch.complex128))
    tr = torch.as_tensor(info.tr, device=x_ibz.device)
    return torch.where(tr[:, None, None], out.conj(), out)


def expand_dm(cell, info: IBZInfo, dm_ibz, P=None) -> torch.Tensor:
    """Expand IBZ density matrices to the full BZ.

    dm_ibz: (nk_ibz, nao, nao) tensor at info.kpts[info.ibz_idx].
    P: optional :func:`_rotation_table` on the device of ``dm_ibz`` (the
    IBZ SCF builds it once).
    Returns (nk, nao, nao) complex at all info.kpts, on dm_ibz's device.
    """
    dm_ibz = torch.as_tensor(dm_ibz)
    if P is None:
        P = _rotation_table(cell, info, dm_ibz.device)
    return _expand(info, dm_ibz, P, lambda p, d: p @ d @ p.conj().transpose(1, 2))


def expand_mos(cell, info: IBZInfo, mo_c_ibz, mo_e_ibz):
    """Expand IBZ MO coefficients/energies to the full BZ.

    C^{k_j} = [conj if tr](P_op C^{k_i}) with k_j = (-1)^tr R_op k_i —
    the rotated orbitals diagonalize the rotated Fock exactly when the
    mesh respects the symmetry (reference analog: the MO transforms of
    pyscf/pbc/lib/kpts.py:441-631 consumed by kmp2_ksymm). MO energies
    are orbit-invariant. Takes per-IBZ-k tensors (nao, nmo) and (nmo,)
    of one width; returns (mo_e_full list, mo_c_full list) of tensors on
    their device.
    """
    c_ibz = torch.stack([torch.as_tensor(c) for c in mo_c_ibz])
    cs = _expand(info, c_ibz, _rotation_table(cell, info, c_ibz.device),
                 lambda p, c: p @ c)
    es = [torch.as_tensor(mo_e_ibz[int(r)]) for r in info.bz2ibz]
    return es, list(cs)


def check_mesh_symmetry(cell, ops, mesh=None, tol: float = 1e-8):
    """Grid-index permutations g: idx[g] such that f(g^{-1} r_i) = f[idx_g[i]]
    for fields sampled on the uniform mesh. Returns {op_index: perm} for the
    ops whose {R|t} maps the mesh onto itself (used to symmetrize densities
    without evaluating AOs outside the IBZ)."""
    mesh = tuple(mesh or cell.mesh)
    coords = lattice.uniform_grid(cell.a, mesh)     # (ng, 3), row-major
    ainv = np.linalg.inv(cell.a)
    N = np.array(mesh)
    out = {}
    for iop, op in enumerate(ops):
        # g^{-1} r = R^T (r - t);  fractional: f' = ((r - t) @ R) @ ainv
        f2 = ((coords - op.t) @ op.R) @ ainv
        idx_f = f2 * N
        idx_i = np.round(idx_f).astype(np.int64)
        if np.abs(idx_f - idx_i).max() > 1e-6:
            continue
        idx_i %= N
        flat = (idx_i[:, 0] * mesh[1] + idx_i[:, 1]) * mesh[2] + idx_i[:, 2]
        out[iop] = flat
    return out

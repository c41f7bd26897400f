"""Small exact-diagonalization (FCI) oracle over spin orbitals (torch).

Dense full CI in the Slater-determinant basis through the Slater-Condon
rules: the exact correlation oracle the coupled-cluster tests measure
against (for two electrons CCSD equals FCI identically). The determinant
enumeration and the excitation bookkeeping (which pairs of determinants
couple, through which orbitals, with which sign) stay on the host; the
matrix elements are gathered from the integrals and scattered into the
dense H on the device of the integrals. Intended for up to about 16 spin
orbitals and a few thousand determinants.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch


def _phase(det, p):
    """Sign picked up moving an operator past the orbitals of ``det``
    below p (det: sorted tuple of occupied spin orbitals)."""
    return -1.0 if sum(1 for q in det if q < p) % 2 else 1.0


def _excitation(deti, detj):
    """Orbitals unique to deti / detj (each sorted)."""
    si, sj = set(deti), set(detj)
    return sorted(si - sj), sorted(sj - si)


def _sign_single(det, p, r):
    """Sign of a_p^+ a_r between determinants differing by r -> p."""
    # count occupied orbitals strictly between r and p in the common set
    lo, hi = (r, p) if r < p else (p, r)
    n = sum(1 for q in det if lo < q < hi and q != r)
    return -1.0 if n % 2 else 1.0


def _couplings(dets, nso):
    """Host bookkeeping of H's off-diagonal: (singles, doubles), each a
    dict of int64/float64 numpy arrays. Singles: I, J, p, r, sign; doubles:
    I, J, p, q, r, s, sign (J > I: each pair once, H[J, I] = conj)."""
    index = {d: i for i, d in enumerate(dets)}
    s1, s2 = [], []
    for I, di in enumerate(dets):
        occ = set(di)
        virt = [a for a in range(nso) if a not in occ]
        for r in di:
            for p in virt:
                J = index.get(tuple(sorted(occ - {r} | {p})))
                if J is None or J < I:
                    continue
                s1.append((I, J, p, r, _sign_single(di, p, r)))
        for r, s in combinations(di, 2):
            for p, q in combinations(virt, 2):
                J = index.get(tuple(sorted(occ - {r, s} | {p, q})))
                if J is None or J < I:
                    continue
                # <D_J|a_p^+ a_q^+ a_s a_r|D_I>: a_r acts first, so the
                # phases accumulate as remove r, remove s, add q, add p
                d1 = tuple(sorted(occ - {r}))
                d2 = tuple(sorted(occ - {r, s}))
                d3 = tuple(sorted(set(d2) | {q}))
                sgn = (_phase(di, r) * _phase(d1, s)
                       * _phase(d2, q) * _phase(d3, p))
                s2.append((I, J, p, q, r, s, sgn))

    def cols(rows, names):
        a = np.asarray(rows, dtype=np.float64).reshape(-1, len(names))
        return {n: (a[:, i] if n == "sign" else a[:, i].astype(np.int64))
                for i, n in enumerate(names)}

    return (cols(s1, ("I", "J", "p", "r", "sign")),
            cols(s2, ("I", "J", "p", "q", "r", "s", "sign")))


def _occupation_matrix(dets, nso, device=None):
    """(ndet, nso) 0/1 float64 occupations of the determinants."""
    O = np.zeros((len(dets), nso))
    for I, d in enumerate(dets):
        O[I, list(d)] = 1.0
    return torch.as_tensor(O, device=device)


def build_hamiltonian(h1, eri_asym, dets):
    """Dense H in a determinant list of one electron count, on the device
    of ``eri_asym``."""
    eri = torch.as_tensor(eri_asym)
    dev = eri.device
    h1 = torch.as_tensor(h1, device=dev)
    nso = h1.shape[0]
    dt = torch.promote_types(h1.dtype, eri.dtype)
    h1, eri = h1.to(dt), eri.to(dt)
    O = _occupation_matrix(dets, nso, dev).to(dt)
    ar = torch.arange(nso, device=dev)
    # <pq||pq> and <pq||rq> over every q of the determinant
    e_pqpq = eri[ar[:, None], ar[None, :], ar[:, None], ar[None, :]]
    diag = O @ torch.diagonal(h1) + 0.5 * ((O @ e_pqpq) * O).sum(1)
    H = torch.diag(diag)

    sgl, dbl = _couplings(dets, nso)

    def t(a):
        return torch.as_tensor(a, device=dev)

    if len(sgl["I"]):
        I, J, p, r = (t(sgl[k]) for k in ("I", "J", "p", "r"))
        # sum over q in D_I, q != r, of <pq||rq> (the q = r term is
        # <pr||rr> = 0 by antisymmetry)
        e_pqrq = eri[p[:, None], ar[None, :], r[:, None], ar[None, :]]
        val = t(sgl["sign"]).to(dt) * (h1[p, r] + (e_pqrq * O[I]).sum(1))
        H[I, J] = val
        H[J, I] = val.conj()
    if len(dbl["I"]):
        I, J, p, q, r, s = (t(dbl[k]) for k in ("I", "J", "p", "q", "r", "s"))
        val = t(dbl["sign"]).to(dt) * eri[p, q, r, s]
        H[I, J] = val
        H[J, I] = val.conj()
    return H


def fci_ground_state(h1, eri_asym, nelec, nroots=1, sz_labels=None,
                     target_2sz=None):
    """Lowest eigenvalue(s) of the two-body Hamiltonian.

    Args:
        h1: (nso, nso) one-body integrals (spin-orbital basis).
        eri_asym: (nso,)*4 antisymmetrized <pq||rs>.
        nelec: electron count.
        sz_labels: optional (nso,) spin label per orbital (0 alpha, 1 beta).
            With ``target_2sz`` set, determinants are restricted to the
            n_alpha - n_beta = target_2sz sector: the open-shell
            (UHF-reference) oracle mode, where the global ground state may
            live in another spin sector than the coupled-cluster state.
    Returns (energies, ndet): the nroots lowest electronic energies as a
    numpy array.
    """
    nso = torch.as_tensor(h1).shape[0]
    dets = list(combinations(range(nso), nelec))
    if target_2sz is not None:
        sz = np.asarray(sz_labels)
        dets = [d for d in dets
                if sum(1 - 2 * int(sz[p]) for p in d) == target_2sz]
    H = build_hamiltonian(h1, eri_asym, dets)
    w = torch.linalg.eigvalsh(H)
    return w[:nroots].cpu().numpy(), len(dets)

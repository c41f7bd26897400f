"""CCSD response (Lambda) one-particle density matrix (torch).

The reference's ccsd_rdm/ccsd_lambda machinery computes
gamma_pq = <0|(1+Lambda) e^{-T} a_p^+ a_q e^{T}|0> from the Lambda
equations. Here Lambda is the left ground eigenvector of the projected
Hbar (the determinant-space transform of cc/eom.py), and the density the
operator sandwich

    gamma_pq = L^T [e^{-T} (a_p^+ a_q) e^{T}] R / (L^T R),

the converged Lambda-equation response density at small-system (oracle)
cost. For two electrons the projected space is complete, so gamma equals
the FCI density. The a_p^+ a_q transitions between determinants are
enumerated on the host; the sandwich is one gather and scatter on the
device of the integrals.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.cc.eom import _hbar, _projection
from pyscf_isdf_tpu_torch.cc.fci import _phase, build_hamiltonian


def _transitions(dets, nso):
    """(p, q, I, J, sign) of every nonzero <D_J|a_p^+ a_q|D_I>, numpy."""
    index = {d: i for i, d in enumerate(dets)}
    rows = []
    for I, d in enumerate(dets):
        occ = set(d)
        for q in d:
            d1 = tuple(sorted(occ - {q}))
            for p in range(nso):
                if p != q and p in occ:
                    continue
                J = index.get(tuple(sorted(occ - {q} | {p})))
                if J is None:
                    continue
                rows.append((p, q, I, J, _phase(d, q) * _phase(d1, p)))
    a = np.asarray(rows, dtype=np.float64).reshape(-1, 5)
    return [a[:, k].astype(np.int64) for k in range(4)] + [a[:, 4]]


def _sandwich(left, right, dets, nso, dev):
    """gamma[p, q] = sum_IJ left[J] <D_J|a_p^+ a_q|D_I> right[I]."""
    p, q, I, J, s = (torch.as_tensor(x, device=dev)
                     for x in _transitions(dets, nso))
    vals = left[J] * s.to(left.dtype) * right[I]
    gamma = torch.zeros(nso * nso, dtype=vals.dtype, device=dev)
    return gamma.index_add_(0, p * nso + q, vals).reshape(nso, nso)


def _eigvec(w, V, i):
    """Column i of V, made real when its imaginary part is below 1e-10."""
    v = V[:, i]
    return v.real if float(v.imag.abs().max()) < 1e-10 else v


def ccsd_rdm1(h1so, eri_so, t1, t2, nocc):
    """Spin-orbital response 1-RDM of the CCSD ground state, on the device
    of ``eri_so``."""
    eri_so = torch.as_tensor(eri_so)
    nso = eri_so.shape[0]
    no = int(nocc)
    dets = list(combinations(range(nso), no))
    index = {d: i for i, d in enumerate(dets)}
    eTm, H, eT = _hbar(h1so, eri_so, t1, t2, no, dets, no)
    Hbar = eTm @ H @ eT
    dev = Hbar.device
    idx = torch.as_tensor([index[d] for d in _projection(range(no), nso, "ee")],
                          device=dev)
    Hp = Hbar[idx][:, idx]

    wr, Vr = torch.linalg.eig(Hp)
    i0 = int(torch.argmin(wr.real))
    R = _eigvec(wr, Vr, i0)
    wl, Vl = torch.linalg.eig(Hp.T)
    j0 = int(torch.argmin((wl - wr[i0]).abs()))
    L = _eigvec(wl, Vl, j0)
    dt = torch.promote_types(torch.promote_types(L.dtype, R.dtype), Hbar.dtype)
    L, R = L.to(dt), R.to(dt)
    norm = L @ R

    Rf = torch.zeros(len(dets), dtype=dt, device=dev)
    Lf = torch.zeros(len(dets), dtype=dt, device=dev)
    Rf[idx] = R
    Lf[idx] = L
    gamma = _sandwich(Lf @ eTm.to(dt), eT.to(dt) @ Rf, dets, nso, dev)
    return (gamma / norm).real


def fci_rdm1(h1so, eri_so, nelec):
    """FCI 1-RDM (oracle), on the device of ``eri_so``."""
    eri_so = torch.as_tensor(eri_so)
    nso = eri_so.shape[0]
    dets = list(combinations(range(nso), nelec))
    H = build_hamiltonian(h1so, eri_so, dets)
    _, V = torch.linalg.eigh(H)
    c = V[:, 0]
    return _sandwich(c.conj(), c, dets, nso, H.device).real

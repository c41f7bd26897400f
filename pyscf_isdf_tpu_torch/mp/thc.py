"""THC-MP2: tensor-hypercontraction MP2 through the ISDF factorization.

BASELINE config 5: the ISDF build gives exactly the THC form of the ERIs

    (ia|jb) ~= sum_PQ X_iP X_aP W_PQ X_jQ X_bQ,   X = C^T aoRg

so the MP2 energy never forms the O(N^4) ERIs from the grid: only the
(n_IP x nocc) / (n_IP x nvir) collocations and the n_IP^2 kernel enter,
through GEMMs (spec: Lu-Ying ISDF; SURVEY.md section 7.5).
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df.isdf import ISDF
from pyscf_isdf_tpu_torch.df.isdf_k import w_phased
from pyscf_isdf_tpu_torch.kpts_helper import get_kconserv
from pyscf_isdf_tpu_torch.mp.kmp2 import _to_oovv, rmp2_pair_energy
from pyscf_isdf_tpu_torch.mp.mp2 import mp2_from_ovov
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def thc_mp2_energy(isdf: ISDF, mo_coeff, mo_energy, nocc: int, device=None,
                   timer=None) -> float:
    """MP2 correlation energy from THC/ISDF factors, on ``device``
    (default: the GPU), where ``isdf`` must live.

    The reference maps a per-pair function over all nocc^2 (i, j) pairs,
    each forming Li = Xo[:, i] Xv and v_ab = Li^T W Lj; batched, those
    are (nocc^2, n_IP, nvir) intermediates (35 GB at diamond 3x3x3, nocc
    108, n_IP 3456). This computes the same (ia|jb) in factored form:
    L = (Xo o Xv) as (n_IP, nocc*nvir) (0.32 GB there), ovov = L^T (W L)
    (two GEMMs, 1.2e12 flop there), into the same (nocc*nvir)^2 matrix
    the exact path assembles, and shares its energy assembly
    (:func:`~pyscf_isdf_tpu_torch.mp.mp2.mp2_from_ovov`).

    Args:
        isdf: built Gamma-point ISDF factorization (aoRg, W).
        mo_coeff: (nao, nmo) converged RHF orbitals.
        mo_energy: (nmo,) orbital energies (SCF convention, exxdiv included).
        timer: optional StageTimer; records 'thc ovov' and 'assembly'.
    """
    dev = require_device(isdf.W, device)
    timer = timer or null_timer
    dt = isdf.aoRg.dtype
    mo_c = torch.as_tensor(mo_coeff, device=dev).to(dt)
    mo_e = torch.as_tensor(mo_energy, device=dev).to(torch.float64)
    with timer("thc ovov"):
        Xg = isdf.aoRg @ mo_c                                # (n_ip, nmo)
        Xo, Xv = Xg[:, :nocc], Xg[:, nocc:]
        L = (Xo[:, :, None] * Xv[:, None, :]).reshape(Xg.shape[0], -1)
        ovov = L.T @ (isdf.W @ L)
    with timer("assembly"):
        return mp2_from_ovov(ovov, mo_e[:nocc], mo_e[nocc:])


def thc_kmp2_energy(system, kscf_res, isdfk, nocc=None, device=None) -> float:
    """k-point THC-MP2: KMP2 with ERIs from the k-ISDF factors, on
    ``device`` (default: the GPU), where ``system`` and ``isdfk`` live.

    (i ki, a ka | j kj, b kb) ~= sum_PQ conj(u_i(P)) u_a(P)
        conj(W_q[P,Q]) conj(u_j(Q)) u_b(Q),  q = ka - ki
    (the W_q kernels the exchange build uses) when kb - kj + q = 0, and
    through the phased kernel of :func:`~pyscf_isdf_tpu_torch.df.isdf_k.
    w_phased` when it is a nonzero reciprocal-lattice vector G (needs
    ``build_isdf_k(..., keep_xi=True)``). No grid-sized transform enters
    the assembly.

    Each distinct (q, G) kernel is built once, like the reference's
    per-(q, G) cache, but consumed at once: the triples are grouped by
    their kernel and every block that uses it is formed before the next
    one is built, so one phased kernel is alive at a time (a 3x3x3 mesh
    has 604 of them, 75 MB each at n_IP 2160). (i a) x W comes first,
    once per (ki, ka) and kernel; the blocks then take one batched GEMM.
    """
    dev = require_device(isdfk.Ug, device)
    cell, kpts = system.cell, system.kpts
    nk = len(kpts)
    mo_e, mo_c = kscf_res["mo_energy"], kscf_res["mo_coeff"]
    if nocc is None:
        nocc = cell.nelectron // 2
    nmo = mo_c[0].shape[1]
    nvir = nmo - nocc
    kconserv = get_kconserv(cell.a, kpts)
    cdt = isdfk.Ug.dtype
    C = torch.stack([torch.as_tensor(c, device=dev).to(cdt) for c in mo_c])
    U = isdfk.Ug @ C                                         # (nk, nip, nmo)
    Uo, Uv = U[:, :, :nocc], U[:, :, nocc:]
    # A[ki, ka][P, i a] = conj(u_i(P)) u_a(P)
    A = (Uo.conj()[:, None, :, :, None] * Uv[None, :, :, None, :]).reshape(
        nk, nk, isdfk.n_ip, nocc * nvir)
    e = torch.stack([torch.as_tensor(x, device=dev).to(torch.float64) for x in mo_e])
    e_o, e_v = e[:, :nocc], e[:, nocc:]

    # group the (ki, ka, kj) triples by their kernel: (q index, G) with
    # G = 0 for the plain conj(W_q)
    groups: dict = {}
    for ki in range(nk):
        for ka in range(nk):
            q = kpts[ka] - kpts[ki]
            for kj in range(nk):
                kb = kconserv[ki, ka, kj]
                G = kpts[kb] - kpts[kj] + q
                gkey = None if np.linalg.norm(G) < 1e-8 else tuple(np.round(G, 8))
                key = (int(isdfk.qmap[ka, ki]), gkey)
                groups.setdefault(key, (q, G, {}))[2].setdefault((ki, ka), []).append(
                    (kj, kb))

    eri = torch.empty((nk, nk, nk, nocc * nvir, nocc * nvir), dtype=cdt, device=dev)
    for (iq, gkey), (q, G, pairs) in groups.items():
        if gkey is None:
            W = isdfk.Wq[iq].conj()
        else:
            W = w_phased(isdfk, cell, q, G, kpts=kpts)
        for (ki, ka), rest in pairs.items():
            AW = A[ki, ka].T @ W                             # (no*nv, nip)
            kj = torch.as_tensor([r[0] for r in rest], device=dev)
            kb = torch.as_tensor([r[1] for r in rest], device=dev)
            eri[ki, ka, kj] = AW @ A[kj, kb]
        del W

    kc = torch.as_tensor(kconserv, device=dev)
    emp2 = torch.zeros((), dtype=torch.float64, device=dev)
    for ki in range(nk):
        for kj in range(nk):
            kb = kc[ki, :, kj]
            oovv = _to_oovv(eri[ki, :, kj], nocc, nvir, nocc, nvir, nk)
            emp2 += rmp2_pair_energy(oovv, e_o, e_v, ki, kj, kb)
    return float(emp2) / nk

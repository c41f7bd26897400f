"""k-point restricted and unrestricted MP2 (KMP2 / KUMP2, torch).

Energy contract per the reference kernel (pyscf/pbc/mp/kmp2.py:45-155):
triple loop over (ki, kj, ka) with kb from momentum conservation, MO ERIs
from the FFT-grid transform (the ``with_df.ao2mo`` fallback path,
kmp2.py:119-126), t2 = conj(oovv/e_ijab), and

    E2 = (1/nk) sum [ 2 t2.oovv(ka) - t2.oovv_swapped(kb) ].

Frozen core and per-k occupation padding (the reference's
``_padding_k_idx`` machinery, kmp2.py:228) pad every k to the largest
occupied/virtual counts with zero MO columns and sentinel energies
(``_PAD_E``): padded amplitudes vanish identically.

The first pair's screened potential depends on (ki, ka) only, so it is
built once per pair for every ka of one ki in one batch of FFTs
(nk^2 pair FFT batches instead of nk^3), the kernels coulG(q) and
phases e^{-iq.r} once per distinct q (:class:`~pyscf_isdf_tpu_torch.df.
fft_ao2mo.QKernels`), the second pair's quadrature as one batched GEMM
over ka per (ki, kj), and the energy sums stay on the device.

KUMP2 (reference pyscf/pbc/mp/kump2.py): same-spin channels use the
antisymmetrized pair energy E_ss = 1/2 sum conj(o)/D (o - o_swap); the
opposite-spin channel E_os = sum |o_ab|^2 / D. The closed-shell limit
reproduces KMP2.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch import symm
from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df.fft_ao2mo import QKernels
from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.kpts_helper import get_kconserv

_PAD_E = 1e9  # sentinel orbital energy: padded amplitudes ~ 1/1e9 -> 0


def _pad_spaces(aoR_k, mo_c, mo_e, nocc_k, frozen):
    """Per-k occupied/virtual grids and energies, padded to common sizes.

    Padded occupied columns are zero with energy -_PAD_E; padded virtuals
    zero with +_PAD_E, so their MP2 contributions are exactly zero.
    Returns (moR_o (nk, ng, no), moR_v (nk, ng, nv), e_o (nk, no),
    e_v (nk, nv)) on the device of ``aoR_k``.
    """
    dev = aoR_k.device
    nk, ng, _ = aoR_k.shape
    nmo = mo_c[0].shape[1]
    nocc_k = [int(n) - frozen for n in nocc_k]
    if any(n <= 0 for n in nocc_k):
        raise ValueError("frozen count leaves no occupied orbitals")
    no = max(nocc_k)
    nv = max(nmo - frozen - n for n in nocc_k)
    moR_o = torch.zeros((nk, ng, no), dtype=aoR_k.dtype, device=dev)
    moR_v = torch.zeros((nk, ng, nv), dtype=aoR_k.dtype, device=dev)
    e_o = torch.full((nk, no), -_PAD_E, dtype=torch.float64, device=dev)
    e_v = torch.full((nk, nv), _PAD_E, dtype=torch.float64, device=dev)
    for k in range(nk):
        n_k = nocc_k[k]
        m = aoR_k[k] @ torch.as_tensor(mo_c[k], device=dev).to(aoR_k.dtype)
        e = torch.as_tensor(mo_e[k], device=dev).to(torch.float64)
        moR_o[k, :, :n_k] = m[:, frozen:frozen + n_k]
        moR_v[k, :, :nmo - frozen - n_k] = m[:, frozen + n_k:]
        e_o[k, :n_k] = e[frozen:frozen + n_k]
        e_v[k, :nmo - frozen - n_k] = e[frozen + n_k:]
    return moR_o, moR_v, e_o, e_v


def _first_pairs(o_ki, moR_v, ki, qk, mesh):
    """e^{+iq.r} ifft(coulG_q fft(conj(o_ki) v_ka e^{-iq.r})), q = ka - ki,
    for every ka in one batch: (nk, no*nv, ng)."""
    nk, ng, nv = moR_v.shape
    no = o_ki.shape[1]
    kern = [qk(ki, ka) for ka in range(nk)]
    coulG = torch.stack([c for c, _ in kern])[:, None]      # (nk, 1, ng)
    phase = torch.stack([p for _, p in kern])[:, None]      # e^{-iq.r}
    pairs = (o_ki.conj().T[None, :, None, :] * moR_v.transpose(1, 2)[:, None, :, :])
    pairs = pairs.reshape(nk, no * nv, ng) * phase
    return ifft3(coulG * fft3(pairs, mesh), mesh) * phase.conj()


def _eri_ka(Vt, o_kj, moR_v, kb, weight):
    """(i ki, a ka | j kj, b kb) for every ka as (nka, no1*nv1, no2*nv2),
    from the first pairs ``Vt`` of one ki and the occupied grid of kj."""
    nka, _, ng = Vt.shape
    v = moR_v[kb]                                           # (nka, ng, nv2)
    P = (o_kj.conj()[None, :, :, None] * v[:, :, None, :]).reshape(nka, ng, -1)
    return weight * (Vt @ P)                                # (nka, no1*nv1, no2*nv2)


def _denominators(e_o1, e_v1, e_o2, e_v2, ki, kj, kb):
    """e_i + e_j - e_a - e_b as (ka, i, j, a, b)."""
    eia = e_o1[ki][None, :, None] - e_v1[:, None, :]        # (nka, no1, nv1)
    ejb = e_o2[kj][None, :, None] - e_v2[kb][:, None, :]    # (nka, no2, nv2)
    return eia[:, :, None, :, None] + ejb[:, None, :, None, :]


def _to_oovv(eri, no1, nv1, no2, nv2, nk):
    """(ka, i a, j b) ERIs to (ka, i, j, a, b) oovv blocks / nk."""
    return eri.reshape(-1, no1, nv1, no2, nv2).permute(0, 1, 3, 2, 4) / nk


def rmp2_pair_energy(oovv, e_o, e_v, ki, kj, kb):
    """Re sum_ka [2 t2.oovv(ka) - t2.oovv(kb)^T] for one (ki, kj), with
    t2 = conj(oovv / D); ``oovv`` is (ka, i, j, a, b) and ``kb`` the
    (nka,) index tensor of kb(ki, ka, kj). A device scalar."""
    t2 = (oovv / _denominators(e_o, e_v, e_o, e_v, ki, kj, kb)).conj()
    return (2 * (t2 * oovv).sum().real
            - (t2 * oovv[kb].transpose(-1, -2)).sum().real)


def _nocc_list(cell, kscf_res, nocc, nk):
    if nocc is None:
        if kscf_res.get("mo_occ") is not None:
            return [int(round(float(np.sum(np.asarray(o))) / 2))
                    for o in kscf_res["mo_occ"]]
        return [cell.nelectron // 2] * nk
    if np.isscalar(nocc):
        return [int(nocc)] * nk
    return [int(n) for n in nocc]


def kmp2_energy(system, kscf_res, nocc=None, frozen: int = 0,
                ki_list=None, ki_weights=None, device=None) -> float:
    """KMP2 correlation energy from a converged KRHF result, on ``device``
    (default: the GPU), where ``system`` must live.

    Args:
        system: KSCFSystem.
        kscf_res: result of kscf_kernel (uses mo_coeff/mo_energy at all k).
        nocc: occupied count — int (uniform), per-k list, or None (from
            mo_occ when present, else nelectron/2).
        frozen: number of frozen-core orbitals per k-point.
        ki_list / ki_weights: optional restriction of the outer ki loop
            to symmetry-irreducible k-points with orbit-size weights
            (sum = nk) — the reference's kmp2_ksymm reduction
            (pyscf/pbc/mp/kmp2_ksymm.py); exact by the invariance of the
            (kj, ka) inner sums under the ki orbit.
    """
    dev = require_device(system.aoR_k, device)
    cell, kpts = system.cell, system.kpts
    nk = len(kpts)
    nocc_k = _nocc_list(cell, kscf_res, nocc, nk)
    kconserv = torch.as_tensor(get_kconserv(cell.a, kpts), device=dev)
    moR_o, moR_v, e_o, e_v = _pad_spaces(system.aoR_k, kscf_res["mo_coeff"],
                                         kscf_res["mo_energy"], nocc_k, frozen)
    no, nv = moR_o.shape[2], moR_v.shape[2]
    qk = QKernels(cell, kpts, dev)
    if ki_list is None:
        ki_list, ki_weights = range(nk), [1.0] * nk
    emp2 = torch.zeros((), dtype=torch.float64, device=dev)
    for ki, w_i in zip(ki_list, ki_weights):
        Vt = _first_pairs(moR_o[ki], moR_v, ki, qk, system.mesh)
        for kj in range(nk):
            kb = kconserv[ki, :, kj]
            eri = _eri_ka(Vt, moR_o[kj], moR_v, kb, system.weight)
            oovv = _to_oovv(eri, no, nv, no, nv, nk)
            emp2 += w_i * rmp2_pair_energy(oovv, e_o, e_v, ki, kj, kb)
    return float(emp2) / nk


def kmp2_ksymm_energy(system, ibz_res, nocc=None, frozen: int = 0,
                      device=None) -> float:
    """KMP2 on an IBZ-symmetry SCF result (reference kmp2_ksymm.py).

    Expands the IBZ MOs to the full BZ through the space-group AO
    rotations (symm.expand_mos) and restricts the outer ki loop to the
    irreducible wedge with orbit weights — an nk/nk_ibz reduction of
    both the SCF that produced the orbitals and the MP2 triple loop.

    Args:
        system: KSCFSystem built on the FULL k-point set.
        ibz_res: result dict of kscf_ibz_kernel (carries the IBZInfo).
    """
    require_device(system.aoR_k, device)
    info = ibz_res["ibz"]
    mo_e, mo_c = symm.expand_mos(system.cell, info, ibz_res["mo_coeff"],
                                 ibz_res["mo_energy"])
    return kmp2_energy(system, {"mo_energy": mo_e, "mo_coeff": mo_c},
                       nocc=nocc, frozen=frozen,
                       ki_list=[int(i) for i in info.ibz_idx],
                       ki_weights=[float(w) for w in info.weights], device=device)


def kump2_energy(system, kuhf_res, nocc=None, frozen: int = 0,
                 device=None) -> float:
    """KUMP2 correlation energy from a converged KUHF result, on ``device``
    (default: the GPU), where ``system`` must live.

    Args:
        kuhf_res: result of kuhf_kernel — mo_energy/mo_coeff are
            (alpha, beta) tuples of per-k lists.
        nocc: (na, nb) per-spin occupied counts, or None (from cell).
    """
    dev = require_device(system.aoR_k, device)
    cell, kpts = system.cell, system.kpts
    nk = len(kpts)
    ea, eb = kuhf_res["mo_energy"]
    ca, cb = kuhf_res["mo_coeff"]
    if nocc is None:
        na = (cell.nelectron + cell.spin) // 2
        nb = cell.nelectron - na
    else:
        na, nb = nocc
    kconserv = torch.as_tensor(get_kconserv(cell.a, kpts), device=dev)
    spaces = (_pad_spaces(system.aoR_k, ca, ea, [na] * nk, frozen),
              _pad_spaces(system.aoR_k, cb, eb, [nb] * nk, frozen))
    qk = QKernels(cell, kpts, dev)

    def block(s1, s2, Vt, ki, kj, kb):
        o1, v1, eo1, ev1 = spaces[s1]
        o2, v2, eo2, ev2 = spaces[s2]
        eri = _eri_ka(Vt, o2[kj], v2, kb, system.weight)
        o = _to_oovv(eri, o1.shape[2], v1.shape[2], o2.shape[2], v2.shape[2], nk)
        return o, _denominators(eo1, ev1, eo2, ev2, ki, kj, kb)

    emp2 = torch.zeros((), dtype=torch.float64, device=dev)
    for ki in range(nk):
        Vt = [_first_pairs(o[ki], v, ki, qk, system.mesh) for o, v, _, _ in spaces]
        for kj in range(nk):
            kb = kconserv[ki, :, kj]
            # opposite spin (alpha-beta): E_os = sum |o|^2 / D
            o, d = block(0, 1, Vt[0], ki, kj, kb)
            emp2 += ((o.conj() / d) * o).sum().real
            # same spin: E_ss = 1/2 sum conj(o)/D (o - o_swap)
            for s in (0, 1):
                o, d = block(s, s, Vt[s], ki, kj, kb)
                t2 = (o / d).conj()
                emp2 += 0.5 * ((t2 * o).sum().real
                               - (t2 * o[kb].transpose(-1, -2)).sum().real)
    return float(emp2) / nk

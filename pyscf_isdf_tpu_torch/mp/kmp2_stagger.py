"""Staggered-mesh k-point MP2 (reduced finite-size error, torch).

Reference behaviour: pyscf/pbc/mp/kmp2_stagger.py (Xin Xing, JCTC 2021,
17, 4733): occupied orbitals live on one Monkhorst-Pack mesh and virtuals
on a second mesh shifted by half a mesh step, which cancels the leading
finite-size error of the q->0 Coulomb singularity in the MP2 energy. Two
modes:

  * ``flag_submesh=True``: the occupied and virtual meshes are the two
    half-size staggered submeshes of the SCF mesh (an even mesh), with
    the converged k-SCF orbitals;
  * ``flag_submesh=False``: virtuals on the SCF mesh, occupieds on the
    half-step-shifted mesh, both from non-self-consistent bands
    (:func:`~pyscf_isdf_tpu_torch.scf.bands.get_bands`) with
    ``exxdiv='vcut_sph'`` (finite at q=0, so the shifted mesh needs no
    probe-charge shift).

The energy is the KMP2 triple loop (ki, kj over the occupied mesh, ka
over the virtual mesh, kb = ki - ka + kj on the virtual mesh), 1/nk
normalised, on the machinery of :mod:`pyscf_isdf_tpu_torch.mp.kmp2`:
coulG(q) and e^{-iq.r} once per distinct q, the first pairs of one ki for
every ka in one batch of FFTs, ka in one batched GEMM per (ki, kj).
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df.fft_ao2mo import QKernels
from pyscf_isdf_tpu_torch.mp.kmp2 import _eri_ka, _first_pairs, _to_oovv, rmp2_pair_energy
from pyscf_isdf_tpu_torch.ops.ao_eval import eval_ao_kpts
from pyscf_isdf_tpu_torch.scf.bands import get_bands
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def _mp_size(a, kpts) -> np.ndarray:
    """Monkhorst-Pack mesh size from the k-point set: the per-axis unique
    fractional coordinates, rounded to 8 decimals and then wrapped into
    [0, 1).

    The reference (pyscf_isdf_tpu/mp/kmp2_stagger.py:40) wraps before it
    rounds, so a coordinate of -1e-17 becomes 1.0 and counts beside 0.0:
    every Gamma-centred mesh of the diamond (fcc) cell reads one point
    too long on each axis (2x2x2 as 3x3x3).
    """
    b_inv = np.asarray(a, dtype=np.float64).T / (2 * np.pi)
    scaled = np.round(kpts @ b_inv, 8) % 1.0
    return np.array([len(np.unique(scaled[:, x])) for x in range(3)])


def _match_kpts(a, kpts_sub, kpts_all) -> np.ndarray:
    """Indices of each kpts_sub point inside kpts_all, both mapped to the
    first zone by fractional rounding to 8 decimals (the reference's)."""
    b_inv = np.asarray(a, dtype=np.float64).T / (2 * np.pi)
    f_all = np.round(kpts_all @ b_inv, 8) % 1.0
    f_sub = np.round(kpts_sub @ b_inv, 8) % 1.0
    idx = []
    for f in f_sub:
        d = np.abs(f_all - f)
        d = np.minimum(d, 1.0 - d).sum(axis=1)
        j = int(np.argmin(d))
        if d[j] > 1e-8:
            raise RuntimeError("staggered submesh point not found in the SCF k-mesh")
        idx.append(j)
    idx = np.asarray(idx)
    if len(np.unique(idx)) != len(idx):
        raise RuntimeError("staggered submesh matching is not one-to-one")
    return idx


def _kb_table(a, kpts_occ, kpts_vir) -> np.ndarray:
    """kb[ki, ka, kj]: the virtual-mesh index of k_i - k_a + k_j (the
    reference's lookup by fractional coordinates rounded to 6 decimals,
    with a 1e-5 tolerant scan as its fallback)."""
    b_inv = np.asarray(a, dtype=np.float64).T / (2 * np.pi)
    vir_frac = {tuple(np.round(kv @ b_inv, 6) % 1.0): i for i, kv in enumerate(kpts_vir)}

    def vir_index(k_target):
        key = tuple(np.round(k_target @ b_inv, 6) % 1.0)
        if key in vir_frac:
            return vir_frac[key]
        f = np.asarray(key)
        for kk, i in vir_frac.items():
            d = np.abs(np.asarray(kk) - f)
            if np.minimum(d, 1.0 - d).sum() < 1e-5:
                return i
        raise RuntimeError("momentum-conserving kb not on the virtual mesh")

    n_o, n_v = len(kpts_occ), len(kpts_vir)
    return np.array([[[vir_index(kpts_occ[i] - kpts_vir[a_] + kpts_occ[j])
                       for j in range(n_o)] for a_ in range(n_v)] for i in range(n_o)])


def kmp2_stagger_energy(system, kscf_res, nocc=None, flag_submesh=False, xc=None,
                        device=None, timer=None) -> float:
    """Staggered-mesh KMP2 correlation energy from a converged k-SCF, on
    ``device`` (default: the GPU), where ``system`` must live.

    Args:
        system: KSCFSystem whose kpts are a Gamma-centred MP mesh.
        kscf_res: result dict of kscf_kernel.
        nocc: occupied count per k (int); default nelectron // 2.
        flag_submesh: True -> the two half-size staggered submeshes of the
            SCF mesh; False -> non-SCF bands on the half-step-shifted mesh.
        xc: the functional of the SCF (for the non-SCF Fock build).
        timer: optional StageTimer; records 'bands' (the non-SCF bands
            and the orbitals on the grid) and 'triple loop'.
    """
    dev = require_device(system.aoR_k, device)
    timer = timer or null_timer
    cell, a = system.cell, system.cell.a
    kpts = np.asarray(system.kpts)
    no = int(nocc) if nocc is not None else cell.nelectron // 2
    nks = _mp_size(a, kpts)
    b = lattice.reciprocal_vectors(a)

    def grid_mos(ao, c):
        return ao @ torch.as_tensor(c, device=dev).to(ao.dtype)

    with timer("bands"):
        if flag_submesh:
            if np.any(nks % 2):
                raise RuntimeError("SCF k-mesh has odd size; staggered submeshes need "
                                   "an even mesh (set flag_submesh=False)")
            nks_ov = nks // 2
            shift = kpts[np.argmin(np.sum(kpts**2, axis=1))]
            half_shift = np.array([0.5 / n for n in nks_ov]) @ b
            kpts_vir = shift + lattice.make_kpts(a, nks_ov, with_gamma_point=True)
            kpts_occ = kpts_vir + half_shift
            idx_vir = _match_kpts(a, kpts_vir, kpts)
            idx_occ = _match_kpts(a, kpts_occ, kpts)
            mo_e, mo_c = kscf_res["mo_energy"], kscf_res["mo_coeff"]
            moR = {k: grid_mos(system.aoR_k[k], mo_c[k])
                   for k in set(idx_vir.tolist()) | set(idx_occ.tolist())}
            occ = [(moR[k][:, :no], mo_e[k][:no]) for k in idx_occ]
            vir = [(moR[k][:, no:], mo_e[k][no:]) for k in idx_vir]
        else:
            half_shift = np.array([0.5 / n for n in nks]) @ b
            kpts_vir, kpts_occ = kpts, kpts + half_shift
            nk = len(kpts)
            mo_e_all, mo_c_all = get_bands(system, kscf_res,
                                           np.concatenate([kpts_occ, kpts_vir]), xc=xc,
                                           exxdiv="vcut_sph", device=dev)
            # global fill over the union mesh (the reference's khf.get_occ on
            # the concatenated set): every k must hold ``no`` orbitals
            e_host = [np.asarray(e.cpu()) for e in mo_e_all]
            order = np.argsort(np.concatenate(e_host))
            cnt = np.bincount(order[:no * 2 * nk] // len(e_host[0]), minlength=2 * nk)
            if np.any(cnt != no):
                raise RuntimeError("non-uniform occupations across the staggered meshes "
                                   "(metallic fill): staggered-mesh MP2 needs a gapped fill")
            ao_occ = eval_ao_kpts(cell, kpts_occ, device=dev)
            occ = [(grid_mos(ao_occ[i], mo_c_all[i])[:, :no], mo_e_all[i][:no])
                   for i in range(nk)]
            vir = [(grid_mos(system.aoR_k[i], mo_c_all[nk + i])[:, no:],
                    mo_e_all[nk + i][no:]) for i in range(nk)]
        moR_o = torch.stack([m for m, _ in occ])
        moR_v = torch.stack([m for m, _ in vir])
        e_o = torch.stack([torch.as_tensor(e, device=dev) for _, e in occ]).to(torch.float64)
        e_v = torch.stack([torch.as_tensor(e, device=dev) for _, e in vir]).to(torch.float64)

    with timer("triple loop"):
        n_o, nv = len(occ), moR_v.shape[2]
        kb_tab = torch.as_tensor(_kb_table(a, kpts_occ, kpts_vir), device=dev)
        qk = QKernels(cell, np.concatenate([kpts_occ, kpts_vir]), dev)

        def qk_ov(ki, ka):
            return qk(ki, n_o + ka)

        emp2 = torch.zeros((), dtype=torch.float64, device=dev)
        for ki in range(n_o):
            Vt = _first_pairs(moR_o[ki], moR_v, ki, qk_ov, system.mesh)
            for kj in range(n_o):
                kb = kb_tab[ki, :, kj]
                eri = _eri_ka(Vt, moR_o[kj], moR_v, kb, system.weight)
                oovv = _to_oovv(eri, no, nv, no, nv, len(vir))
                emp2 += rmp2_pair_energy(oovv, e_o, e_v, ki, kj, kb)
        return float(emp2) / len(vir)

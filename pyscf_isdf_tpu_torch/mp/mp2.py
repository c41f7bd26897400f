"""Gamma-point restricted MP2 on the FFT grid (torch).

Energy contract per the reference k-point kernel at a single Gamma point
(pyscf/pbc/mp/kmp2.py:45-155): ERIs from the FFT-grid transform, SCF
orbital energies as they are (the ewald exxdiv shift of occupied levels
included, as the reference does), and

    E2 = sum_iajb (ia|jb) [2 (ia|jb) - (ib|ja)] / (ei + ej - ea - eb).

The assembly runs on the device of the ERIs, a block of occupied rows at
a time; the exchange term is a permuted view of the same block.
"""
from __future__ import annotations

import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df import fft_ao2mo
from pyscf_isdf_tpu_torch.utils.timing import null_timer

_PAIR_CHUNK = 256       # first-pair rows through the FFTs together
_ASSEMBLY_BLOCK = 16    # occupied rows of (ia|jb) per assembly step


def mp2_from_ovov(ovov, e_o, e_v) -> float:
    """E2 from the (nocc*nvir, nocc*nvir) real (ia|jb) matrix and the
    occupied / virtual orbital energies (tensors on its device)."""
    no, nv = e_o.shape[0], e_v.shape[0]
    ovov = ovov.reshape(no, nv, no, nv)
    d_ov = e_o[:, None] - e_v[None, :]                      # (no, nv)
    e2 = torch.zeros((), dtype=ovov.dtype, device=ovov.device)
    for i0 in range(0, no, _ASSEMBLY_BLOCK):
        i1 = i0 + _ASSEMBLY_BLOCK
        o = ovov[i0:i1]                                     # (b, nv, no, nv)
        t2 = o / (d_ov[i0:i1, :, None, None] + d_ov[None, None])
        e2 += (t2 * (2 * o - o.permute(0, 3, 2, 1))).sum()
    return float(e2)


def mp2_energy(system, scf_res, nocc=None, device=None, timer=None) -> float:
    """MP2 correlation energy from a converged Gamma-point RHF result, on
    ``device`` (default: the GPU), where ``system`` must live.

    ``timer`` (a :class:`~pyscf_isdf_tpu_torch.utils.timing.StageTimer`)
    records the stages 'ao2mo' and 'assembly', and inside 'ao2mo' the
    transform's 'ao2mo fft' and 'ao2mo gemm'
    (:func:`~pyscf_isdf_tpu_torch.df.fft_ao2mo.general`).
    """
    dev = require_device(system.aoR, device)
    timer = timer or null_timer
    aoR = system.aoR
    mo_e = torch.as_tensor(scf_res["mo_energy"], device=dev).to(torch.float64)
    mo_c = torch.as_tensor(scf_res["mo_coeff"], device=dev).to(aoR.dtype)
    if nocc is None:
        nocc = system.nelec // 2
    with timer("ao2mo"):
        moR = aoR @ mo_c
        o, v = moR[:, :nocc], moR[:, nocc:]
        ovov = fft_ao2mo.general(o, v, o, v, system.coulG, system.mesh,
                                 system.weight, chunk=_PAIR_CHUNK, timer=timer)
    with timer("assembly"):
        return mp2_from_ovov(ovov, mo_e[:nocc], mo_e[nocc:])

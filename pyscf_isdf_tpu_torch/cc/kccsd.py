"""k-point CCSD on the momentum-blocked composite index (torch), the
oracle of the blocked tiers.

The reference's KCCSD (pyscf/pbc/cc/kccsd.py) is spin-orbital CCSD over
Bloch orbitals with k-conservation enforced per contraction. Here the
same physics is one composite-index problem: spin orbital (k, p, sigma)
with the full k-conserving MO ERI tensor (df/fft_ao2mo.ao2mo_7d) scattered
into a dense <PQ||RS> whose non-conserving blocks are exactly zero; the
Gamma-point gccsd kernel solves it unchanged.

Normalization: the composite ERIs are the supercell ERIs, (primitive-cell
Bloch ERIs)/nk; the solved problem is the nk-cell supercell and the
returned e_corr is per unit cell (E_supercell/nk). At diamond 2x2x2
gth-szv (nso 128) the complex <PQ||RS> is 4.3 GB; at gth-dzvp it would be
(8 x 52)^4 x 16 B = 480 GB.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.cc import gccsd
from pyscf_isdf_tpu_torch.cc.kccsd_blocked import AO2MO_CHUNK, _scf_arrays
from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df import fft_ao2mo
from pyscf_isdf_tpu_torch.kpts_helper import get_kconserv


def _composite_chem(system, eri7, nmo):
    """Scatter the (nk,nk,nk,nmo^4) k-conserving ERIs into the dense
    composite chemist tensor / nk (non-conserving blocks zero), with the
    bra/ket swap symmetry (pq|rs) = (rs|pq) enforced exactly: the grid
    transform breaks it at the aliasing level (~1e-5), and the blocked
    kernels project it out, keeping all paths on one fixed point."""
    kpts = system.kpts
    nk = len(kpts)
    kcons = torch.as_tensor(get_kconserv(system.cell.a, kpts), device=eri7.device)
    n = nk * nmo
    kp, kq, kr = torch.meshgrid(*(torch.arange(nk, device=eri7.device),) * 3,
                                indexing="ij")
    chem = torch.zeros((nk, nmo, nk, nmo, nk, nmo, nk, nmo), dtype=eri7.dtype,
                       device=eri7.device)
    chem[kp, :, kq, :, kr, :, kcons[kp, kq, kr], :] = eri7 / nk
    chem = chem.reshape(n, n, n, n)
    return 0.5 * (chem + chem.permute(2, 3, 0, 1))


def _select4(t, perm):
    for ax in range(4):
        t = t.index_select(ax, perm)
    return t


def build_composite_eris(system, scf_res, device=None):
    """(f_so, eri_so, nocc_so) on the occupied-first composite spin-orbital
    index, on ``device`` (default: the GPU), where ``system`` must live."""
    dev = require_device(system.aoR_k, device)
    mo_c, mo_e, mo_occ = _scf_arrays(scf_res, dev)
    nmo = mo_c[0].shape[1]

    eri7 = fft_ao2mo.ao2mo_7d(system, mo_c, chunk=AO2MO_CHUNK, device=dev)
    chem = _composite_chem(system, eri7, nmo)
    del eri7

    e_flat = mo_e.ravel()
    occ_flat = mo_occ.ravel() > 0.5
    # occupied-first ordering of the composite spatial index (stable, so
    # k-blocks stay contiguous within each half)
    perm = np.argsort(~occ_flat, kind="stable")
    chem = _select4(chem, torch.as_tensor(perm, device=dev))
    e_flat = torch.as_tensor(e_flat[perm], dtype=torch.float64, device=dev)
    nocc_sp = int(occ_flat.sum())

    _, eri_so = gccsd.spinorb_from_spatial(torch.diag(e_flat), chem)
    f_so = torch.diag(e_flat.repeat_interleave(2))
    return f_so, eri_so, 2 * nocc_sp


def composite_h1so(system, scf_res, device=None):
    """Bare core Hamiltonian on the occupied-first composite spin-orbital
    index (momentum-off-diagonal blocks exactly zero), on ``device``
    (default: the GPU): the one-body part of the determinant-space
    EOM-KCCSD (cc/eom.py on composite integrals)."""
    dev = require_device(system.aoR_k, device)
    mo_c, _, mo_occ = _scf_arrays(scf_res, dev)
    nk = len(system.kpts)
    nmo = mo_c[0].shape[1]
    n = nk * nmo
    h1 = torch.zeros((n, n), dtype=torch.complex128, device=dev)
    for k in range(nk):
        c = mo_c[k].to(torch.complex128)
        h1[k * nmo:(k + 1) * nmo, k * nmo:(k + 1) * nmo] = \
            c.conj().T @ system.hcore[k] @ c
    perm = torch.as_tensor(np.argsort(~(mo_occ.ravel() > 0.5), kind="stable"),
                           device=dev)
    h1 = h1[perm][:, perm]
    sp = torch.arange(2 * n, device=dev) // 2
    sz = torch.arange(2 * n, device=dev) % 2
    # supercell normalization: <psi_sc|h|psi_sc> over nk cells is the
    # primitive-cell matrix element, so h1 carries no 1/nk (the ERIs do)
    return h1[sp[:, None], sp[None, :]] * (sz[:, None] == sz[None, :])


def kccsd(system, scf_res, with_t=False, conv_tol=1e-9, max_cycle=100,
          verbose=False, device=None):
    """k-point CCSD correlation energy per unit cell on a converged
    KRHF/KRKS result, on ``device`` (default: the GPU), where ``system``
    must live."""
    nk = len(system.kpts)
    f_so, eri_so, nocc_so = build_composite_eris(system, scf_res, device)
    return _solve(f_so, eri_so, nocc_so, nk, scf_res, with_t, conv_tol,
                  max_cycle, verbose)


def _solve(f_so, eri_so, nocc_so, nk, scf_res, with_t, conv_tol, max_cycle,
           verbose):
    out = gccsd.kernel(f_so, eri_so, nocc_so, conv_tol=conv_tol * nk,
                       max_cycle=max_cycle, verbose=verbose)
    out["e_corr"] = out["e_corr"] / nk
    out["e_hf"] = scf_res["e_tot"]
    out["e_tot"] = scf_res["e_tot"] + out["e_corr"]
    if with_t:
        out["e_t"] = gccsd.ccsd_t(out["t1"], out["t2"], f_so, eri_so,
                                  nocc_so) / nk
        out["e_tot"] += out["e_t"]
    return out


def build_composite_eris_uhf(system, scf_res, device=None):
    """(f_so, eri_so, nocc_so) on the occupied-first composite spin-orbital
    index for a KUHF/KUKS reference (per-spin spatial parts; reference
    pyscf/pbc/cc/kccsd_uhf.py), on ``device`` (default: the GPU).

    Per-k occupation counts may differ (doped or metallic integer fills,
    shifted meshes): the composite index flattens all k, so a per-k
    occupancy flag and one global occupied-first stable sort handle
    non-uniform fills without padding.
    """
    from pyscf_isdf_tpu_torch.device import to_host

    dev = require_device(system.aoR_k, device)
    ca_k, cb_k = ([torch.as_tensor(c, device=dev) for c in cs]
                  for cs in scf_res["mo_coeff"])
    ea_k, eb_k = scf_res["mo_energy"]
    occ_a, occ_b = (np.asarray([to_host(o) for o in occ])
                    for occ in scf_res["mo_occ"])
    nk = len(system.kpts)
    na_k = (occ_a > 0.5).sum(axis=1)
    nb_k = (occ_b > 0.5).sum(axis=1)

    mo_cs, e_so_k, occ_l, sz_l = [], [], [], []
    for k in range(nk):
        C_cat, e_so, sz, nocc_k = gccsd.uhf_spinorb_basis(
            (ca_k[k], cb_k[k]), (ea_k[k], eb_k[k]),
            (int(na_k[k]), int(nb_k[k])))
        mo_cs.append(C_cat)
        e_so_k.append(e_so)
        occ_l.append(np.arange(len(e_so)) < nocc_k)
        sz_l.append(sz)
    nso_k = mo_cs[0].shape[1]

    eri7 = fft_ao2mo.ao2mo_7d(system, mo_cs, chunk=AO2MO_CHUNK, device=dev)
    chem = _composite_chem(system, eri7, nso_k)
    del eri7

    e_flat = torch.cat(e_so_k)
    occ_flat = np.concatenate(occ_l)
    sz_flat = np.concatenate(sz_l)
    perm = np.argsort(~occ_flat, kind="stable")
    chem = _select4(chem, torch.as_tensor(perm, device=dev))
    eri_so = gccsd.antisymmetrize_spin_chem(chem, sz_flat[perm])
    f_so = torch.diag(e_flat[torch.as_tensor(perm, device=dev)])
    return f_so, eri_so, int(occ_flat.sum())


def kuccsd(system, scf_res, with_t=False, conv_tol=1e-9, max_cycle=100,
           verbose=False, device=None):
    """k-point spin-unrestricted CCSD (and optionally (T)) correlation
    energy per unit cell on a converged KUHF/KUKS result: the composite
    dense tier, on ``device`` (default: the GPU), where ``system`` must
    live (reference pyscf/pbc/cc/kccsd_uhf.py)."""
    nk = len(system.kpts)
    f_so, eri_so, nocc_so = build_composite_eris_uhf(system, scf_res, device)
    return _solve(f_so, eri_so, nocc_so, nk, scf_res, with_t, conv_tol,
                  max_cycle, verbose)

"""Carry a built state, given as numpy arrays, into the port's objects.

With these the port's exchange and SCF can run on a factorization or a
system built elsewhere (for example by the JAX reference package), which
sidesteps near-tied interpolation pivots that rounding can reorder.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.df.isdf import ISDF
from pyscf_isdf_tpu_torch.df.isdf_k import ISDFK
from pyscf_isdf_tpu_torch.df.isdf_q import ISDFQ
from pyscf_isdf_tpu_torch.df.isdf_sym import SymISDF
from pyscf_isdf_tpu_torch.scf.hf import SCFSystem
from pyscf_isdf_tpu_torch.scf.khf import KSCFSystem
from pyscf_isdf_tpu_torch.symm import IBZInfo, SpaceGroupOp


def isdf_from_numpy(aoRg, W, ip_idx, Vxi=None, device=None,
                    dtype=torch.float64) -> ISDF:
    """An :class:`ISDF` from (n_ip, nao) aoRg, (n_ip, n_ip) W, (n_ip,)
    grid indices and, for the robust-fit K, (n_ip, ng) Vxi."""
    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device).contiguous()

    return ISDF(aoRg=t(aoRg), W=t(W),
                ip_idx=torch.as_tensor(np.array(ip_idx), dtype=torch.int64,
                                       device=device),
                Vxi=None if Vxi is None else t(Vxi))


def system_from_numpy(cell, S, hcore, X, aoR, coulG, madelung, e_nuc,
                      device=None, dtype=torch.float64) -> SCFSystem:
    """An :class:`SCFSystem` from its numpy fields; mesh, grid weight,
    electron count and G vectors come from ``cell``."""
    device = resolve_device(device)

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.array(a), dtype=dt, device=device).contiguous()

    return SCFSystem(
        cell=cell, S=t(S), hcore=t(hcore), X=t(X), aoR=t(aoR, dtype),
        coulG=t(coulG, dtype), madelung=float(madelung), e_nuc=float(e_nuc),
        mesh=tuple(cell.mesh), weight=cell.grid_weight, nelec=cell.nelectron,
        Gv=t(cell.get_Gv(), dtype),
    )


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device).contiguous()


def kscf_system_from_numpy(cell, kpts, S, hcore, X, aoR_k, coulG, coulG_pairs,
                           expmikr, madelung, e_nuc, device=None) -> KSCFSystem:
    """A :class:`KSCFSystem` from its numpy fields; ``X`` is one (nk, nao,
    nrank) array or a list of per-k (nao, nrank_k) orthogonalizers. Mesh,
    grid weight and electron count come from ``cell``."""
    device = resolve_device(device)
    c128 = torch.complex128
    kpts = np.reshape(np.asarray(kpts, dtype=np.float64), (-1, 3))
    return KSCFSystem(
        cell=cell, kpts=kpts, S=_tensor(S, c128, device),
        hcore=_tensor(hcore, c128, device),
        X=tuple(_tensor(x, c128, device) for x in X),
        aoR_k=_tensor(aoR_k, c128, device),
        coulG=_tensor(coulG, torch.float64, device),
        coulG_pairs=_tensor(coulG_pairs, torch.float64, device),
        expmikr=_tensor(expmikr, c128, device),
        madelung=float(madelung), e_nuc=float(e_nuc), mesh=tuple(cell.mesh),
        weight=cell.grid_weight, nelec_tot=cell.nelectron * len(kpts))


def isdfq_from_numpy(Ag, Wq, qmap, ip_idx, Xq=None, VXq=None, phase_q=None,
                     device=None) -> ISDFQ:
    """An :class:`ISDFQ` from (nk, nip, nao) Ag, (nq, nip, nip) Wq, the
    (nk, nk) q map, the (nip,) grid indices and, for the robust exchange
    and the certificates, (nq, nip, ng) Xq and VXq and (nq, ng) phase_q."""
    device = resolve_device(device)
    c128 = torch.complex128

    def opt(a):
        return None if a is None else _tensor(a, c128, device)

    return ISDFQ(Ag=_tensor(Ag, c128, device), Wq=_tensor(Wq, c128, device),
                 qmap=np.asarray(qmap, dtype=np.int64),
                 ip_idx=_tensor(ip_idx, torch.int64, device),
                 Xq=opt(Xq), VXq=opt(VXq), phase_q=opt(phase_q))


def sym_from_numpy(isdfq: ISDFQ, q_list, kpts, nrep, prim_mesh, coulG_q, Mq,
                   weight) -> SymISDF:
    """A :class:`SymISDF` around a per-q factorization (for example one
    from :func:`isdfq_from_numpy`), on its device."""
    return SymISDF(isdfq=isdfq, q_list=np.asarray(q_list),
                   kpts=np.reshape(np.asarray(kpts), (-1, 3)),
                   nrep=tuple(int(n) for n in nrep),
                   prim_mesh=tuple(int(n) for n in prim_mesh),
                   coulG_q=np.asarray(coulG_q, dtype=np.float64),
                   Mq=_tensor(Mq, torch.complex128, isdfq.Ag.device),
                   weight=float(weight))


def isdfk_from_numpy(Ug, Wq, qmap, ip_idx, xi=None, device=None) -> ISDFK:
    """An :class:`ISDFK` from (nk, nip, nao) Ug, (nq, nip, nip) Wq, the
    (nk, nk) q map, the (nip,) grid indices and, for
    :func:`~pyscf_isdf_tpu_torch.df.isdf_k.w_phased`, the real (nip, ng)
    interpolation vectors xi."""
    device = resolve_device(device)
    c128 = torch.complex128
    return ISDFK(Ug=_tensor(Ug, c128, device), Wq=_tensor(Wq, c128, device),
                 qmap=np.asarray(qmap, dtype=np.int64),
                 ip_idx=_tensor(ip_idx, torch.int64, device),
                 xi=None if xi is None else _tensor(xi, torch.float64, device))


def ibz_from_numpy(info) -> IBZInfo:
    """An :class:`~pyscf_isdf_tpu_torch.symm.IBZInfo` with the fields of
    ``info`` (an IBZ reduction built elsewhere, for example by the JAX
    reference package), as numpy arrays."""
    ops = tuple(SpaceGroupOp(R=np.array(op.R, dtype=np.float64),
                             t=np.array(op.t, dtype=np.float64),
                             perm=np.array(op.perm, dtype=np.int64),
                             W=np.array(op.W))
                for op in info.ops)
    return IBZInfo(kpts=np.array(info.kpts, dtype=np.float64),
                   ibz_idx=np.array(info.ibz_idx, dtype=np.int64),
                   weights=np.array(info.weights, dtype=np.float64),
                   bz2ibz=np.array(info.bz2ibz, dtype=np.int64),
                   op_idx=np.array(info.op_idx, dtype=np.int64),
                   tr=np.array(info.tr, dtype=bool), ops=ops)


def _nested(a, dtype, device):
    if isinstance(a, (list, tuple)):
        return [_nested(x, dtype, device) for x in a]
    return _tensor(a, dtype, device)


def lmo_from_numpy(Lmo, device=None):
    """A GW input's MO-basis fit tensor on ``device``: one (naux, nmo, nmo)
    float64 array at Gamma, or the nested Lmo[k1][k2] complex arrays of
    the k-point tensors (as lists of tensors)."""
    device = resolve_device(device)
    if isinstance(Lmo, (list, tuple)):
        return _nested(Lmo, torch.complex128, device)
    return _tensor(Lmo, torch.float64, device)


def scf_result_from_numpy(res, device=None) -> dict:
    """An SCF result (for example the reference package's, or one moved
    off another device) with its orbital fields as tensors on ``device``:
    mo_coeff, mo_energy and mo_occ, nested in the per-spin tuples and
    per-k lists of the open-shell and k-point results, keep their nesting;
    e_tot, nelec and every other field pass through."""
    device = resolve_device(device)

    def t(a):
        if isinstance(a, tuple):
            return tuple(t(x) for x in a)
        if isinstance(a, list):
            return [t(x) for x in a]
        if a is None:
            return None
        a = a if torch.is_tensor(a) else torch.as_tensor(np.array(a))
        return a.to(device)

    return {k: (t(v) if k in ("mo_coeff", "mo_energy", "mo_occ") else v)
            for k, v in res.items()}

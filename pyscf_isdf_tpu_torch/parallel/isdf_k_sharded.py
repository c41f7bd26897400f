"""Multi-rank k-point ISDF build and k-sampled SCF step (grid split).

The per-q W build of ``df/isdf_k.py`` over the ranks:

  * the k-stacked periodic-part matrix U (ng, nk*nao) is row-split into
    x-slabs;
  * the interpolation points come from the SPMD greedy pivoted Cholesky of
    ``parallel/isdf_sharded.py`` (``_select_ips_local``) on the complex pair Gram
    Z[g,g'] = |sum_a U[g,a] conj(U[g',a])|^2 (one all_gather a pivot);
  * the xi columns are local Cholesky solves against the replicated IP Gram;
  * every W_q goes through the distributed 3-D FFT with the q-kernel in the
    transposed layout, summed by one all_reduce a q.

The k-point SCF step (:func:`make_kscf_step`) splits the grid axis of
aoR_k for the J and Vxc quadrature (distributed Poisson, summed over the
ranks) and keeps exchange as replicated n_IP GEMMs through the ISDFK
factors, as ``parallel/scf_step.py`` does at Gamma.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.df.isdf_k import ISDFK, unique_q
from pyscf_isdf_tpu_torch.ops import coulomb
from pyscf_isdf_tpu_torch.parallel import distributed_fft as dfft
from pyscf_isdf_tpu_torch.parallel.isdf_sharded import _select_ips_local
from pyscf_isdf_tpu_torch.parallel.mesh import slab_rows
from pyscf_isdf_tpu_torch.parallel.scf_step import lda_spec
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def build_isdf_k_sharded(dev_mesh, cell, aoR_k, kpts, n_ip=None,
                         c: float = 8.0, fft_chunk: int = 128, timer=None) -> ISDFK:
    """Multi-rank k-point ISDF build; returns the replicated :class:`ISDFK`.

    Args:
        dev_mesh: this rank's :class:`~pyscf_isdf_tpu_torch.parallel.mesh.RankGroup`.
        aoR_k: (nk, ngrids / P, nao) complex Bloch AO values on this rank's
            x-slab (:func:`~pyscf_isdf_tpu_torch.parallel.mesh.slab_rows`).
        kpts: (nk, 3).
        n_ip: interpolation points (default c * nao * nk).
        fft_chunk: interpolation vectors a distributed FFT (the unsplit
            build's 128: a smaller chunk multiplies the small transposes,
            16 costs 22 s in the W stage at nk 27 on the H100).
        timer: optional stage timer; records 'select', 'xi' and 'w'.
    The q classes are those of :func:`~pyscf_isdf_tpu_torch.df.isdf_k.unique_q`
    and the kernels have no G = 0 correction (exxdiv None).
    """
    grp = dev_mesh
    timer = timer or null_timer
    kpts = np.reshape(np.asarray(kpts), (-1, 3))
    nk, ngl, nao = aoR_k.shape
    mesh3 = tuple(cell.mesh)
    rows = slab_rows(mesh3, grp.rank, grp.world)
    if n_ip is None:
        n_ip = int(c * nao * nk)
    n_ip = min(n_ip, ngl * grp.world)
    weight = cell.grid_weight
    dev = aoR_k.device
    rdt = torch.float64 if aoR_k.dtype == torch.complex128 else torch.float32

    coords = torch.as_tensor(cell.uniform_grid()[rows], dtype=rdt, device=dev)
    kt = torch.as_tensor(kpts, dtype=rdt, device=dev)
    phases = torch.exp(-1j * (coords @ kt.T)).to(aoR_k.dtype)   # (ngl, nk)
    U_l = (aoR_k * phases.T[:, :, None]).transpose(0, 1).reshape(ngl, nk * nao)

    q_list, qmap = unique_q(cell, kpts)
    coulG_q_t_l = torch.stack([
        dfft.coulG_transposed_layout(torch.as_tensor(
            coulomb.get_coulG(cell, k=q, exxdiv=None, kpts=kpts), dtype=rdt,
            device=dev), mesh3)[rows]
        for q in q_list])

    with timer("select"):
        Ug, owners, locs = _select_ips_local(U_l, n_ip, grp)
    with timer("xi"):
        # xi columns: local solve against the replicated IP Gram
        R1 = Ug @ Ug.conj().T
        C1 = (R1 * R1.conj()).real
        is_f64 = C1.dtype == torch.float64
        eps = 1e-12 * torch.trace(C1) / n_ip if is_f64 else 3e-7 * torch.trace(C1)
        cho = torch.linalg.cholesky(
            C1 + eps * torch.eye(n_ip, dtype=C1.dtype, device=dev))
        R2 = U_l @ Ug.conj().T                              # (ngl, nip)
        xi_c = torch.cholesky_solve((R2 * R2.conj()).real.T, cho).to(U_l.dtype)
        del R2
    with timer("w"):
        Wq = torch.empty((len(q_list), n_ip, n_ip), dtype=U_l.dtype, device=dev)
        for iq, cq_t_l in enumerate(coulG_q_t_l):
            for i0 in range(0, n_ip, fft_chunk):
                v = dfft.poisson_slab_c(xi_c[i0:i0 + fft_chunk], cq_t_l, mesh3, grp)
                Wq[iq, :, i0:i0 + fft_chunk] = xi_c @ v.T
        Wq = grp.all_reduce(weight * Wq)
        Wq = 0.5 * (Wq + Wq.conj().transpose(1, 2))

    glob = grp.all_reduce(torch.where(locs >= 0, owners * ngl + locs,
                                      torch.zeros_like(locs)))
    Ug = Ug.reshape(n_ip, nk, nao).transpose(0, 1)          # (nk, nip, nao)
    return ISDFK(Ug=Ug, Wq=Wq, qmap=qmap, ip_idx=glob, xi=None)


def make_kscf_step(dev_mesh, mesh3, weight, nk, nocc_tot,
                   xc: str | None = None, exxdiv_madelung: float = 0.0):
    """One rank's split k-point SCF iteration (KRHF / KRKS-LDA).

    Returns ``step(dm_k, aoR_k, coulG_t, isdfk, hcore_k, X_k, S_k)
    -> (dm_new_k, e_elec)`` with ``aoR_k`` this rank's slab (nk, ngrids / P,
    nao) and ``coulG_t`` its slab of the transposed-layout kernel. Exchange
    goes through replicated per-q ISDF GEMMs; the occupations are the
    exact-count fill across k (the ``nocc_tot`` lowest levels of every k
    together, 2 electrons each: a threshold fill would overfill a
    degenerate Fermi level and converge a wrong-charge state). ``X_k``
    (nk, nao, nao) must be full-rank.
    """
    grp = dev_mesh
    mesh3 = tuple(mesh3)
    xcspec = lda_spec(xc)
    hyb = 1.0 if xcspec is None else xcspec.hyb

    def grid_part(aoR_k_l, coulG_t_l, dm_k):
        t = torch.einsum("kgi,kij->kgj", aoR_k_l, dm_k)
        rho_l = torch.einsum("kgj,kgj->g", t, aoR_k_l.conj()).real / nk
        vR_l = dfft.poisson_slab(rho_l, coulG_t_l, mesh3, grp)
        vj = weight * torch.einsum("kgi,g,kgj->kij", aoR_k_l.conj(),
                                   vR_l.to(aoR_k_l.dtype), aoR_k_l)
        if xcspec is not None:
            rho_s = torch.clamp(rho_l, min=1e-30)
            exc, vrho, _ = xcspec.exc_vxc(rho_s)
            e_xc = weight * (rho_s * exc).sum()
            vxc = weight * torch.einsum("kgi,g,kgj->kij", aoR_k_l.conj(),
                                        vrho.to(aoR_k_l.dtype), aoR_k_l)
        else:
            e_xc = torch.zeros((), dtype=rho_l.dtype, device=rho_l.device)
            vxc = torch.zeros_like(vj)
        flat = grp.all_reduce(torch.cat([vj.reshape(-1), vxc.reshape(-1),
                                         e_xc.to(vj.dtype)[None]]))
        n = vj.numel()
        return (flat[:n].reshape(vj.shape), flat[n:2 * n].reshape(vj.shape),
                flat[-1].real)

    def step(dm_k, aoR_k, coulG_t, isdfk, hcore_k, X_k, S_k):
        cdtype = aoR_k.dtype
        vj, vxc, e_xc = grid_part(aoR_k, coulG_t, dm_k)
        veff = vj + vxc
        e_k = torch.zeros((), dtype=e_xc.dtype, device=e_xc.device)
        if hyb > 0:
            Ug, Wq, qmap = isdfk.Ug, isdfk.Wq, isdfk.qmap
            M_all = Ug @ dm_k.to(cdtype) @ Ug.conj().transpose(1, 2)
            vk = []
            for k1 in range(nk):
                acc = torch.zeros((Ug.shape[2], Ug.shape[2]), dtype=cdtype,
                                  device=Ug.device)
                for k2 in range(nk):
                    W = Wq[int(qmap[k2, k1])]
                    acc = acc + Ug[k1].conj().T @ (M_all[k2] * W.conj()) @ Ug[k1]
                vk.append(acc / nk)
            vk = torch.stack(vk)
            vk = vk + exxdiv_madelung * (S_k @ dm_k @ S_k)
            veff = veff - 0.5 * hyb * vk
            e_k = -0.25 * hyb * torch.einsum("kij,kji->", dm_k, vk).real / nk
        F = hcore_k + veff
        e, u = torch.linalg.eigh(X_k.conj().transpose(1, 2) @ F @ X_k)
        C = X_k @ u
        # exact-count fill over every k together
        order = torch.argsort(e.reshape(-1), stable=True)
        occ = torch.zeros(e.numel(), dtype=e.dtype, device=e.device)
        occ[order[:nocc_tot]] = 2.0
        occ = occ.reshape(e.shape)
        dm_new = torch.einsum("kim,km,kjm->kij", C, occ.to(cdtype), C.conj())
        e_elec = (torch.einsum("kij,kji->", dm_k, hcore_k).real / nk
                  + 0.5 * torch.einsum("kij,kji->", dm_k, vj).real / nk
                  + e_xc + e_k)
        return dm_new, e_elec

    return step

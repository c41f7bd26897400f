"""k-point generalized Hartree-Fock (KGHF): 2-component spinor orbitals
(torch).

Reference semantics: pyscf/pbc/scf/kghf.py — each k-point carries
(2 nao)-dimensional spinor MOs; the density matrix has the four spin
blocks [[aa, ab], [ba, bb]]. Without spin-orbit terms the Hamiltonian is
spin-diagonal:

  * hcore and overlap: block_diag(h_k, h_k), block_diag(S_k, S_k), as
    (nk, 2 nao, 2 nao) tensors;
  * J from the charge density D_aa + D_bb on both spin diagonals;
  * K acts on each of the four spin blocks, the off-diagonal ones not
    Hermitian: both k-point engines are complex-linear in the density, so
    the KRHF exchange serves every block;
  * 'ewald': the Madelung shift with the spinor overlap, m S D S per k;
  * occupations: one electron per spinor orbital, filled across k by
    exact count (the spin-free spinor spectrum is twice degenerate).

UHF (collinear) and KRHF (closed shell) are exact special cases. J, K,
the eigensolves and DIIS's extrapolation run on the system's device.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df import fftdf_k
from pyscf_isdf_tpu_torch.scf.diis import DIIS
from pyscf_isdf_tpu_torch.scf.khf import KSCFSystem, _eig_all, exchange_engines_k
from pyscf_isdf_tpu_torch.scf.occupations import exact_count_occ
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def _spinor(mat_k):
    """block_diag(M_k, M_k) for a (nk, n, m) stack: (nk, 2n, 2m)."""
    nk, n, m = mat_k.shape
    out = mat_k.new_zeros((nk, 2 * n, 2 * m))
    out[:, :n, :m] = mat_k
    out[:, n:, m:] = mat_k
    return out


def kghf_kernel(
    system: KSCFSystem,
    exxdiv: str = "ewald",
    max_cycle: int = 80,
    conv_tol: float = 1e-10,
    diis_space: int = 8,
    dm0=None,
    df: str = "fftdf",
    isdf_c: float = 8.0,
    verbose: bool = False,
    device=None,
    timer=None,
):
    """Run k-point GHF to convergence on ``device`` (default: the GPU),
    where ``system`` must have been built.

    Args:
        system: KSCFSystem (spatial AO quantities; the spinor structure is
            assembled here).
        dm0: optional (nk, 2nao, 2nao) spinor density start (a collinear
            KUHF density in the diagonal blocks, or a non-collinear one);
            default the core Hamiltonian's filling.
        df: 'fftdf' (exact pair-density FFT exchange) or 'isdf' (the
            shared-xi k-point ISDF factorization, one W per q for all four
            blocks).
        timer: optional StageTimer; records each iteration as 'cycle' and
            within it the four blocks' exchange as 'K'.

    Returns a dict with e_tot (per cell), mo_energy and mo_coeff (per-k
    spinor tensor lists), mo_occ (per-k numpy arrays), dm (nk, 2nao,
    2nao), spin (<Sx>, <Sy>, <Sz>) per cell, converged and niter.
    """
    if df not in ("fftdf", "isdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'fftdf' or 'isdf'")
    if exxdiv not in (None, "ewald"):
        raise NotImplementedError(f"exxdiv={exxdiv!r} with k-points")
    device = require_device(system.aoR_k, device)
    timer = timer or null_timer
    nk = len(system.kpts)
    aoR_k, mesh, weight = system.aoR_k, system.mesh, system.weight
    nao = system.S.shape[-1]
    nelec = system.nelec_tot        # one electron per occupied spinor orbital

    S_sp = _spinor(system.S)
    h_sp = _spinor(system.hcore)
    X_sp = tuple(_spinor(x[None])[0] for x in system.X)
    get_k_block = exchange_engines_k(system, df, isdf_c)[0]

    def get_jk(dm):
        blocks = (dm[:, :nao, :nao], dm[:, :nao, nao:], dm[:, nao:, :nao],
                  dm[:, nao:, nao:])
        vj = _spinor(fftdf_k.get_j_kpts(aoR_k, blocks[0] + blocks[3], system.coulG,
                                        mesh, weight))
        with timer("K"):
            kb = [get_k_block(b.contiguous()) for b in blocks]
        vk = torch.cat([torch.cat(kb[:2], 2), torch.cat(kb[2:], 2)], 1)
        if exxdiv == "ewald":
            vk = vk + system.madelung * (S_sp @ dm @ S_sp)
        return vj, vk

    def occupations(mo_e):
        flat = torch.cat(mo_e).cpu().numpy()
        return exact_count_occ(np.split(flat, np.cumsum([len(e) for e in mo_e])[:-1]),
                               nelec, scale=1.0)

    def make_dm(mo_c, occs):
        return torch.stack([
            (c * torch.as_tensor(o, dtype=c.dtype, device=device)) @ c.conj().T
            for c, o in zip(mo_c, occs)])

    if dm0 is None:
        mo_e, mo_c = _eig_all(h_sp, X_sp)
        dm = make_dm(mo_c, occupations(mo_e))
    else:
        dm = torch.as_tensor(dm0, device=device).to(torch.complex128)

    diis = DIIS(space=diis_space)
    e_last = 0.0
    conv = False
    for it in range(max_cycle):
        with timer("cycle"):
            vj, vk = get_jk(dm)
            F = h_sp + vj - vk
            err = S_sp @ dm @ F - F @ dm @ S_sp
            F = diis.update(F, err)
            mo_e, mo_c = _eig_all(F, X_sp)
            occs = occupations(mo_e)
            dm_new = make_dm(mo_c, occs)
            e_elec = torch.einsum("kij,kji->", dm, h_sp + 0.5 * (vj - vk)).real
            e_tot = float(e_elec) / nk + system.e_nuc
            de = abs(e_tot - e_last)
            err_norm = float(torch.linalg.norm(err)) / err.numel() ** 0.5
            if verbose:
                print(f"KGHF cycle {it:3d}  E = {e_tot:.12f}  dE = {de:.2e}")
            dm = dm_new
            if de < conv_tol and err_norm < np.sqrt(conv_tol):
                conv = True
                break
            e_last = e_tot

    # <S> = 1/2 sum_k tr(sigma . D_k S_k) / nk
    dS = dm @ S_sp
    p_ab = torch.diagonal(dS[:, :nao, nao:], dim1=1, dim2=2).sum()
    p_ba = torch.diagonal(dS[:, nao:, :nao], dim1=1, dim2=2).sum()
    p_aa = torch.diagonal(dS[:, :nao, :nao], dim1=1, dim2=2).sum()
    p_bb = torch.diagonal(dS[:, nao:, nao:], dim1=1, dim2=2).sum()
    spin = (float(0.5 * (p_ab + p_ba).real) / nk,
            float(0.5 * (1j * (p_ab - p_ba)).real) / nk,
            float(0.5 * (p_aa - p_bb).real) / nk)
    return {
        "e_tot": e_tot,
        "mo_energy": mo_e,
        "mo_coeff": mo_c,
        "mo_occ": occs,
        "dm": dm,
        "converged": conv,
        "niter": it + 1,
        "spin": spin,
    }

"""GTH pseudopotential matrix elements on the FFT mesh (float64).

Implements the Goedecker-Teter-Hutter PP exactly in the FFTDF formulation the
reference uses for grid methods:

  * local part in G-space: erf-screened Coulomb + C1..C4 Gaussian-polynomial
    terms (reference: pyscf/pbc/gto/pseudo/pp.py:58-94 and
    pp_int.py:get_gth_vlocG_part1),
  * G=0 'alpha' convention folding the divergent Hartree+Vloc G=0 terms
    (pp.py:33-46, fft.py:64-98),
  * separable nonlocal projectors p_i^l(G) with the HGH q_li radial forms
    (pp.py:107-194) contracted against analytic AO transforms (pp.py:246-287).

The local potential is built on the host in numpy; the matrix elements
against ``aoR`` and the nonlocal projector sums run in torch on the
device of ``aoR``.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.ops.solid_harmonics import solid_harmonics

SQRT = np.sqrt


def gth_vlocG(cell, Gv: np.ndarray) -> np.ndarray:
    """(natm, ngrids) local PP v_loc(G) (positive-kernel convention).

    Erf-screened Coulomb with the -2 pi Z rloc^2 G=0 convention; a slab
    (dimension 2) takes the Minary-Tuckerman slab summation (reference:
    pyscf/pbc/gto/pseudo/pp_int.py:77-113).
    """
    G2 = np.einsum("gi,gi->g", Gv, Gv)
    G0 = G2 == 0
    if cell.dimension == 2:
        return _gth_vlocG_slab(cell, Gv, G2, G0)
    vlocG = np.zeros((cell.natm, len(G2)))
    with np.errstate(divide="ignore"):
        coulG = 4 * np.pi / G2
    coulG[G0] = 0.0
    for ia in range(cell.natm):
        Zia = cell.charges[ia]
        vlocG[ia] = Zia * coulG
        pp = cell.pseudos.get(cell.symbols[ia])
        if pp is None:
            continue
        rloc = pp.rloc
        vlocG[ia] *= np.exp(-0.5 * rloc**2 * G2)
        vlocG[ia, G0] = -2 * np.pi * Zia * rloc**2
        vlocG[ia] -= _gth_c_terms(pp, G2)
    return vlocG


def _gth_vlocG_slab(cell, Gv, G2, G0):
    """The slab's local PP: the erf-screened charge against the slab-
    truncated kernel, summed in closed form along the normal."""
    from scipy.special import erf, erfc, erfcx

    from pyscf_isdf_tpu_torch.ops import coulomb as _coul

    vlocG = np.zeros((cell.natm, len(G2)))
    coulG = _coul.get_coulG(cell, Gv=Gv)
    b = cell.reciprocal_vectors()
    inv_area = np.linalg.norm(np.cross(b[0], b[1])) / (2 * np.pi) ** 2
    lzd2 = cell.vol * inv_area / 2
    lz = lzd2 * 2.0
    G2s = np.where(G0, 1e200, G2)
    Gxy = np.linalg.norm(Gv[:, :2], axis=1)
    Gz = np.abs(Gv[:, 2])
    for ia in range(cell.natm):
        Zia = cell.charges[ia]
        pp = cell.pseudos.get(cell.symbols[ia])
        if pp is None:
            vlocG[ia] = Zia * coulG
            continue
        rloc = pp.rloc
        ew_eta = 1.0 / np.sqrt(2) / rloc
        JexpG2 = 4 * np.pi / G2s * np.exp(-G2s / (4 * ew_eta**2))
        fac = 4 * np.pi / G2s * np.cos(Gz * lzd2)
        JexpG2 -= fac * np.exp(-Gxy * lzd2)
        eta_z1 = (ew_eta**2 * lz + Gxy) / (2.0 * ew_eta)
        eta_z2 = (ew_eta**2 * lz - Gxy) / (2.0 * ew_eta)
        JexpG2 += fac * 0.5 * (np.exp(-eta_z1**2) * erfcx(eta_z2)
                               + np.exp(-eta_z2**2) * erfcx(eta_z1))
        vlocG[ia] = Zia * JexpG2
        JexpG0 = (-np.pi * lz**2 / 2.0 * erf(ew_eta * lzd2)
                  + np.pi / ew_eta**2 * erfc(ew_eta * lzd2)
                  - np.sqrt(np.pi) * lz / ew_eta * np.exp(-((ew_eta * lzd2) ** 2)))
        vlocG[ia, G0] = -2 * np.pi * Zia * rloc**2 + Zia * JexpG0
        vlocG[ia] -= _gth_c_terms(pp, G2)
    return vlocG


def _gth_c_terms(pp, G2):
    """The C1..C4 Gaussian-polynomial part of the GTH local potential."""
    rloc = pp.rloc
    G2_red = G2 * rloc**2
    cexp = pp.cexp
    cfacs = 0.0
    if len(cexp) >= 1:
        cfacs = cfacs + cexp[0]
    if len(cexp) >= 2:
        cfacs = cfacs + cexp[1] * (3 - G2_red)
    if len(cexp) >= 3:
        cfacs = cfacs + cexp[2] * (15 - 10 * G2_red + G2_red**2)
    if len(cexp) >= 4:
        cfacs = cfacs + cexp[3] * (105 - 105 * G2_red + 21 * G2_red**2 - G2_red**3)
    return (2 * np.pi) ** 1.5 * rloc**3 * np.exp(-0.5 * G2_red) * cfacs


def gth_alphas(cell) -> np.ndarray:
    """Non-divergent Hartree+Vloc G=0 coefficients, -v_loc(G=0) per atom."""
    return -gth_vlocG(cell, np.zeros((1, 3)))[:, 0]


def _qli(x, l: int, i: int):
    """HGH radial projector form factors q_{li}(G r_l) (PRB 58, 3641)."""
    if l == 0 and i == 0:
        return 4 * SQRT(2.0) * (0.0 * x + 1.0)
    if l == 0 and i == 1:
        return 8 * SQRT(2 / 15.0) * (3 - x**2)
    if l == 0 and i == 2:
        return 16.0 / 3 * SQRT(2 / 105.0) * (15 - 10 * x**2 + x**4)
    if l == 1 and i == 0:
        return 8 * SQRT(1 / 3.0) * (0.0 * x + 1.0)
    if l == 1 and i == 1:
        return 16 * SQRT(1 / 105.0) * (5 - x**2)
    if l == 1 and i == 2:
        return 32.0 / 3 * SQRT(1 / 1155.0) * (35 - 14 * x**2 + x**4)
    if l == 2 and i == 0:
        return 8 * SQRT(2 / 15.0) * (0.0 * x + 1.0)
    if l == 2 and i == 1:
        return 16.0 / 3 * SQRT(2 / 105.0) * (7 - x**2)
    if l == 2 and i == 2:
        return 32.0 / 3 * SQRT(2 / 15015.0) * (63 - 18 * x**2 + x**4)
    if l == 3 and i == 0:
        return 16 * SQRT(1 / 105.0) * (0.0 * x + 1.0)
    if l == 3 and i == 1:
        return 32.0 / 3 * SQRT(1 / 1155.0) * (9 - x**2)
    if l == 3 and i == 2:
        return 64.0 / 45 * SQRT(1 / 1001.0) * (99 - 22 * x**2 + x**4)
    raise NotImplementedError(f"GTH nonlocal projector l={l}, i={i}")


def _potential_matrix(aoR: torch.Tensor, vR: np.ndarray) -> torch.Tensor:
    """Grid quadrature ao^H diag(vR) ao (ifft's 1/N carries the weight)."""
    v = torch.as_tensor(vR, dtype=aoR.real.dtype, device=aoR.device)
    return (aoR.conj().T * v) @ aoR


def vpploc_real(cell, mesh=None, Gv=None) -> np.ndarray:
    """The local-PP potential on the grid, (ngrids,) numpy: the ifft of
    -sum_atoms SI * vlocG with the G=0 alpha convention."""
    mesh = mesh or cell.mesh
    if Gv is None:
        Gv = cell.get_Gv(mesh)
    SI = cell.get_SI(Gv=Gv)
    vpplocG = -np.sum(SI * gth_vlocG(cell, Gv), axis=0)
    vpplocG[0] = np.sum(gth_alphas(cell))
    return np.fft.ifftn(vpplocG.reshape(mesh)).real.ravel()


def get_vpploc(cell, aoR: torch.Tensor, mesh=None, Gv=None):
    """Local-PP matrix and the real-space potential it integrates:
    (vpploc (nao,nao) tensor, vpplocR (ngrids,) numpy)."""
    vpplocR = vpploc_real(cell, mesh, Gv)
    return _potential_matrix(aoR, vpplocR), vpplocR


def get_vppnl(cell, mesh=None, kpt=None, device=None, pp_coords=None) -> torch.Tensor:
    """Nonlocal separable PP matrix: sum_a,l,ij <ao|p_i^lm> h_ij <p_j^lm|ao>.

    Uses the analytic (alias-free) AO Fourier transform, matching the
    reference's FFTDF.get_pp (pyscf/pbc/df/fft.py:87-145); overall scale
    1/vol with aokG carrying (1/vol)^(1/2). Real at Gamma, complex128 at a
    k-point ``kpt`` (projectors at k+G, structure factor at G).

    ``pp_coords`` (natm, 3) optionally places the projectors at other
    centres than the cell's atoms (the AOs still follow ``cell.coords``):
    the matrix of the frozen central projectors in a displaced basis that
    the electron-phonon correction needs (eph/eph_fd.py).
    """
    from pyscf_isdf_tpu_torch.ops.ft_ao import ft_ao

    mesh = mesh or cell.mesh
    Gv_np = cell.get_Gv(mesh)
    aokG = ft_ao(cell, Gv_np, kpt=kpt, device=device) * (1.0 / cell.vol) ** 0.5
    device = aokG.device
    Gv = torch.as_tensor(Gv_np, device=device)
    Gk = Gv if kpt is None else Gv + torch.as_tensor(kpt, dtype=Gv.dtype,
                                                     device=device)
    G_rad = torch.linalg.norm(Gk, dim=1)
    coords = torch.as_tensor(cell.coords if pp_coords is None else pp_coords,
                             dtype=torch.float64, device=device)
    nao = cell.nao
    vppnl = torch.zeros((nao, nao), dtype=torch.complex128, device=device)
    for ia in range(cell.natm):
        pp = cell.pseudos.get(cell.symbols[ia])
        if pp is None:
            continue
        SI_conj = torch.exp(1j * (Gv @ coords[ia]))                    # (ng,)
        for l, (rl, h) in enumerate(zip(pp.proj_rl, pp.proj_h)):
            nl = len(h)
            if nl == 0:
                continue
            hl = torch.as_tensor(np.asarray(h), dtype=torch.complex128,
                                 device=device)
            # pYlm[i, m, g] = q_li(G rl) rl^{l+3/2} pi^{5/4} e^{-(G rl)^2/2} S_lm(G)
            ang = solid_harmonics(l, Gk, torch)                        # (ng, 2l+1)
            radial = rl ** (l + 1.5) * np.pi**1.25 \
                * torch.exp(-0.5 * (G_rad * rl) ** 2)
            pYlm = torch.stack([(ang * (radial * _qli(G_rad * rl, l, i))[:, None]).T
                                for i in range(nl)])                   # (nl, m, ng)
            SPG_lm_aoG = torch.einsum("img,gp->imp", SI_conj * pYlm, aokG)
            tmp = torch.einsum("ij,jmp->imp", hl, SPG_lm_aoG)
            vppnl += torch.einsum("imp,imq->pq", SPG_lm_aoG.conj(), tmp)
    vppnl = vppnl / cell.vol
    if kpt is None or np.allclose(kpt, 0):
        return vppnl.real
    return vppnl


def vnuc_real(cell, mesh=None) -> np.ndarray:
    """The all-electron nuclear potential on the grid, (ngrids,) numpy,
    by the structure-factor route (reference: pyscf/pbc/df/fft.py:39-62)."""
    from pyscf_isdf_tpu_torch.ops import coulomb as _coul

    mesh = mesh or cell.mesh
    Gv = cell.get_Gv(mesh)
    SI = cell.get_SI(Gv=Gv)
    coulG = _coul.get_coulG(cell, mesh=mesh, Gv=Gv)
    rhoG = (-cell.charges) @ SI
    return np.fft.ifftn((rhoG * coulG).reshape(mesh)).real.ravel()


def get_nuc(cell, aoR: torch.Tensor, mesh=None) -> torch.Tensor:
    """All-electron nuclear attraction matrix (:func:`vnuc_real` by grid
    quadrature)."""
    return _potential_matrix(aoR, vnuc_real(cell, mesh))


def get_pp(cell, aoR: torch.Tensor, mesh=None) -> torch.Tensor:
    """Full pseudopotential matrix: local (grid quadrature) + nonlocal
    (analytic FT), on the device of ``aoR``."""
    vloc, _ = get_vpploc(cell, aoR, mesh)
    return vloc + get_vppnl(cell, mesh, device=aoR.device)

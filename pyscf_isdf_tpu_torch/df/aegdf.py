"""All-electron Gaussian density fitting by range separation (analytic).

The uniform-mesh collocation engines (FFTDF, ISDF, grid GDF) cannot
resolve deep-core basis functions: the mesh grows like ke ~ 74 a_max.
This module is the mesh-free path of the JAX package's ``df/aegdf.py``
(the regime the reference covers with analytic-integral GDF,
pyscf/pbc/df/df.py:127):

    1/r = erfc(w r)/r + erf(w r)/r

* short range (erfc): decays like a Gaussian of range 1/w whatever the
  basis, so the real-space lattice sums converge in a few image shells,
  computed analytically by the McMurchie-Davidson engine
  (:mod:`~pyscf_isdf_tpu_torch.ops.md_int`, host float64);
* long range (erf): the Fourier kernel v_lr(G) = 4 pi/G^2 exp(-G^2/(4 w^2))
  dies at |G| ~ 2 w sqrt(ln 1/eps) whatever the exponents, a small
  G-sphere sum over analytic AO transforms, contracted on the device.

G = 0 convention: every reciprocal sum drops G = 0 (the exxdiv=None
kernel convention of the grid engines). The real-space SR sums contain
their G = 0 component v_sr(0) = pi/w^2, subtracted analytically:

    j2c[P,Q] -= pi/(w^2 vol) q_P q_Q          (q_P = int chi_P)
    j3c[P,mn] -= pi/(w^2 vol) q_P S_mn
    vne[mn]  += pi Z_tot/(w^2 vol) S_mn

The split is exact (results are w-independent), and 0-dimension cells
(omega=None, direct 1/r real-space sums) give molecular integrals.
The auxiliary basis is the shared even-tempered expansion
(:func:`~pyscf_isdf_tpu_torch.df.gdf.make_auxcell`). The fit tensors and
core Hamiltonians land on the device as float64/complex128 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.df.gdf import GDF, KGDF, get_jk_cd, make_auxcell
from pyscf_isdf_tpu_torch.ops import ft_ao, md_int, md_int_k

__all__ = ["build_ae_gdf", "ae_hcore", "aehf_kernel", "lr_gvectors",
           "build_ae_gdf_kpts", "ae_hcore_kpts", "aekhf_kernel"]


def lr_gvectors(cell, omega: float, tol: float = 1e-14) -> np.ndarray:
    """All reciprocal vectors 0 < |G| <= Gmax with
    exp(-Gmax^2/(4 w^2)) = tol, the long-range kernel's support."""
    return lr_gvectors_q(cell, np.zeros(3), omega, tol)


def lr_gvectors_q(cell, q, omega: float, tol: float = 1e-14) -> np.ndarray:
    """Reciprocal vectors G with 0 < |q+G| <= Gmax (the |q+G| ~ 0
    exclusion only triggers for q in the reciprocal lattice)."""
    gmax = 2.0 * omega * np.sqrt(np.log(1.0 / tol))
    b = cell.reciprocal_vectors()
    q = np.asarray(q, float)
    nmax = np.ceil((gmax + np.linalg.norm(q))
                   * np.linalg.norm(np.linalg.inv(b), axis=0)).astype(int)
    m = np.stack(np.meshgrid(*[np.arange(-n, n + 1) for n in nmax],
                             indexing="ij"), -1).reshape(-1, 3)
    Gv = m @ b
    qG2 = np.einsum("gi,gi->g", Gv + q, Gv + q)
    return Gv[(qG2 > 1e-12) & (qG2 <= gmax * gmax)]


def _vlr(Gv, omega):
    g2 = np.einsum("gi,gi->g", Gv, Gv)
    return 4.0 * np.pi / g2 * np.exp(-g2 / (4.0 * omega * omega))


def _c128(a, device):
    return torch.as_tensor(np.asarray(a), device=device).to(torch.complex128)


def _whitening(j2c, lindep):
    """(nkeep, naux) diag(w^-1/2) U^H over the eigenpairs of the metric
    above lindep * max."""
    w, U = torch.linalg.eigh(j2c)
    keep = w > w.max() * lindep
    return (U[:, keep] / torch.sqrt(w[keep])).conj().T


def build_ae_gdf(cell, omega: float = 0.4, beta: float = 2.0,
                 l_extra: int = 2, lindep: float = 1e-10,
                 gtol: float = 1e-14, auxcell=None, device=None) -> GDF:
    """The whitened all-electron fit tensor at Gamma on ``device``.

    omega=None is the 0-dimension (molecular) mode: direct 1/r real-space
    integrals, no reciprocal part (dimension-0 cells only, where the
    lattice sums end).
    """
    device = resolve_device(device)
    if auxcell is None:
        auxcell = make_auxcell(cell, beta=beta, l_extra=l_extra)
    naux, nao = auxcell.nao, cell.nao
    f64 = dict(dtype=torch.float64, device=device)
    j2c = torch.as_tensor(md_int.int2c(auxcell, omega), **f64)
    j3c = torch.as_tensor(md_int.int3c(cell, auxcell, omega), **f64)
    if omega is not None:
        vol = cell.vol
        Gv = lr_gvectors(cell, omega, gtol)
        vlr = torch.as_tensor(_vlr(Gv, omega), **f64)
        ftP = ft_ao.ft_ao(auxcell, Gv, device=device)               # (ng, naux)
        ftmn = _c128(ft_ao.ft_aopair(cell, Gv), device)            # (ng, nao, nao)
        vP = ftP.conj() * vlr[:, None]
        j2c = j2c + (vP.T @ ftP).real / vol
        j3c = j3c + (vP.T @ ftmn.reshape(-1, nao * nao)).real.reshape(naux, nao, nao) / vol
        # subtract the SR sums' implicit G=0 component (pi/w^2 kernel)
        qP = ft_ao.ft_ao(auxcell, np.zeros((1, 3)), device=device)[0].real
        S = torch.as_tensor(md_int.overlap(cell), **f64)
        g0 = np.pi / (omega * omega * vol)
        j2c = j2c - g0 * torch.outer(qP, qP)
        j3c = j3c - g0 * qP[:, None, None] * S[None]
    w, U = torch.linalg.eigh(j2c)
    keep = w > w.max() * lindep
    cd = (U[:, keep] / torch.sqrt(w[keep])).T @ j3c.reshape(naux, -1)
    return GDF(cderi=cd.reshape(-1, nao, nao), naux=int(keep.sum()))


def ae_hcore(cell, omega: float = 0.4, gtol: float = 1e-14, device=None):
    """All-electron core Hamiltonian h = T + V_ne (analytic, mesh-free):
    (S, h) float64 tensors on ``device``.

    T from the closed-form lattice sums
    (:func:`~pyscf_isdf_tpu_torch.ops.ft_ao.overlap_and_kinetic`); V_ne by
    the same range separation as the fit tensors with the dropped-G0
    convention (the pi Z_tot/(w^2 vol) S shift).
    """
    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    S, T = ft_ao.overlap_and_kinetic(cell, device=device)
    h = T + torch.as_tensor(md_int.vne(cell, omega), **f64)
    if omega is not None:
        vol = cell.vol
        Z = np.asarray(cell.charges, float)
        Gv = lr_gvectors(cell, omega, gtol)
        vhatA = -(Z @ np.exp(-1j * cell.coords @ Gv.T)) * _vlr(Gv, omega)  # (ng,)
        ftmn = _c128(ft_ao.ft_aopair(cell, Gv), device)
        h = h + torch.einsum("g,gmn->mn", _c128(vhatA, device), ftmn.conj()).real / vol
        h = h + np.pi * Z.sum() / (omega * omega * vol) * S
    return S, h


def _unique_q_canonical(cell, kpts):
    """Distinct momentum transfers q = k2 - k1 folded into the first zone
    (fractional parts in [-1/2, 1/2)) and qmap (nk1, nk2) -> q index."""
    kpts = np.reshape(kpts, (-1, 3))
    nk = len(kpts)
    b_mat = 2.0 * np.pi * np.linalg.inv(cell.a.T)
    diffs = (kpts[None, :, :] - kpts[:, None, :]).reshape(-1, 3)
    scaled = (diffs @ cell.a.T) / (2.0 * np.pi)
    frac = np.round(scaled - np.floor(scaled + 0.5 - 1e-9), 10)
    uniq, inv = np.unique(frac, axis=0, return_inverse=True)
    return uniq @ b_mat, inv.reshape(nk, nk)


def build_ae_gdf_kpts(cell, kpts, omega: float = 0.4, beta: float = 2.0,
                      l_extra: int = 2, lindep: float = 1e-10,
                      gtol: float = 1e-14, auxcell=None, device=None) -> KGDF:
    """k-point all-electron fit tensors (analytic SR + G-sphere LR) on
    ``device``: per folded momentum transfer q one whitened auxiliary
    frame, shared by every (k1, k2) pair of that class."""
    device = resolve_device(device)
    if auxcell is None:
        auxcell = make_auxcell(cell, beta=beta, l_extra=l_extra)
    kpts = np.reshape(np.asarray(kpts, float), (-1, 3))
    nk = len(kpts)
    naux, nao = auxcell.nao, cell.nao
    vol = cell.vol
    q_list, qmap = _unique_q_canonical(cell, kpts)

    # SR analytic lattice sums (Bloch-phased MD engine)
    j2c_q = _c128(md_int_k.int2c_q(auxcell, q_list, omega), device)
    X = md_int_k.int3c_kq(cell, auxcell, kpts, q_list, omega)
    # LR G-sphere and the G = 0 conventions
    qP = ft_ao.ft_ao(auxcell, np.zeros((1, 3)), device=device)[0].real
    g0 = np.pi / (omega * omega * vol)
    S_k = ft_ao.overlap_and_kinetic(cell, kpt=kpts, device=device)[0]
    ft_aux = {}
    wh_q = []
    for iq, q in enumerate(q_list):
        Gv = lr_gvectors_q(cell, q, omega, gtol)
        vlr = _c128(_vlr(Gv + q, omega), device)
        ftP = ft_ao.ft_ao(auxcell, Gv, kpt=q, device=device)        # at q+G
        ft_aux[iq] = (Gv, vlr, ftP)
        j2c = j2c_q[iq] + (ftP.conj() * vlr[:, None]).T @ ftP / vol
        if np.linalg.norm(q) < 1e-9:
            j2c = j2c - g0 * torch.outer(qP, qP)
        wh_q.append(_whitening(0.5 * (j2c + j2c.conj().T), lindep))

    cd = []
    for k1 in range(nk):
        row = []
        for k2 in range(nk):
            iq = qmap[k1, k2]
            Gv, vlr, ftP = ft_aux[iq]
            ftmn = _c128(ft_ao.ft_aopair(cell, Gv, q=q_list[iq], kj=kpts[k2]), device)
            j3c = _c128(X[k2, iq], device) + ((ftP.conj() * vlr[:, None]).T
                                              @ ftmn.reshape(-1, nao * nao)
                                              ).reshape(naux, nao, nao) / vol
            if iq == qmap[0, 0]:                                      # q = 0 class
                j3c = j3c - g0 * qP[:, None, None] * S_k[k2][None]
            row.append((wh_q[iq] @ j3c.reshape(naux, -1)).reshape(-1, nao, nao))
        cd.append(tuple(row))
    return KGDF(cd=tuple(cd), nk=nk)


def ae_hcore_kpts(cell, kpts, omega: float = 0.4, gtol: float = 1e-14,
                  device=None):
    """Analytic all-electron S_k and h_k = T_k + V_ne,k (mesh-free):
    (nk, nao, nao) complex128 tensors on ``device``, with the dropped-G0
    composition of :func:`ae_hcore` per k."""
    device = resolve_device(device)
    kpts = np.reshape(np.asarray(kpts, float), (-1, 3))
    Z = np.asarray(cell.charges, float)
    vol = cell.vol
    Gv = lr_gvectors(cell, omega, gtol)
    vhatA = _c128(-(Z @ np.exp(-1j * cell.coords @ Gv.T)) * _vlr(Gv, omega), device)
    V_sr = _c128(md_int_k.vne_k(cell, kpts, omega), device)
    S, T = (t.to(torch.complex128) for t in
            ft_ao.overlap_and_kinetic(cell, kpt=kpts, device=device))
    h_all = []
    for ik, k in enumerate(kpts):
        ftmn = _c128(ft_ao.ft_aopair(cell, Gv, q=np.zeros(3), kj=k), device)
        # conj(ft[g,n,m]) = int conj(phi_m) phi_n e^{+iG.r}: the k-hermitian
        # orientation (at Gamma ft is (m,n)-symmetric)
        h = T[ik] + V_sr[ik] + torch.einsum("g,gnm->mn", vhatA, ftmn.conj()) / vol
        h = h + np.pi * Z.sum() / (omega * omega * vol) * S[ik]
        h_all.append(0.5 * (h + h.conj().T))
    return S, torch.stack(h_all)


def aehf_kernel(cell, omega: float = 0.4, beta: float = 2.0,
                l_extra: int = 2, exxdiv: str = "ewald",
                max_cycle: int = 80, conv_tol: float = 1e-10,
                gdf: GDF | None = None, verbose: bool = False, device=None):
    """All-electron restricted HF, mesh-free (Gamma point): the shared SCF
    driver on the analytic system (``build_scf_system(ae=True)``) with J
    and K from the whitened fit tensor."""
    from pyscf_isdf_tpu_torch.scf.hf import build_scf_system, scf_kernel

    device = resolve_device(device)
    if gdf is None:
        gdf = build_ae_gdf(cell, omega=omega, beta=beta, l_extra=l_extra,
                           device=device)
    system = build_scf_system(cell, device=device, ae=True, ae_omega=omega)

    def get_jk(dm, with_k):
        vj, vk = get_jk_cd(gdf.cderi, dm)
        return vj, (vk if with_k else None)

    res = scf_kernel(system, xc=None, exxdiv=exxdiv, max_cycle=max_cycle,
                     conv_tol=conv_tol, get_jk=get_jk, verbose=verbose)
    res["gdf"] = gdf
    return res


def aekhf_kernel(cell, kpts, omega: float = 0.4, beta: float = 2.0,
                 l_extra: int = 2, exxdiv: str = "ewald",
                 max_cycle: int = 80, conv_tol: float = 1e-10,
                 kgdf=None, verbose: bool = False, device=None):
    """All-electron k-point restricted HF, mesh-free: the shared k-point
    SCF driver on the analytic system (``build_kscf_system(ae=True)``)
    with J and K from the whitened k fit tensors."""
    from pyscf_isdf_tpu_torch.df.gdf import get_jk_kpts
    from pyscf_isdf_tpu_torch.scf.khf import build_kscf_system, kscf_kernel

    device = resolve_device(device)
    kpts = np.reshape(np.asarray(kpts, float), (-1, 3))
    if kgdf is None:
        kgdf = build_ae_gdf_kpts(cell, kpts, omega=omega, beta=beta,
                                 l_extra=l_extra, device=device)
    system = build_kscf_system(cell, kpts, device=device, ae=True, ae_omega=omega)

    def get_jk(dm_k, with_k):
        vj, vk = get_jk_kpts(kgdf, dm_k)
        return vj, (vk if with_k else None)

    res = kscf_kernel(system, xc=None, exxdiv=exxdiv, max_cycle=max_cycle,
                      conv_tol=conv_tol, get_jk=get_jk, verbose=verbose,
                      device=device)
    res["kgdf"] = kgdf
    return res


def _e_nuc_molecular(cell) -> float:
    """Bare nuclear repulsion of an isolated cell (no images)."""
    Z = np.asarray(cell.charges, float)
    R = cell.coords
    e = 0.0
    for i in range(len(Z)):
        for j in range(i):
            e += Z[i] * Z[j] / np.linalg.norm(R[i] - R[j])
    return float(e)

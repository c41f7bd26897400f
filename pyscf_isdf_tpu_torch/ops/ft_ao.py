"""Analytic Fourier transforms of Gaussian AOs and the lattice-sum S/T.

For a solid-harmonic Gaussian ``phi(r) = c S_lm(r-A) exp(-a|r-A|^2)`` the
plane-wave matrix element is closed-form:

    FT[phi](G) = int phi(r) e^{-i G.r} dr
               = e^{-i G.A} (-i)^l (2a)^{-l} S_lm(G) (pi/a)^{3/2} e^{-G^2/(4a)}

(functional spec per the reference's C kernel pyscf/lib/pbc/ft_ao.c via
pyscf/pbc/df/ft_ao.py:63-102).

Overlap and kinetic matrices are exact lattice sums over primitive pairs
and images (:func:`overlap_and_kinetic`); :func:`ft_aopair` gives the
analytic Fourier transforms of periodic AO pair products (host numpy). The JAX package walks
shell pairs, primitive pairs and monomials in Python loops; here every
(shell pair, primitive pair, image) of one (l_i, l_j) block is one float64
tensor on the given device, processed in chunks of bra shells.
"""
from __future__ import annotations

from math import comb

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.ops.solid_harmonics import solid_harmonics


def ft_ao(cell, Gv, kpt=None, device=None) -> torch.Tensor:
    """(ngrids, nao) complex128 analytic AO Fourier transforms at G (or
    k+G)."""
    device = resolve_device(device)
    Gv = torch.as_tensor(Gv, dtype=torch.float64, device=device)
    if kpt is not None:
        Gv = Gv + torch.as_tensor(kpt, dtype=torch.float64, device=device)
    ng = Gv.shape[0]
    G2 = (Gv * Gv).sum(1)
    out = torch.empty((ng, cell.nao), dtype=torch.complex128, device=device)
    ao_loc = cell.ao_loc
    for ish, sh in enumerate(cell.shells):
        A = torch.as_tensor(cell.coords[sh.atom], device=device)
        phase = torch.exp(-1j * (Gv @ A))                              # (ng,)
        ang = solid_harmonics(sh.l, Gv, torch)                         # (ng, M)
        e = torch.as_tensor(sh.exps, device=device)[None, :]
        rad = ((torch.pi / e) ** 1.5 * (2 * e) ** (-sh.l)
               * torch.exp(-G2[:, None] / (4 * e))) \
            @ torch.as_tensor(sh.coeffs, device=device)               # (ng, K)
        blk = (-1j) ** sh.l * phase[:, None, None] * rad[:, :, None] \
            * ang[:, None, :]
        out[:, ao_loc[ish]:ao_loc[ish + 1]] = blk.reshape(ng, sh.nao)
    return out


def converged_st_mesh(cell) -> tuple:
    """Mesh whose G-truncation error in S/T is below machine precision.

    The FT of a primitive pair decays like exp(-G^2/(4 a_max)); requiring
    exp(-Gmax^2/(4 a_max)) < 1e-16 gives ke = Gmax^2/2 = 74 a_max, never
    coarser than the cell's own mesh. A quadrature mesh of the G-space S/T
    (the force and stress functionals); the SCF grid is unaffected.
    """
    from pyscf_isdf_tpu_torch import lattice

    a_max = max(float(sh.exps.max()) for sh in cell.shells)
    mesh = lattice.cutoff_to_mesh(cell.a, 74.0 * a_max)
    return tuple(int(max(m, c)) for m, c in zip(mesh, cell.mesh))


def _shell_groups(cell):
    """Shells grouped by l: (l, shell indices, centers, padded exps and
    coefficients, AO column of each (shell, contraction, m) or -1)."""
    groups: dict[int, list] = {}
    for ish, sh in enumerate(cell.shells):
        groups.setdefault(sh.l, []).append(ish)
    out = []
    for l in sorted(groups):
        idx = groups[l]
        P = max(len(cell.shells[i].exps) for i in idx)
        K = max(cell.shells[i].nctr for i in idx)
        M = 2 * l + 1
        exps = np.ones((len(idx), P))
        coeffs = np.zeros((len(idx), P, K))
        cols = np.full((len(idx), K, M), -1, dtype=np.int64)
        for n, i in enumerate(idx):
            sh = cell.shells[i]
            exps[n, :len(sh.exps)] = sh.exps
            coeffs[n, :len(sh.exps), :sh.nctr] = sh.coeffs
            cols[n, :sh.nctr] = cell.ao_loc[i] + np.arange(sh.nctr * M).reshape(-1, M)
        centers = cell.coords[[cell.shells[i].atom for i in idx]]
        out.append((l, centers, exps, coeffs, cols.reshape(-1)))
    return out


def _axis_values(dA, dB, E, na_max, nb_max):
    """V[na][nb] = int (x-A)^na (x-B)^nb e^{-p(x-P)^2} dx along one axis,
    by the binomial expansion around P: sum_e,f C(na,e) dA^(na-e)
    C(nb,f) dB^(nb-f) E_(e+f) (odd moments vanish)."""
    pa = [torch.ones_like(dA)] + [dA ** n for n in range(1, na_max + 1)]
    pb = [torch.ones_like(dB)] + [dB ** n for n in range(1, nb_max + 1)]
    V = [[None] * (nb_max + 1) for _ in range(na_max + 1)]
    for na in range(na_max + 1):
        for nb in range(nb_max + 1):
            v = torch.zeros_like(dA)
            for e in range(na + 1):
                ca = comb(na, e) * pa[na - e]
                for f in range(nb + 1):
                    if (e + f) % 2:
                        continue
                    v = v + ca * comb(nb, f) * pb[nb - f] * E[e + f]
            V[na][nb] = v
    return V


def overlap_and_kinetic(cell, kpt=None, ktol=1e-16, device=None,
                        chunk_elems: int = 1 << 21):
    """Closed-form lattice-sum overlap and kinetic matrices, float64
    tensors at Gamma and complex128 at a k-point ``kpt`` (the reference's
    ``overlap_and_kinetic_analytic``; its G-space quadrature variant is
    not ported).

    Per primitive pair and lattice image the Gaussian product theorem
    reduces both integrals to 1-D moments E_n = int x^n e^{-p x^2} dx.
    The kinetic operator uses the identity (S_lm harmonic, degree l)

        -1/2 nabla^2 [S_lm(u) e^{-b u^2}] = b(2l+3) phi - 2 b^2 u^2 phi

    so T needs only the same moments with the ket monomial raised by 2; at a
    k-point each image carries the Bloch phase e^{i k.T}. ``kpt`` of shape
    (nb, 3) gives (nb, nao, nao) complex128 stacks, every k-point from the
    one image sum of each primitive pair.
    Images whose Gaussian-product prefactor is below ``ktol`` are dropped,
    as in the reference. ``chunk_elems`` bounds the (bra shells x ket
    shells x primitive pairs x images) elements of one chunk.
    """
    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    nao = cell.nao
    images = torch.as_tensor(cell.lattice_images(), **f64)          # (nt, 3)
    phase = None
    batch = kpt is not None and np.ndim(kpt) == 2
    if batch or (kpt is not None and np.abs(kpt).sum() > 1e-12):
        kt = torch.as_tensor(kpt, **f64)
        phase = torch.exp(1j * (images @ (kt.T if batch else kt)))   # (nt[, nb])
    out = dict(dtype=torch.float64 if phase is None else torch.complex128,
               device=device)
    lead = (len(kpt),) if batch else ()
    S = torch.zeros(lead + (nao, nao), **out)
    T = torch.zeros(lead + (nao, nao), **out)
    groups = _shell_groups(cell)
    for li, ctr_i, exp_i, cf_i, cols_i in groups:
        mi, Ci = _monos(li)
        Ci = torch.as_tensor(Ci, **f64)
        for lj, ctr_j, exp_j, cf_j, cols_j in groups:
            mj, Cj = _monos(lj)
            Cj = torch.as_tensor(Cj, **f64)
            B0 = torch.as_tensor(ctr_j, **f64)                       # (nj, 3)
            b = torch.as_tensor(exp_j, **f64)                        # (nj, Q)
            cb = torch.as_tensor(cf_j, **f64)                        # (nj, Q, L)
            nj, Q = b.shape
            per_i = nj * exp_i.shape[1] * Q * images.shape[0]
            step = max(1, chunk_elems // per_i)
            for i0 in range(0, len(ctr_i), step):
                A = torch.as_tensor(ctr_i[i0:i0 + step], **f64)     # (ni, 3)
                a = torch.as_tensor(exp_i[i0:i0 + step], **f64)     # (ni, P)
                ca = torch.as_tensor(cf_i[i0:i0 + step], **f64)     # (ni, P, K)
                s_blk, m_blk = _pair_moments(A, a, B0, b, images, li, lj,
                                             mi, mj, ktol, phase)
                if not batch:
                    s_blk, m_blk = s_blk[..., None, :, :], m_blk[..., None, :, :]
                bq = b[None, :, None, :, None, None, None]
                t_blk = bq * (2 * lj + 3) * s_blk - 2.0 * bq * bq * m_blk
                # contractions, then monomials -> solid harmonics
                cc = [x.to(s_blk.dtype) for x in (ca, cb, Ci, Cj)]
                s_sh = torch.einsum("ijpqzab,ipk,jql,ma,nb->zikmjln", s_blk, *cc)
                t_sh = torch.einsum("ijpqzab,ipk,jql,ma,nb->zikmjln", t_blk, *cc)
                ni = A.shape[0]
                rows = cols_i.reshape(len(ctr_i), -1)[i0:i0 + ni].reshape(-1)
                s_sh = s_sh.reshape(s_sh.shape[0], len(rows), -1)
                t_sh = t_sh.reshape(t_sh.shape[0], len(rows), -1)
                r_ok = np.nonzero(rows >= 0)[0]
                c_ok = np.nonzero(cols_j >= 0)[0]
                r_idx = torch.as_tensor(rows[r_ok], device=device)
                c_idx = torch.as_tensor(cols_j[c_ok], device=device)
                r_sel = torch.as_tensor(r_ok, device=device)
                c_sel = torch.as_tensor(c_ok, device=device)
                S[..., r_idx[:, None], c_idx[None, :]] = s_sh[:, r_sel][:, :, c_sel].reshape(
                    lead + (len(r_ok), len(c_ok)))
                T[..., r_idx[:, None], c_idx[None, :]] = t_sh[:, r_sel][:, :, c_sel].reshape(
                    lead + (len(r_ok), len(c_ok)))
    return S, T


def _pair_moments(A, a, B0, b, images, li, lj, mi, mj, ktol, phase=None):
    """Image-summed monomial overlaps of primitive pairs.

    Returns (s, m), each (ni, nj, P, Q, nmono_i, nmono_j):
    s = sum_T K_T prod_d V_d[al_d][be_d] and m the same with the ket
    monomial raised by 2 along each axis in turn (summed over axes);
    complex with the per-image Bloch ``phase`` (nt,), and (ni, nj, P, Q,
    nb, nmono_i, nmono_j) with the phases of nb k-points (nt, nb).
    """
    AB = A[:, None, None, :] - B0[None, :, None, :] - images[None, None]
    AB2 = (AB * AB).sum(-1)                                   # (ni, nj, nt)
    p = a[:, None, :, None] + b[None, :, None, :]             # (ni, nj, P, Q)
    mu = a[:, None, :, None] * b[None, :, None, :] / p
    K = torch.exp(-mu[..., None] * AB2[:, :, None, None, :])  # (..., nt)
    w = torch.where(K > ktol, K, torch.zeros_like(K))

    if phase is not None:
        cos, sin = phase.real.contiguous(), phase.imag.contiguous()

    def image_sum(v):
        return v.sum(-1) if phase is None else torch.complex(v @ cos, v @ sin)
    nmax = li + lj + 2
    E = [torch.sqrt(torch.pi / p)[..., None]]
    for n in range(1, nmax + 1):
        E.append(None if n % 2 else E[n - 2] * (n - 1) / (2 * p[..., None]))
    # P - A = -(b/p)(A - B) and P - B = (a/p)(A - B), B = B0 + T
    fa = (-b[None, :, None, :] / p)[..., None]
    fb = (a[:, None, :, None] / p)[..., None]
    V = []
    for d in range(3):
        ABd = AB[..., d][:, :, None, None, :]
        V.append(_axis_values(fa * ABd, fb * ABd, E, li, lj + 2))

    def mono(al, be):
        return V[0][al[0]][be[0]] * V[1][al[1]][be[1]] * V[2][al[2]][be[2]]

    batch = () if phase is None or phase.dim() == 1 else (phase.shape[1],)
    shape = tuple(p.shape) + batch + (len(mi), len(mj))
    dtype = w.dtype if phase is None else phase.dtype
    s = torch.empty(shape, dtype=dtype, device=p.device)
    m = torch.empty(shape, dtype=dtype, device=p.device)
    for ii, al in enumerate(mi):
        for jj, be in enumerate(mj):
            s[..., ii, jj] = image_sum(w * mono(al, be))
            raised = 0.0
            for d in range(3):
                be2 = list(be)
                be2[d] += 2
                raised = raised + mono(al, be2)
            m[..., ii, jj] = image_sum(w * raised)
    return s, m


def _solid_monomials(l: int):
    """Exact Cartesian monomial coefficients of the real solid harmonics:
    S_lm(v) = sum_alpha c[m][alpha] x^ax y^ay z^az with |alpha| = l.

    Obtained by solving the (exact) linear system on sample points — the
    harmonics are homogeneous degree-l polynomials, so the fit is exact.
    """
    monos = [(i, j, l - i - j) for i in range(l + 1) for j in range(l + 1 - i)]
    rng = np.random.default_rng(7 + l)
    pts = rng.normal(size=(2 * len(monos) + 4, 3))
    M = np.stack([pts[:, 0] ** a * pts[:, 1] ** b * pts[:, 2] ** c
                  for (a, b, c) in monos], axis=1)
    Y = solid_harmonics(l, pts, np)                      # (npts, 2l+1)
    C, *_ = np.linalg.lstsq(M, Y, rcond=None)            # (nmono, 2l+1)
    C[np.abs(C) < 1e-12] = 0.0
    return monos, C.T                                    # (2l+1, nmono)


_MONO_CACHE: dict = {}


def _monos(l: int):
    if l not in _MONO_CACHE:
        _MONO_CACHE[l] = _solid_monomials(l)
    return _MONO_CACHE[l]


# ------------------------------------------------- analytic AO-pair FTs
def _hermite_1d(Gd: np.ndarray, p: float, nmax: int):
    """I_n(g) = int x^n e^{-p x^2} e^{-i g x} dx for n = 0..nmax.

    I_n = (i/(2 sqrt(p)))^n H_n(g/(2 sqrt(p))) sqrt(pi/p) e^{-g^2/(4p)}
    with physicists' Hermite H_n. Returns (nmax+1, ng) complex.
    """
    s = 1.0 / (2.0 * np.sqrt(p))
    x = Gd * s
    H = np.empty((nmax + 1, len(Gd)))
    H[0] = 1.0
    if nmax >= 1:
        H[1] = 2 * x
    for n in range(2, nmax + 1):
        H[n] = 2 * x * H[n - 1] - 2 * (n - 1) * H[n - 2]
    base = np.sqrt(np.pi / p) * np.exp(-(Gd * Gd) / (4 * p))
    fac = (-1j * s) ** np.arange(nmax + 1)
    return fac[:, None] * H * base[None, :]


def ft_aopair(cell, Gv: np.ndarray, q=None, ktol: float = 1e-12,
              kj=None) -> np.ndarray:
    """Analytic Fourier transform of periodic AO pair products.

    out[g, mu, nu] = sum_T e^{i kj.T} int phi_mu(r) phi_nu(r-T)
                                          e^{-i (q+G).r} dr
    (Poisson summation). With kj=None (Gamma) these are the Fourier
    coefficients of the periodic pair density; with Bloch AOs this is
    the unit-cell integral  int_cell conj(phi^{k1}_mu) phi^{k2}_nu
    e^{-i(q+G).r} dr  for kj = k2 and q = k2 - k1 (carrying out the T1
    lattice sum leaves exactly the per-image phase e^{i k2.T}).
    Functional counterpart of the reference's ft_aopair_kpts
    (pyscf/pbc/df/ft_ao.py:63 -> lib/pbc/ft_ao.c), built from the
    Gaussian product theorem + Hermite closed forms — no integral
    library. Host float64 numpy, vectorized over lattice images; the
    AFTDF engine and the all-electron fit tensors consume it.
    """
    kG = Gv + np.asarray(q)[None, :] if q is not None else Gv
    ng = kG.shape[0]
    nao = cell.nao
    ao_loc = cell.ao_loc
    images = cell.lattice_images()
    out = np.zeros((ng, nao, nao), dtype=np.complex128)

    shells = list(enumerate(cell.shells))
    for ish, shi in shells:
        A = cell.coords[shi.atom]
        mi, Ci = _monos(shi.l)
        for jsh, shj in shells:
            B0 = cell.coords[shj.atom]
            mj, Cj = _monos(shj.l)
            lt = shi.l + shj.l
            nm_i, nm_j = len(mi), len(mj)
            for ip, a in enumerate(shi.exps):
                for jp, b in enumerate(shj.exps):
                    p = a + b
                    AB = A - B0 - images                       # (nimg, 3)
                    K = np.exp(-(a * b / p)
                               * np.einsum("ti,ti->t", AB, AB))
                    sel = K > ktol
                    if not sel.any():
                        continue
                    Ksel = K[sel]
                    B = B0 + images[sel]                       # (nt, 3)
                    P = (a * A[None, :] + b * B) / p
                    dA = P - A[None, :]                        # (nt, 3)
                    dB = P - B
                    I1d = np.stack([_hermite_1d(kG[:, d], p, lt)
                                    for d in range(3)])        # (3,lt+1,ng)
                    phase = np.exp(-1j * (P @ kG.T)) * Ksel[:, None]  # (nt,ng)
                    if kj is not None:
                        phase = phase * np.exp(
                            1j * (images[sel] @ np.asarray(kj)))[:, None]
                    # per-image coefficient tensor C[t, ii, jj, nx, ny, nz]
                    nt = len(Ksel)
                    Cten = np.zeros((nt, nm_i, nm_j,
                                     lt + 1, lt + 1, lt + 1))
                    for ii, al in enumerate(mi):
                        for jj, be in enumerate(mj):
                            for ex in range(al[0] + 1):
                                cx = comb(al[0], ex) * dA[:, 0] ** (al[0] - ex)
                                for fx in range(be[0] + 1):
                                    cfx = cx * comb(be[0], fx) \
                                        * dB[:, 0] ** (be[0] - fx)
                                    for ey in range(al[1] + 1):
                                        cy = cfx * comb(al[1], ey) \
                                            * dA[:, 1] ** (al[1] - ey)
                                        for fy in range(be[1] + 1):
                                            cfy = cy * comb(be[1], fy) \
                                                * dB[:, 1] ** (be[1] - fy)
                                            for ez in range(al[2] + 1):
                                                cz = cfy * comb(al[2], ez) \
                                                    * dA[:, 2] ** (al[2] - ez)
                                                for fz in range(be[2] + 1):
                                                    cf = cz * comb(be[2], fz) \
                                                        * dB[:, 2] ** (be[2] - fz)
                                                    Cten[:, ii, jj,
                                                         ex + fx, ey + fy,
                                                         ez + fz] += cf
                    # I products on distinct (nx,ny,nz): (lt+1)^3 x ng
                    Iprod = np.einsum("xg,yg,zg->xyzg", I1d[0], I1d[1],
                                      I1d[2], optimize=True)
                    # sum images into G-space with phases, then contract I
                    Cg = np.einsum("tg,tijxyz->gijxyz", phase, Cten,
                                   optimize=True)
                    contrib = np.einsum("gijxyz,xyzg->gij", Cg,
                                        Iprod, optimize=True)
                    ci = shi.coeffs[ip]
                    cj = shj.coeffs[jp]
                    mcomp = np.einsum("gij,mi,nj->gmn", contrib, Ci, Cj,
                                      optimize=True)
                    piece = np.einsum("gmn,k,l->gkmln", mcomp, ci, cj,
                                      optimize=True)
                    out[:, ao_loc[ish]:ao_loc[ish + 1],
                        ao_loc[jsh]:ao_loc[jsh + 1]] += piece.reshape(
                            ng, shi.nao, shj.nao)
    return out

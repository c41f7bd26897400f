"""One-electron set-up of the plain reference: AO values on the grid,
overlap and kinetic matrices, the GTH pseudopotential, the Coulomb kernel,
the Ewald sum and the Madelung constant.

Frozen, trimmed copies (3-D periodic, Gamma point, l <= 2) of
``pyscf_isdf_tpu_torch/ops/solid_harmonics.py``, ``ops/ao_eval.py`` (the
plain collocation ``eval_ao`` that sums every image, and
``ao_gradient_fft``), ``ops/ft_ao.py``, ``ops/pp.py`` and
``ops/coulomb.py`` at commit 0f4080748bdaf2cf81cd310235eeac9d4311d481.
"""
from __future__ import annotations

import dataclasses
import math
from math import comb

import numpy as np
import torch
from scipy.special import erfc

from . import cell as cellmod

_PI = math.pi


# --------------------------------------------------------- solid harmonics
def solid_harmonics(l, v, xp):
    """The 2l+1 real solid harmonics at vectors ``v`` (..., 3), l <= 2."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return 0.5 / math.sqrt(_PI) * xp.ones_like(x)[..., None]
    if l == 1:
        c = math.sqrt(3 / (4 * _PI))
        return xp.stack([c * x, c * y, c * z], -1)
    if l == 2:
        c0 = math.sqrt(15 / (4 * _PI))
        c1 = math.sqrt(5 / (16 * _PI))
        c2 = math.sqrt(15 / (16 * _PI))
        return xp.stack([c0 * x * y, c0 * y * z, c1 * (2 * z * z - x * x - y * y),
                         c0 * x * z, c2 * (x * x - y * y)], -1)
    raise NotImplementedError(f"l={l}")


# ------------------------------------------------------------ collocation
def _packed(cell):
    """Shells grouped by l, padded; and the block column of each AO."""
    groups = {}
    for ish, sh in enumerate(cell.shells):
        groups.setdefault(sh.l, []).append((ish, sh))
    packs, cols = [], []
    for l in sorted(groups):
        shells = groups[l]
        P = max(len(sh.exps) for _, sh in shells)
        K = max(sh.nctr for _, sh in shells)
        ctr = np.zeros((len(shells), 3))
        es = np.ones((len(shells), P))
        cs = np.zeros((len(shells), P, K))
        for i, (ish, sh) in enumerate(shells):
            ctr[i] = cell.coords[sh.atom]
            es[i, :len(sh.exps)] = sh.exps
            cs[i, :len(sh.exps), :sh.nctr] = sh.coeffs
            for k in range(K):
                for m in range(2 * l + 1):
                    cols.append(cell.ao_loc[ish] + k * (2 * l + 1) + m
                                if k < sh.nctr else -1)
        packs.append((l, ctr, es, cs))
    cols = np.array(cols, dtype=np.int64)
    keep = cols >= 0
    inv = np.zeros(cell.nao, dtype=np.int64)
    inv[cols[keep]] = np.nonzero(keep)[0]
    return packs, inv


def eval_ao(cell, device, block_size=8192, img_chunk=32):
    """(ngrids, nao) float64 AO values on the uniform grid, every lattice
    image summed, in blocks of ``block_size`` grid points."""
    f64 = dict(dtype=torch.float64, device=device)
    coords_all = torch.as_tensor(cellmod.uniform_grid(cell.a, cell.mesh), **f64)
    images = torch.as_tensor(cell.lattice_images(), **f64)
    npad = (-images.shape[0]) % img_chunk
    imgs = torch.cat([images, torch.full((npad, 3), 1e6, **f64)])
    packs, inv = _packed(cell)
    out = []
    for g0 in range(0, coords_all.shape[0], block_size):
        coords = coords_all[g0:g0 + block_size]
        nb = coords.shape[0]
        blocks = []
        for l, ctr, es, cs in packs:
            ctr, es, cs = (torch.as_tensor(x, **f64) for x in (ctr, es, cs))
            acc = torch.zeros((ctr.shape[0], nb, cs.shape[2], 2 * l + 1), **f64)
            for i0 in range(0, imgs.shape[0], img_chunk):
                T = imgs[i0:i0 + img_chunk]
                d = coords[None, :, None, :] - ctr[:, None, None, :] - T[None, None]
                g = torch.exp(-es[:, None, None, :] * (d * d).sum(-1)[..., None])
                acc = acc + torch.einsum("sntp,spk,sntm->snkm", g, cs,
                                         solid_harmonics(l, d, torch))
            blocks.append(acc.transpose(0, 1).reshape(nb, -1))
        out.append(torch.cat(blocks, dim=-1))
    return torch.cat(out)[:, torch.as_tensor(inv, device=device)]


def ao_gradient_fft(aoR, mesh, Gv):
    """(3, ngrids, nao) spectral gradient ifft(i G fft(aoR))."""
    ng, nao = aoR.shape
    fG = torch.fft.fftn(aoR.reshape(*mesh, nao), dim=(0, 1, 2))
    iG = (1j * Gv.T).reshape(3, *mesh)
    out = torch.fft.ifftn(fG[None] * iG[..., None], dim=(1, 2, 3))
    return out.reshape(3, ng, nao).real


# ------------------------------------------------------ overlap, kinetic
def _shell_groups(cell):
    groups = {}
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


def _pair_moments(A, a, B0, b, images, li, lj, mi, mj, ktol):
    AB = A[:, None, None, :] - B0[None, :, None, :] - images[None, None]
    AB2 = (AB * AB).sum(-1)
    p = a[:, None, :, None] + b[None, :, None, :]
    mu = a[:, None, :, None] * b[None, :, None, :] / p
    K = torch.exp(-mu[..., None] * AB2[:, :, None, None, :])
    w = torch.where(K > ktol, K, torch.zeros_like(K))
    E = [torch.sqrt(torch.pi / p)[..., None]]
    for n in range(1, li + lj + 3):
        E.append(None if n % 2 else E[n - 2] * (n - 1) / (2 * p[..., None]))
    fa = (-b[None, :, None, :] / p)[..., None]
    fb = (a[:, None, :, None] / p)[..., None]
    V = []
    for d in range(3):
        ABd = AB[..., d][:, :, None, None, :]
        V.append(_axis_values(fa * ABd, fb * ABd, E, li, lj + 2))

    def mono(al, be):
        return V[0][al[0]][be[0]] * V[1][al[1]][be[1]] * V[2][al[2]][be[2]]

    shape = tuple(p.shape) + (len(mi), len(mj))
    s = torch.empty(shape, dtype=w.dtype, device=p.device)
    m = torch.empty(shape, dtype=w.dtype, device=p.device)
    for ii, al in enumerate(mi):
        for jj, be in enumerate(mj):
            s[..., ii, jj] = (w * mono(al, be)).sum(-1)
            raised = 0.0
            for d in range(3):
                be2 = list(be)
                be2[d] += 2
                raised = raised + mono(al, be2)
            m[..., ii, jj] = (w * raised).sum(-1)
    return s, m


def _monos(l):
    """Monomial coefficients of the real solid harmonics (exact fit)."""
    monos = [(i, j, l - i - j) for i in range(l + 1) for j in range(l + 1 - i)]
    pts = np.random.default_rng(7 + l).normal(size=(2 * len(monos) + 4, 3))
    M = np.stack([pts[:, 0] ** a * pts[:, 1] ** b * pts[:, 2] ** c
                  for (a, b, c) in monos], axis=1)
    C, *_ = np.linalg.lstsq(M, solid_harmonics(l, pts, np), rcond=None)
    C[np.abs(C) < 1e-12] = 0.0
    return monos, C.T


def overlap_and_kinetic(cell, device, ktol=1e-16, chunk_elems=1 << 21):
    """Closed-form lattice-sum S and T (float64, Gamma)."""
    f64 = dict(dtype=torch.float64, device=device)
    nao = cell.nao
    images = torch.as_tensor(cell.lattice_images(), **f64)
    S = torch.zeros((nao, nao), **f64)
    T = torch.zeros((nao, nao), **f64)
    groups = _shell_groups(cell)
    for li, ctr_i, exp_i, cf_i, cols_i in groups:
        mi, Ci = _monos(li)
        Ci = torch.as_tensor(Ci, **f64)
        for lj, ctr_j, exp_j, cf_j, cols_j in groups:
            mj, Cj = _monos(lj)
            Cj = torch.as_tensor(Cj, **f64)
            B0 = torch.as_tensor(ctr_j, **f64)
            b = torch.as_tensor(exp_j, **f64)
            cb = torch.as_tensor(cf_j, **f64)
            nj, Q = b.shape
            step = max(1, chunk_elems // (nj * exp_i.shape[1] * Q * images.shape[0]))
            for i0 in range(0, len(ctr_i), step):
                A = torch.as_tensor(ctr_i[i0:i0 + step], **f64)
                a = torch.as_tensor(exp_i[i0:i0 + step], **f64)
                ca = torch.as_tensor(cf_i[i0:i0 + step], **f64)
                s_blk, m_blk = _pair_moments(A, a, B0, b, images, li, lj, mi, mj, ktol)
                bq = b[None, :, None, :, None, None]
                t_blk = bq * (2 * lj + 3) * s_blk - 2.0 * bq * bq * m_blk
                s_sh = torch.einsum("ijpqab,ipk,jql,ma,nb->ikmjln", s_blk, ca, cb, Ci, Cj)
                t_sh = torch.einsum("ijpqab,ipk,jql,ma,nb->ikmjln", t_blk, ca, cb, Ci, Cj)
                ni = A.shape[0]
                rows = cols_i.reshape(len(ctr_i), -1)[i0:i0 + ni].reshape(-1)
                s_sh = s_sh.reshape(len(rows), -1)
                t_sh = t_sh.reshape(len(rows), -1)
                r_ok = np.nonzero(rows >= 0)[0]
                c_ok = np.nonzero(cols_j >= 0)[0]
                r_idx = torch.as_tensor(rows[r_ok], device=device)
                c_idx = torch.as_tensor(cols_j[c_ok], device=device)
                r_sel = torch.as_tensor(r_ok, device=device)
                c_sel = torch.as_tensor(c_ok, device=device)
                S[r_idx[:, None], c_idx[None, :]] = s_sh[r_sel][:, c_sel]
                T[r_idx[:, None], c_idx[None, :]] = t_sh[r_sel][:, c_sel]
    return S, T


def ft_ao(cell, Gv, device):
    """(ngrids, nao) complex128 analytic AO Fourier transforms at G."""
    Gv = torch.as_tensor(Gv, dtype=torch.float64, device=device)
    G2 = (Gv * Gv).sum(1)
    out = torch.empty((Gv.shape[0], cell.nao), dtype=torch.complex128, device=device)
    for ish, sh in enumerate(cell.shells):
        A = torch.as_tensor(cell.coords[sh.atom], device=device)
        phase = torch.exp(-1j * (Gv @ A))
        ang = solid_harmonics(sh.l, Gv, torch)
        e = torch.as_tensor(sh.exps, device=device)[None, :]
        rad = ((torch.pi / e) ** 1.5 * (2 * e) ** (-sh.l)
               * torch.exp(-G2[:, None] / (4 * e))) @ torch.as_tensor(sh.coeffs, device=device)
        blk = (-1j) ** sh.l * phase[:, None, None] * rad[:, :, None] * ang[:, None, :]
        out[:, cell.ao_loc[ish]:cell.ao_loc[ish + 1]] = blk.reshape(Gv.shape[0], sh.nao)
    return out


# --------------------------------------------------------- pseudopotential
def _gth_c_terms(pp, G2):
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


def gth_vlocG(cell, Gv):
    G2 = np.einsum("gi,gi->g", Gv, Gv)
    G0 = G2 == 0
    vlocG = np.zeros((cell.natm, len(G2)))
    with np.errstate(divide="ignore"):
        coulG = 4 * np.pi / G2
    coulG[G0] = 0.0
    for ia in range(cell.natm):
        Zia = cell.charges[ia]
        pp = cell.pseudos[cell.symbols[ia]]
        vlocG[ia] = Zia * coulG * np.exp(-0.5 * pp.rloc**2 * G2)
        vlocG[ia, G0] = -2 * np.pi * Zia * pp.rloc**2
        vlocG[ia] -= _gth_c_terms(pp, G2)
    return vlocG


def _qli(x, l, i):
    S = np.sqrt
    table = {
        (0, 0): lambda: 4 * S(2.0) * (0.0 * x + 1.0),
        (0, 1): lambda: 8 * S(2 / 15.0) * (3 - x**2),
        (0, 2): lambda: 16.0 / 3 * S(2 / 105.0) * (15 - 10 * x**2 + x**4),
        (1, 0): lambda: 8 * S(1 / 3.0) * (0.0 * x + 1.0),
        (1, 1): lambda: 16 * S(1 / 105.0) * (5 - x**2),
        (1, 2): lambda: 32.0 / 3 * S(1 / 1155.0) * (35 - 14 * x**2 + x**4),
        (2, 0): lambda: 8 * S(2 / 15.0) * (0.0 * x + 1.0),
        (2, 1): lambda: 16.0 / 3 * S(2 / 105.0) * (7 - x**2),
        (2, 2): lambda: 32.0 / 3 * S(2 / 15015.0) * (63 - 18 * x**2 + x**4),
    }
    return table[(l, i)]()


def get_pp(cell, aoR):
    """Local (grid quadrature) plus nonlocal (analytic FT) GTH matrix."""
    device = aoR.device
    Gv_np = cell.get_Gv()
    SI = cellmod.get_SI(cell.coords, Gv_np)
    vpplocG = -np.sum(SI * gth_vlocG(cell, Gv_np), axis=0)
    vpplocG[0] = np.sum(-gth_vlocG(cell, np.zeros((1, 3)))[:, 0])
    vR = np.fft.ifftn(vpplocG.reshape(cell.mesh)).real.ravel()
    v = torch.as_tensor(vR, dtype=torch.float64, device=device)
    vloc = (aoR.T * v) @ aoR

    aokG = ft_ao(cell, Gv_np, device) * (1.0 / cell.vol) ** 0.5
    Gv = torch.as_tensor(Gv_np, device=device)
    G_rad = torch.linalg.norm(Gv, dim=1)
    coords = torch.as_tensor(cell.coords, dtype=torch.float64, device=device)
    vppnl = torch.zeros((cell.nao, cell.nao), dtype=torch.complex128, device=device)
    for ia in range(cell.natm):
        pp = cell.pseudos[cell.symbols[ia]]
        SI_conj = torch.exp(1j * (Gv @ coords[ia]))
        for l, (rl, h) in enumerate(zip(pp.proj_rl, pp.proj_h)):
            if len(h) == 0:
                continue
            hl = torch.as_tensor(np.asarray(h), dtype=torch.complex128, device=device)
            ang = solid_harmonics(l, Gv, torch)
            radial = rl ** (l + 1.5) * np.pi**1.25 * torch.exp(-0.5 * (G_rad * rl) ** 2)
            pYlm = torch.stack([(ang * (radial * _qli(G_rad * rl, l, i))[:, None]).T
                                for i in range(len(h))])
            spg = torch.einsum("img,gp->imp", SI_conj * pYlm, aokG)
            vppnl += torch.einsum("imp,imq->pq", spg.conj(),
                                  torch.einsum("ij,jmp->imp", hl, spg))
    return vloc + (vppnl / cell.vol).real


# ------------------------------------------------------ Coulomb, Ewald
def get_coulG(cell):
    """4 pi / G^2 on the mesh, G=0 -> 0 (3-D, Gamma)."""
    Gv = cell.get_Gv()
    absG2 = np.einsum("gi,gi->g", Gv, Gv)
    with np.errstate(divide="ignore"):
        coulG = 4 * np.pi / absG2
    coulG[absG2 == 0] = 0
    return coulG


def ewald(cell):
    """Nuclear repulsion by the 3-D Ewald sum."""
    chargs, coords = cell.charges, cell.coords
    ew_eta = 1.0 / cell.vol ** (1.0 / 6)
    ew_cut = cellmod._estimate_rcut(ew_eta**2, 0, 1.0, cell.precision)
    Lall = cellmod.lattice_images(cell.a, ew_cut)
    rLij = coords[:, None, :] - coords[None, :, :] + Lall[:, None, None, :]
    r = np.sqrt(np.einsum("Lijx,Lijx->Lij", rLij, rLij))
    r[r < 1e-16] = 1e200
    ewovrl = 0.5 * np.einsum("i,j,Lij->", chargs, chargs, erfc(ew_eta * r) / r)
    ewself = -0.5 * np.dot(chargs, chargs) * 2 * ew_eta / np.sqrt(np.pi)
    ewself += -0.5 * np.sum(chargs) ** 2 * np.pi / (ew_eta**2 * cell.vol)
    log_precision = np.log(cell.precision / (max(np.abs(chargs).sum(), 1.0) * 16 * np.pi**2))
    mesh = cellmod.cutoff_to_mesh(cell.a, -2 * ew_eta**2 * log_precision)
    Gv = cellmod.get_Gv(cell.a, mesh)
    absG2 = np.einsum("gi,gi->g", Gv, Gv)
    absG2 = np.where(absG2 == 0, 1e200, absG2)
    coulG = 4 * np.pi / absG2 / cell.vol
    ZSI = np.einsum("i,ij->j", chargs, cellmod.get_SI(coords, Gv))
    ewg = 0.5 * np.einsum("i,i,i", ZSI.conj(), ZSI * np.exp(-absG2 / (4 * ew_eta**2)),
                          coulG).real
    return float(ewovrl + ewself + ewg)


def madelung(cell):
    """Probe-charge Madelung constant of the cell (Gamma)."""
    probe = dataclasses.replace(cell, coords=np.zeros((1, 3)), symbols=("H",),
                                charges=np.array([1.0]), shells=(), pseudos={})
    return -2.0 * ewald(probe)

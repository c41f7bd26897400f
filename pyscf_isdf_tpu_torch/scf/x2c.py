"""Spin-free exact-two-component (sfX2C-1e) scalar-relativistic hcore.

Reference contract: pyscf/pbc/x2c/sfx2c1e.py — the
one-electron X2C decoupling of the modified Dirac equation, with the
one-center ('atom1e') W = pVp approximation the reference itself ships
for solids (sfx2c1e.py:141-157,176-180; the comment at :175-178 notes
the local-pnucp treatment dominates and uses wloc).  All-electron only
(the reference raises NotImplementedError for pseudopotentials,
sfx2c1e.py:164 — X2C corrects the deep-core kinematics a PP removes).

Pieces, all mesh-free analytic (this package's all-electron stack, host
float64 as in the JAX package's ``scf/x2c.py``; the result lands on the
device):
  * lattice-summed S from ops/ft_ao, T from ops/md_int.kinetic,
    V_ne from df/aegdf.ae_hcore's range-separated analytic build;
  * per-atom one-center s/t/v/w blocks from the McMurchie-Davidson
    Hermite machinery (ops/md_int) with the rinv/pVp kernels at the
    nucleus — Boys functions at PC=0;
  * the X2C algebra (X-matrix from the positive-energy block of the
    4-component 1e Dirac solve; Foldy-Wouthuysen renormalization R).

Exact oracle test (tests/test_x2c.py): with V = W = 0 the decoupled
hcore must reproduce the free-particle relativistic dispersion
E = sqrt(c^4 + 2 t c^2) - c^2 on every kinetic eigenvector — this pins
the whole algebra with zero free parameters; the c -> infinity limit
must restore T + V.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from pyscf_isdf_tpu_torch.device import resolve_device

from pyscf_isdf_tpu_torch.ops import md_int
from pyscf_isdf_tpu_torch.ops.md_int import (
    _e1d, _r_tensor, boys, _monos, _sph_contract)

LIGHT_SPEED = 137.03599967994        # CODATA, = pyscf lib.param.LIGHT_SPEED


# ------------------------------------------------------------------
# X2C algebra (spin-free, real symmetric inputs)

def x2c1e_xmatrix(t, v, w, s, c=LIGHT_SPEED):
    """Small/large decoupling matrix X from the 1e Dirac solve.

    4c matrix [[V, T], [T, W/(4c^2) - T]] with metric [[S, 0],
    [0, T/(2c^2)]]; the electronic (positive-energy) eigenvectors are
    the upper half of the spectrum (the negative continuum sits at
    ~ -2c^2).  X = C_small C_large^{-1}.
    """
    nao = t.shape[0]
    c2 = c * c
    M = np.block([[v, t], [t, w / (4.0 * c2) - t]])
    Smat = np.zeros_like(M)
    Smat[:nao, :nao] = s
    Smat[nao:, nao:] = t / (2.0 * c2)
    e, ca = scipy.linalg.eigh(M, Smat)
    cl = ca[:nao, nao:]
    cs = ca[nao:, nao:]
    return cs @ np.linalg.inv(cl)


def _sym_sqrtm(m, inv=False):
    e, u = np.linalg.eigh(m)
    e = np.maximum(e, 1e-14)
    pw = -0.5 if inv else 0.5
    return (u * e ** pw) @ u.T


def get_hcore_fw(t, v, w, s, x, c=LIGHT_SPEED):
    """Foldy-Wouthuysen renormalized 2-component hcore:

        h_eff = V + T X + X^T T + X^T (W/(4c^2) - T) X
        S~ = S + X^T T X / (2 c^2)
        R = S^{-1/2} (S^{-1/2} S~ S^{-1/2})^{-1/2} S^{1/2}
        h_X2C = R^T h_eff R
    """
    c2 = c * c
    tx = t @ x
    h_eff = v + tx + tx.T + x.T @ (w / (4.0 * c2) - t) @ x
    st = s + x.T @ t @ x / (2.0 * c2)
    s_half = _sym_sqrtm(s)
    s_mhalf = _sym_sqrtm(s, inv=True)
    inner = _sym_sqrtm(s_mhalf @ st @ s_mhalf, inv=True)
    R = s_mhalf @ inner @ s_half
    return R.T @ h_eff @ R


# ------------------------------------------------------------------
# one-center atomic integrals (s, t, rinv, pVp) for the X matrix

def _t1d_combo(E, ax, j, b):
    """1D kinetic factor: -1/2 d^2/dx^2 on ket power j (scalar n=1)."""
    val = -2.0 * b * b * E[ax, j + 2, 0, 0]
    val += b * (2 * j + 1) * E[ax, j, 0, 0]
    if j >= 2:
        val -= 0.5 * j * (j - 1) * E[ax, j - 2, 0, 0]
    return val


def _deriv_terms(m, axis, expnt):
    """d/dx_axis of cart monomial m with exponent expnt:
    list of (shifted monomial, coefficient)."""
    out = [(tuple(mm + 1 if k == axis else mm for k, mm in enumerate(m)),
            -2.0 * expnt)]
    if m[axis] > 0:
        out.append((tuple(mm - 1 if k == axis else mm
                          for k, mm in enumerate(m)), float(m[axis])))
    return out


def atomic_blocks(cell, ia):
    """(s1, t1, v1, w1) one-center matrices over atom ia's AOs.

    v1 = -Z <mu|1/r|nu>, w1 = -Z <d mu . 1/r d nu> (pVp), both with the
    nuclear charge at the shared center (Boys at PC = 0)."""
    shells = [(k, sh) for k, sh in enumerate(cell.shells)
              if sh.atom == ia]
    Z = float(cell.charges[ia])
    nao_A = sum(sh.nao for _, sh in shells)
    s1 = np.zeros((nao_A, nao_A))
    t1 = np.zeros((nao_A, nao_A))
    v1 = np.zeros((nao_A, nao_A))
    w1 = np.zeros((nao_A, nao_A))

    offs = np.cumsum([0] + [sh.nao for _, sh in shells])
    zero1 = np.zeros(1)
    one1 = np.ones(1)
    for bi, (_, shi) in enumerate(shells):
        mi, Ci = _monos(shi.l)
        for bj, (_, shj) in enumerate(shells):
            mj, Cj = _monos(shj.l)
            acc = [np.zeros((shi.coeffs.shape[1], 2 * shi.l + 1,
                             shj.coeffs.shape[1], 2 * shj.l + 1))
                   for _ in range(4)]
            for ip, a in enumerate(shi.exps):
                for jp, b in enumerate(shj.exps):
                    p = a + b
                    E = _e1d(shi.l + 2, shj.l + 2, zero1, zero1, p, one1)
                    Lr = shi.l + shj.l + 2
                    R = _r_tensor(Lr, p, np.zeros((1, 3)),
                                  boys(Lr, np.zeros(1)))
                    pref_s = (np.pi / p) ** 1.5
                    pref_r = 2.0 * np.pi / p

                    def rinv(m1, m2):
                        tot = 0.0
                        for tt in range(m1[0] + m2[0] + 1):
                            ex = E[m1[0], m2[0], tt, 0]
                            if ex == 0.0:
                                continue
                            for uu in range(m1[1] + m2[1] + 1):
                                ey = E[m1[1], m2[1], uu, 0]
                                if ey == 0.0:
                                    continue
                                for vv in range(m1[2] + m2[2] + 1):
                                    ez = E[m1[2], m2[2], vv, 0]
                                    if ez == 0.0:
                                        continue
                                    tot += ex * ey * ez * R[(tt, uu, vv)][0]
                        return pref_r * tot

                    sc = np.zeros((len(mi), len(mj)))
                    tc = np.zeros((len(mi), len(mj)))
                    vc = np.zeros((len(mi), len(mj)))
                    wc = np.zeros((len(mi), len(mj)))
                    for aidx, ma in enumerate(mi):
                        for bidx, mb in enumerate(mj):
                            sx = E[ma[0], mb[0], 0, 0]
                            sy = E[ma[1], mb[1], 0, 0]
                            sz = E[ma[2], mb[2], 0, 0]
                            sc[aidx, bidx] = pref_s * sx * sy * sz
                            tx = _t1d_combo(E, ma[0], mb[0], b)
                            ty = _t1d_combo(E, ma[1], mb[1], b)
                            tz = _t1d_combo(E, ma[2], mb[2], b)
                            tc[aidx, bidx] = pref_s * (
                                tx * sy * sz + sx * ty * sz + sx * sy * tz)
                            vc[aidx, bidx] = -Z * rinv(ma, mb)
                            acc_w = 0.0
                            for ax in range(3):
                                for m1, c1 in _deriv_terms(ma, ax, a):
                                    for m2, c2 in _deriv_terms(mb, ax, b):
                                        acc_w += c1 * c2 * rinv(m1, m2)
                            wc[aidx, bidx] = -Z * acc_w
                    for acc_k, cart in zip(acc, (sc, tc, vc, wc)):
                        Is = _sph_contract(cart, Ci, Cj)
                        acc_k += np.einsum("k,l,MN->kMlN", shi.coeffs[ip],
                                           shj.coeffs[jp], Is)
            sl_i = slice(offs[bi], offs[bi + 1])
            sl_j = slice(offs[bj], offs[bj + 1])
            for mat, acc_k in zip((s1, t1, v1, w1), acc):
                mat[sl_i, sl_j] = acc_k.reshape(shi.nao, shj.nao)
    return s1, t1, v1, w1


def atomic_xmatrix(cell, c=LIGHT_SPEED):
    """Block-diagonal X and one-center W over the full AO basis
    (reference 'atom1e' branch, sfx2c1e.py:141-157)."""
    nao = cell.nao
    X = np.zeros((nao, nao))
    Wloc = np.zeros((nao, nao))
    ao_loc = cell.ao_loc
    shell_atom = [sh.atom for sh in cell.shells]
    for ia in range(cell.natm):
        idx = np.concatenate([
            np.arange(ao_loc[k], ao_loc[k + 1])
            for k, at in enumerate(shell_atom) if at == ia])
        s1, t1, v1, w1 = atomic_blocks(cell, ia)
        X[np.ix_(idx, idx)] = x2c1e_xmatrix(t1, v1, w1, s1, c)
        Wloc[np.ix_(idx, idx)] = w1
    return X, Wloc


# ------------------------------------------------------------------
# PBC driver

def sfx2c1e_hcore(cell, omega: float = 0.4, c=LIGHT_SPEED, device=None):
    """Scalar-relativistic all-electron hcore (Gamma point).

    S/T/V from the analytic all-electron stack; X and W from the
    one-center atomic solves. Drop-in replacement for the
    nonrelativistic ae_hcore (df/aegdf.py).
    Returns (S, h_x2c) float64 tensors on ``device``.
    """
    if cell.pseudos and any(cell.pseudos.values()):
        raise NotImplementedError(
            "sfx2c1e is all-electron only (reference posture, "
            "pbc/x2c/sfx2c1e.py:164)")
    from pyscf_isdf_tpu_torch.df.aegdf import ae_hcore

    device = resolve_device(device)
    S, h = (t.cpu().numpy() for t in ae_hcore(cell, omega, device=device))
    T = md_int.kinetic(cell)
    X, Wloc = atomic_xmatrix(cell, c)
    h_x2c = get_hcore_fw(T, h - T, Wloc, S, X, c)
    f64 = dict(dtype=torch.float64, device=device)
    return torch.as_tensor(S, **f64), torch.as_tensor(h_x2c, **f64)

"""The plain reference of a PBE0 robust-fit ISDF SCF solve at the Gamma
point, in plain PyTorch on any device.

Frozen, trimmed copies of ``pyscf_isdf_tpu_torch/df/fftdf.py`` (``get_j``),
``df/isdf.py`` (``_solve_xi``, ``_build_from_idx``, ``get_k``,
``get_k_robust``), ``ops/cuda_robust_k.robust_k_cross_plain``,
``ops/interp_points.pivoted_cholesky_points``, ``scf/diis.py`` and the
closed-shell loop of ``scf/hf.scf_kernel`` at commit
0f4080748bdaf2cf81cd310235eeac9d4311d481. It imports nothing of the
program: the system is worked out again from the geometry, with the
collocation that sums every image in place of the culled kernel and the
plain cross term in place of the CUDA one.

The greedy selection is discrete, so the reference does not pick its own
points: it walks the program's pivots in their order (as a served model's
tokens are replayed) and measures, at every step, how far the residual
diagonal at the program's pivot lies below the greedy maximum. A near tie
that rounding flips reads as a gap of rounding size; a pivot that is not a
greedy choice reads as a large one.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cell as cellmod
from . import integrals, xc

# What this reference solves; a configuration that states otherwise is
# refused before any run.
SOLVES = dict(xc="pbe0", exxdiv="ewald", isdf_fit="robust", isdf_selection="greedy",
              dtype="float64")


def _complex(f):
    return f.to(torch.complex128 if f.dtype == torch.float64 else torch.complex64)


def fft3(f, mesh):
    shape = f.shape
    return torch.fft.fftn(f.reshape(shape[:-1] + tuple(mesh)), dim=(-3, -2, -1)).reshape(shape)


def ifft3(f, mesh):
    shape = f.shape
    return torch.fft.ifftn(f.reshape(shape[:-1] + tuple(mesh)), dim=(-3, -2, -1)).reshape(shape)


def get_j(aoR, dm, coulG, mesh, weight):
    rho = ((aoR @ dm) * aoR).sum(-1)
    vR = ifft3(coulG * fft3(_complex(rho), mesh), mesh).real
    return weight * ((aoR.T * vR) @ aoR)


# ------------------------------------------------------------ selection
def judge_pivots(aoR, pivots, n_ip):
    """Greedy pivoted Cholesky of Z = (aoR aoR^T)^{o2} along the judged
    ``pivots``. Returns (indices, gap): gap is the largest relative shortfall
    (max d - d[q]) / max d of a pivot's residual diagonal against the
    greedy maximum, 1 for a repeated, out-of-range or missing pivot."""
    ng = aoR.shape[0]
    pivots = torch.as_tensor(pivots, dtype=torch.int64, device=aoR.device)
    if (pivots.numel() != n_ip or int(pivots.min()) < 0 or int(pivots.max()) >= ng
            or torch.unique(pivots).numel() != n_ip):
        return None, 1.0
    d = (aoR * aoR).sum(1) ** 2
    L = torch.zeros((n_ip, ng), dtype=aoR.dtype, device=aoR.device)
    gap = torch.zeros((), dtype=aoR.dtype, device=aoR.device)
    for i in range(n_ip):
        q = pivots[i]
        dmax = d.max()
        gap = torch.maximum(gap, (dmax - d[q]) / dmax)
        zrow = (aoR @ aoR[q]) ** 2
        lrow = (zrow - L[:i].T @ L[:i, q]) / torch.sqrt(torch.clamp(d[q], min=1e-300))
        L[i] = lrow
        d = torch.clamp(d - lrow * lrow, min=0.0)
        d[q] = 0.0
    return pivots, float(gap)


# --------------------------------------------------------- factorization
def _solve_xi(aoR, aoRg):
    nip = aoRg.shape[0]
    C1 = (aoRg @ aoRg.T) ** 2
    eps = 1e-12 * torch.trace(C1) / nip
    eye = torch.eye(nip, dtype=aoR.dtype, device=aoR.device)
    Linv = torch.linalg.solve_triangular(torch.linalg.cholesky(C1 + eps * eye), eye,
                                         upper=False)
    return Linv.T @ (Linv @ ((aoR @ aoRg.T) ** 2).T)


def build_factorization(aoR, ip_idx, coulG, mesh, weight, fft_chunk=128):
    """(aoRg, W, Vxi) of the robust fit on the given points."""
    aoRg = aoR[ip_idx]
    xi = _solve_xi(aoR, aoRg)
    nip, ng = xi.shape
    W = torch.empty((nip, nip), dtype=aoR.dtype, device=aoR.device)
    Vxi = torch.empty((nip, ng), dtype=aoR.dtype, device=aoR.device)
    for i0 in range(0, nip, fft_chunk):
        v = ifft3(coulG * fft3(_complex(xi[i0:i0 + fft_chunk]), mesh), mesh).real
        W[:, i0:i0 + fft_chunk] = xi @ v.T
        Vxi[i0:i0 + fft_chunk] = v
    W = weight * W
    return aoRg, 0.5 * (W + W.T), Vxi


def cross_term(aoR, B, Vxi, g_chunk=4096):
    C = torch.zeros((B.shape[0], aoR.shape[1]), dtype=aoR.dtype, device=aoR.device)
    for g0 in range(0, aoR.shape[0], g_chunk):
        a = aoR[g0:g0 + g_chunk]
        C += ((a @ B.T) * Vxi[:, g0:g0 + g_chunk].T).T @ a
    return C


def get_k_robust(fac, aoR, dm, weight):
    aoRg, W, Vxi = fac
    T1 = weight * (aoRg.T @ cross_term(aoR, aoRg @ dm, Vxi))
    return T1 + T1.T - aoRg.T @ (W * (aoRg @ dm @ aoRg.T)) @ aoRg


# ------------------------------------------------------------------ DIIS
class DIIS:
    def __init__(self, space=8, min_space=2):
        self.space, self.min_space = space, min_space
        self._errs, self._focks = [], []

    def update(self, fock, err):
        self._focks.append(fock.clone())
        self._errs.append(err.reshape(-1).clone())
        if len(self._focks) > self.space:
            self._focks.pop(0)
            self._errs.pop(0)
        n = len(self._focks)
        if n < self.min_space:
            return fock
        E = torch.stack(self._errs)
        gram = (E @ E.T).cpu().numpy()
        B = np.empty((n + 1, n + 1))
        B[-1, :] = B[:, -1] = -1.0
        B[-1, -1] = 0.0
        B[:n, :n] = gram
        rhs = np.zeros(n + 1)
        rhs[-1] = -1.0
        try:
            c = np.linalg.solve(B, rhs)[:n]
        except np.linalg.LinAlgError:
            c = np.linalg.lstsq(B, rhs, rcond=None)[0][:n]
        return sum(float(ci) * fi for ci, fi in zip(c, self._focks))


def _trace(a, b):
    return float(torch.einsum("ij,ji->", a, b))


# ------------------------------------------------------------------- SCF
def build_system(geometry, config, device):
    """Everything the SCF needs that does not depend on the density."""
    cell = cellmod.build_cell(geometry["a"], geometry["symbols"], geometry["coords"],
                              config["basis"], config["pseudo"], config["mesh"])
    aoR = integrals.eval_ao(cell, device)
    S, T = integrals.overlap_and_kinetic(cell, device)
    hcore = T + integrals.get_pp(cell, aoR)
    w, v = torch.linalg.eigh(S)
    keep = w > 1e-12
    f64 = dict(dtype=torch.float64, device=device)
    return dict(
        cell=cell, aoR=aoR, S=S, hcore=hcore, X=v[:, keep] / torch.sqrt(w[keep]),
        coulG=torch.as_tensor(integrals.get_coulG(cell), **f64),
        Gv=torch.as_tensor(cell.get_Gv(), **f64), madelung=integrals.madelung(cell),
        e_nuc=integrals.ewald(cell), weight=cell.vol / cell.ngrids,
        mesh=tuple(cell.mesh), nelec=cell.nelectron)


def scf(system, fac, conv_tol, max_cycle=60, diis_space=8):
    """PBE0 with the robust-fit exchange and the probe-charge shift, from
    the core guess, to the program's convergence rule."""
    aoR, S, hcore, X = system["aoR"], system["S"], system["hcore"], system["X"]
    mesh, weight, coulG = system["mesh"], system["weight"], system["coulG"]
    nocc = system["nelec"] // 2
    ao_grad = integrals.ao_gradient_fft(aoR, mesh, system["Gv"])

    def eig(F):
        e, u = torch.linalg.eigh(X.T @ F @ X)
        return e, X @ u

    def density(mo_c):
        c = mo_c[:, :nocc]
        return 2.0 * c @ c.T

    dm = density(eig(hcore)[1])
    diis = DIIS(space=diis_space)
    e_last, conv, e_tot = 0.0, False, None
    for it in range(max_cycle):
        vj = get_j(aoR, dm, coulG, mesh, weight)
        e_xc, vxc = xc.vxc_gga(aoR, ao_grad, dm, weight)
        vk = get_k_robust(fac, aoR, dm, weight) + system["madelung"] * (S @ dm @ S)
        F = hcore + vj + vxc - 0.5 * xc.HYB * vk
        err = X.T @ (S @ dm @ F - F @ dm @ S) @ X
        F = diis.update(F, err)
        dm_new = density(eig(F)[1])
        e_tot = (_trace(dm, hcore) + 0.5 * _trace(dm, vj) + float(e_xc)
                 - 0.25 * xc.HYB * _trace(dm, vk) + system["e_nuc"])
        err_norm = float(torch.linalg.norm(err)) / max(1, err.numel()) ** 0.5
        if abs(e_tot - e_last) < conv_tol and err_norm < conv_tol ** 0.5:
            conv = True
            dm = dm_new
            break
        dm = dm_new
        e_last = e_tot
    return dict(e_tot=e_tot, dm=dm, niter=it + 1, converged=conv)


def solve(geometry, config, device, pivots):
    """The reference solve of one geometry, judging the program's pivots.

    Returns e_tot, dm, niter, converged and pivot_gap (see
    :func:`judge_pivots`); e_tot and dm are None when the pivots cannot
    be followed."""
    system = build_system(geometry, config, device)
    aoR = system["aoR"]
    n_ip = min(int(config["isdf_c"] * aoR.shape[1]), aoR.shape[0])
    ip_idx, gap = judge_pivots(aoR, pivots, n_ip)
    if ip_idx is None:
        return dict(e_tot=None, dm=None, niter=0, converged=False, pivot_gap=gap)
    fac = build_factorization(aoR, ip_idx, system["coulG"], system["mesh"],
                              system["weight"])
    out = scf(system, fac, config["conv_tol"])
    out["pivot_gap"] = gap
    return out

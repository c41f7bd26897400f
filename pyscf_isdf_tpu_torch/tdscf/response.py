"""Matrix-free TDA: response products with autograd XC kernels.

The A.x product is assembled from
  * orbital-energy differences (diagonal),
  * the Coulomb response via one Poisson solve of the transition density,
  * the exact-exchange response via the ISDF factorization
    (K_x = aoRg^T (W o aoRg dm_x aoRg^T) aoRg, GEMM cost, any dm_x) or
    the FFTDF exchange,
  * the XC kernel as the directional derivative of the Vxc-matrix
    function, K_xc . x = d/dl Vxc[dm + l dm_x] at l = 0, exact for LDA and
    GGA (:func:`linear_jvp`; no hand-derived fxc formulas).

Solved with a block Davidson iteration on the host (:func:`davidson`), so
no n_ov^2 matrix is ever formed.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import to_host as _host
from pyscf_isdf_tpu_torch.df import fftdf
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.ops.xc import XCSpec, _max


def linear_jvp(fn, *primals):
    """``v -> J v`` for the Jacobian J of ``fn`` (tensors in, one tensor
    out) at ``primals``, by reverse over reverse: g(u) = J^T u is built once
    with its graph, and each call is one backward pass of <g, v> in u
    (``retain_graph``), so the graph of the linearization is recorded once
    for any number of tangents. Complex outputs follow torch's convention
    and give J v too."""
    xs = [p.detach().requires_grad_(True) for p in primals]
    with torch.enable_grad():
        y = fn(*xs)
        u = torch.zeros_like(y, requires_grad=True)
        gs = torch.autograd.grad(y, xs, u, create_graph=True, allow_unused=True)
    live = [i for i, g in enumerate(gs) if g is not None and g.requires_grad]

    def jvp(*tangents):
        if not live:
            return torch.zeros_like(y)
        with torch.enable_grad():
            out, = torch.autograd.grad([gs[i] for i in live], u,
                                       [tangents[i] for i in live], retain_graph=True)
        return out

    return jvp


def vxc_mat_spin(aoR, ao_grad, weight, xcspec):
    """(dm_a, dm_b) -> the alpha-channel Vxc matrix of the spin-resolved
    functional at densities floored at 1e-12 (differentiable, for the
    triplet kernel). GGA: 1/2 va ao + (2 vs_aa grad rho_a + vs_ab grad
    rho_b) . grad ao, symmetrized."""

    def vxc(dm_a, dm_b):
        ta = aoR @ dm_a
        tb = aoR @ dm_b
        rho_a = _max((ta * aoR).sum(-1), 1e-12)
        rho_b = _max((tb * aoR).sum(-1), 1e-12)
        if xcspec.family == "lda":
            _, (va, _vb), _ = xcspec.exc_vxc_spin(rho_a, rho_b)
            return weight * ((aoR.T * va) @ aoR)
        ga = 2.0 * torch.einsum("gi,xgi->xg", ta, ao_grad)
        gb = 2.0 * torch.einsum("gi,xgi->xg", tb, ao_grad)
        _, (va, _vb), (vsaa, vsab, _vsbb) = xcspec.exc_vxc_spin(
            rho_a, rho_b, (ga * ga).sum(0), (ga * gb).sum(0), (gb * gb).sum(0))
        aow = 0.5 * va[:, None] * aoR + torch.einsum(
            "xg,xgi->gi", 2.0 * vsaa[None, :] * ga + vsab[None, :] * gb, ao_grad)
        half = weight * (aoR.T @ aow)
        return half + half.T

    return vxc


def xc_kernel(system, xcspec, dm0, singlet):
    """dsym -> K_xc[dsym] (nao, nao), the XC response to a symmetric AO
    transition density: the derivative of the closed-shell Vxc along
    2 dsym (singlet), or of the alpha-channel spin Vxc along (dsym, -dsym)
    (triplet). None for no functional or 'hf'."""
    if xcspec is None or xcspec.family == "hf":
        return None
    if xcspec.family not in ("lda", "gga"):
        raise NotImplementedError(f"TDA kernel of the {xcspec.family} family")
    from pyscf_isdf_tpu_torch.scf.hf import _vxc_gga, _vxc_lda

    aoR, w = system.aoR, system.weight
    ao_grad = None
    if xcspec.family == "gga":
        ao_grad = ao_gradient_fft(aoR, system.mesh, system.Gv.to(aoR.dtype))
    if singlet:
        def vxc_mat_s(dm_s):
            if xcspec.family == "lda":
                return _vxc_lda(aoR, dm_s, w, xcspec)[1]
            return _vxc_gga(aoR, ao_grad, dm_s, w, xcspec)[1]

        jv = linear_jvp(vxc_mat_s, dm0)
        return lambda dsym: jv(2.0 * dsym)
    half = 0.5 * dm0
    jv = linear_jvp(vxc_mat_spin(aoR, ao_grad, w, xcspec), half, half)
    return lambda dsym: jv(dsym, -dsym)


def make_tda_matvec(system, scf_res, xc=None, singlet=True, isdf=None, nocc=None):
    """Return (matvec(x (no, nv)) -> (no, nv) tensor, diag (no, nv) numpy)
    for the TDA A on the system's device."""
    aoR = system.aoR
    dev, dt = aoR.device, aoR.dtype
    mo_e = _host(scf_res["mo_energy"])
    mo_c = torch.as_tensor(_host(scf_res["mo_coeff"]), dtype=dt, device=dev)
    if nocc is None:
        nocc = system.nelec // 2
    xcspec = XCSpec(xc) if xc is not None else None
    hyb = 1.0 if xcspec is None else xcspec.hyb
    fac = 2.0 if singlet else 0.0

    Co, Cv = mo_c[:, :nocc], mo_c[:, nocc:]
    moR_o, moR_v = aoR @ Co, aoR @ Cv
    coulG = system.coulG
    mesh, w = system.mesh, system.weight
    dm0 = torch.as_tensor(_host(scf_res["dm"]), dtype=dt, device=dev)
    diag = mo_e[None, nocc:] - mo_e[:nocc, None]
    diag_t = torch.as_tensor(diag, dtype=dt, device=dev)
    kxc = xc_kernel(system, xcspec, dm0, singlet)

    def matvec(x):
        x = torch.as_tensor(x, dtype=dt, device=dev)
        dmx = Co @ x @ Cv.T                                 # (nao, nao)
        out = diag_t * x
        if fac != 0.0:
            rho_x = ((moR_o @ x) * moR_v).sum(1)             # (ng,)
            vR = fftdf.ifft3(coulG * fftdf.fft3(fftdf._complex(rho_x), mesh), mesh).real
            out = out + fac * w * (moR_o.T * vR) @ moR_v
        if hyb > 0:
            if isdf is not None:
                M = isdf.aoRg @ dmx @ isdf.aoRg.T
                Kx = isdf.aoRg.T @ (isdf.W * M) @ isdf.aoRg
            else:
                Kx = fftdf.get_k(aoR, dmx, coulG, mesh, w)
            out = out - hyb * (Co.T @ Kx @ Cv)
        if kxc is not None:
            out = out + Co.T @ kxc(0.5 * (dmx + dmx.T)) @ Cv
        return out

    return matvec, diag


def davidson(matvec, diag, nstates=3, tol=1e-8, max_space=60, max_iter=100):
    """Block Davidson for the lowest eigenpairs of a symmetric operator
    (host numpy; ``matvec`` may return a tensor on any device).

    Args:
        matvec: x (shape of diag) -> A.x.
        diag: diagonal preconditioner of A.
    Returns (eigenvalues (nstates,), eigenvectors (n, nstates)); the
    iteration count of the last call is ``davidson.last_iter``, and
    ``davidson.converged`` says whether its residuals met ``tol``.
    """
    shape = diag.shape
    n = diag.size
    dflat = diag.ravel()

    # track a buffer of extra roots so degenerate partners are not missed
    nroots = min(n, max(2 * nstates, nstates + 4))
    order = np.argsort(dflat)
    V = np.zeros((n, nroots))
    for i in range(nroots):
        V[order[i], i] = 1.0

    AV = np.zeros((n, 0))
    Vb = np.zeros((n, 0))

    def _orthonormal_extension(Vb_, Vcand, drop=1e-6):
        """Column-wise MGS with re-orthogonalization: blocked QR amplifies
        roundoff overlaps by 1/r_ii for nearly dependent corrections and
        corrupts the subspace (spurious zero Ritz values)."""
        cols = []
        for v in Vcand.T:
            n0 = np.linalg.norm(v)
            if n0 < 1e-300:
                continue
            v = v / n0
            for _ in range(2):
                if Vb_.shape[1]:
                    v = v - Vb_ @ (Vb_.T @ v)
                for c in cols:
                    v = v - c * (c @ v)
            n1 = np.linalg.norm(v)
            if n1 > drop:
                cols.append(v / n1)
        return np.stack(cols, axis=1) if cols else np.zeros((Vcand.shape[0], 0))

    def apply(v):
        out = matvec(v.reshape(shape))
        return _host(out).ravel()

    davidson.converged = False
    for it in range(max_iter):
        davidson.last_iter = it + 1
        Vnew = _orthonormal_extension(Vb, V)
        if Vnew.shape[1] == 0:
            break
        AVnew = np.column_stack([apply(v) for v in Vnew.T])
        Vb = np.column_stack([Vb, Vnew])
        AV = np.column_stack([AV, AVnew])
        H = Vb.T @ AV
        H = 0.5 * (H + H.T)
        theta, s = np.linalg.eigh(H)
        theta, s = theta[:nroots], s[:, :nroots]
        X = Vb @ s
        R = AV @ s - X * theta[None, :]
        rnorm = np.linalg.norm(R, axis=0)
        if np.all(rnorm[:nstates] < tol):
            davidson.converged = True
            return theta[:nstates], X[:, :nstates]
        # preconditioned residual corrections
        V = np.zeros((n, 0))
        for k in range(nroots):
            if rnorm[k] < tol:
                continue
            denom = dflat - theta[k]
            denom = np.where(np.abs(denom) < 1e-6, 1e-6, denom)
            V = np.column_stack([V, (R[:, k] / denom)])
        if Vb.shape[1] > max_space:
            # restart from current Ritz vectors
            Vb = np.zeros((n, 0))
            AV = np.zeros((n, 0))
            V = np.column_stack([X, V])
    return theta[:nstates], (Vb @ s)[:, :nstates]


davidson.last_iter = 0
davidson.converged = False


def tda_davidson(system, scf_res, xc=None, nstates=3, singlet=True, isdf=None, tol=1e-7):
    """Iterative (matrix-free) TDA excitation energies and vectors."""
    matvec, diag = make_tda_matvec(system, scf_res, xc=xc, singlet=singlet, isdf=isdf)
    return davidson(matvec, diag, nstates=nstates, tol=tol)

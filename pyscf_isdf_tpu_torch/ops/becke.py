"""Becke atomic-grid quadrature for periodic XC integration (torch).

Reference counterpart: ``pyscf/pbc/dft/gen_grid.py:141-234`` (BeckeGrids)
on the molecular machinery of ``pyscf/dft/radi.py`` and
``pyscf/dft/gen_grid.py``; the construction follows the JAX package's
``ops/becke.py``:

* **Periodic partition identity.** For a cell-periodic integrand ``f``
  and a Becke partition of unity over the crystal,
  ``integral_cell f = sum_{A in cell} integral_{R^3} P_A f``: each atom of
  the cell carries one all-space atomic grid, and the weights of the full
  grid sum to the cell volume.
* **Compactly supported partition.** Each atom's unnormalised Becke
  product is multiplied by a smooth radial cutoff ``h_A(|r - R_A|)`` (1
  inside ``r1``, an order-7 smoothstep to 0 at ``r_cut``) before
  normalisation, ``P_A = h_A prod_s / sum_B h_B prod_s``, so every
  atomic integrand is supported inside ``r_cut`` and the identity stays
  exact.
* **Product angular grids** (Gauss-Legendre in cos(theta) x uniform
  phi), exact for spherical harmonics of degree < 2 n_theta, and
  Treutler-Ahlrichs M4 radial grids.

The partition runs on the device in float64, one owner atom at a time,
in chunks of points. A point's normaliser only has terms from the atoms
within ``r_cut`` of it (``h_B = 0`` beyond), and each such atom's product
runs over its s-partners (the atoms within ``s_radius`` of it, a static
host list). The chunk therefore gathers, per point, its nearest atoms
and their partner lists, and never forms the dense (atoms x atoms)
sweep of every point; the factors and sums are the reference's.

AO values on the cloud come from kernel K1 on slabs of consecutive points
(:func:`~pyscf_isdf_tpu_torch.ops.cuda_ao.make_ao_evaluator` with
explicit ``coords``) with the brick planner's cull, which drops terms
below 1e-16, within the tight image radius (at the reference's radius
the values would part from its full image sum by 2.8e-12); their
gradients alone from the plain lattice-summed
evaluator with its exact derivatives
(:func:`~pyscf_isdf_tpu_torch.ops.ao_eval.eval_ao_deriv1`: the terms the
reference differentiates by three ``jax.jvp`` pushes). Bloch AOs at a
k-point come from the plain evaluator alone.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.ops.ao_eval import PackedBasis, eval_ao_deriv1

__all__ = [
    "BeckeGrids", "build_becke_grids", "eval_ao_and_grad", "becke_xc_inputs",
    "vxc_lda", "vxc_gga", "vxc_mgga", "vxc",
]

BOHR = 0.52917721092

# Bragg-Slater atomic radii (Angstrom; J. C. Slater, J. Chem. Phys. 41,
# 3199 (1964), the table the reference ships in pyscf/dft/radi.py). Noble
# gases take the customary filled values.
_BRAGG_A = {
    "H": 0.35, "He": 1.40,
    "Li": 1.45, "Be": 1.05, "B": 0.85, "C": 0.70, "N": 0.65,
    "O": 0.60, "F": 0.50, "Ne": 1.50,
    "Na": 1.80, "Mg": 1.50, "Al": 1.25, "Si": 1.10, "P": 1.00,
    "S": 1.00, "Cl": 1.00, "Ar": 1.88,
    "K": 2.20, "Ca": 1.80, "Sc": 1.60, "Ti": 1.40, "V": 1.35,
    "Cr": 1.40, "Mn": 1.40, "Fe": 1.40, "Co": 1.35, "Ni": 1.35,
    "Cu": 1.35, "Zn": 1.35, "Ga": 1.30, "Ge": 1.25, "As": 1.15,
    "Se": 1.15, "Br": 1.15, "Kr": 2.02,
}


def bragg_radius(symbol: str) -> float:
    """Bragg-Slater radius in bohr (carbon-like 0.7 A for other elements)."""
    return _BRAGG_A.get(symbol, 0.70) / BOHR


def treutler_ahlrichs(n: int, xi: float):
    """Treutler-Ahlrichs M4 radial grid on Gauss-Chebyshev-2 nodes,
    r = (xi / ln 2) (1 + x)^0.6 ln(2 / (1 - x)) (JCP 102, 346 (1995)).
    Returns (r, w) with w including the r^2 volume factor."""
    i = np.arange(1, n + 1, dtype=np.float64)
    th = i * np.pi / (n + 1)
    x = np.cos(th)
    ln2 = np.log(2.0)
    lg = np.log(2.0 / (1.0 - x))
    r = (xi / ln2) * (1.0 + x) ** 0.6 * lg
    drdx = (xi / ln2) * ((0.6 * (1.0 + x) ** -0.4) * lg
                         + (1.0 + x) ** 0.6 / (1.0 - x))
    w = (np.pi / (n + 1)) * np.sin(th) * drdx * r * r
    return r, w


def angular_product(n_theta: int):
    """Product angular grid: ``n_theta`` Gauss-Legendre nodes in cos(theta)
    x ``2 n_theta`` uniform phi. Returns (unit vectors (nang, 3), weights
    (nang,)) with sum(weights) = 4 pi."""
    ct, wt = np.polynomial.legendre.leggauss(n_theta)
    st = np.sqrt(1.0 - ct * ct)
    m = 2 * n_theta
    phi = 2.0 * np.pi * np.arange(m) / m
    vec = np.stack([np.outer(st, np.cos(phi)).ravel(),
                    np.outer(st, np.sin(phi)).ravel(),
                    np.repeat(ct, m)], axis=1)
    return vec, np.repeat(wt, m) * (2.0 * np.pi / m)


def _becke_s(mu, k: int = 3):
    """Becke cell step function s(mu) = (1 - f_k(mu)) / 2, f iterated k x."""
    f = mu
    for _ in range(k):
        f = 0.5 * f * (3.0 - f * f)
    return 0.5 * (1.0 - f)


def _radial_mask(d, r1, r_cut):
    """Smooth compact cutoff: 1 for d <= r1, an order-7 smoothstep down,
    0 past r_cut."""
    t = torch.clamp((d - r1) / (r_cut - r1), 0.0, 1.0)
    t2 = t * t
    t4 = t2 * t2
    return 1.0 - t4 * (35.0 - 84.0 * t + 70.0 * t2 - 20.0 * t2 * t)


def _partition(points, atoms, inv_dist, adjust, partners, r1, r_cut, ihome,
               chunk: int = 16384):
    """Normalised compact Becke weight P_A(r) of the owner ``ihome`` at
    each point: (m,) float64 on the device of ``points``.

    atoms (nB, 3) every atom within reach of the owner's grid; inv_dist
    and adjust (nB, nB) the inverse distances and Becke size adjustments;
    partners (nB, npart) each atom's s-partner indices (index nB: none).
    Only the atoms within ``r_cut`` of a point enter its normaliser.
    """
    nB = atoms.shape[0]
    dev = points.device
    # padding column nB: a partner that contributes a factor of exactly 1
    inv_pad = torch.nn.functional.pad(inv_dist, (0, 1))
    adj_pad = torch.nn.functional.pad(adjust, (0, 1))
    out = torch.empty(points.shape[0], dtype=points.dtype, device=dev)
    for p0 in range(0, points.shape[0], chunk):
        pc = points[p0:p0 + chunk]
        d = torch.cdist(pc, atoms, compute_mode="donot_use_mm_for_euclid_dist")
        near = d < r_cut
        K = max(1, int(near.sum(1).max()))
        dsel, bsel = torch.topk(d, K, dim=1, largest=False)          # (m, K)
        h = _radial_mask(dsel, r1, r_cut)                            # 0 past r_cut
        cidx = partners[bsel]                                        # (m, K, npart)
        dpad = torch.nn.functional.pad(d, (0, 1), value=0.0)
        dC = torch.gather(dpad, 1, cidx.reshape(cidx.shape[0], -1)).reshape(cidx.shape)
        rowB = bsel[..., None].expand_as(cidx)
        mu = (dsel[..., None] - dC) * inv_pad[rowB, cidx]
        mu = mu + adj_pad[rowB, cidx] * (1.0 - mu * mu)
        s = torch.where(cidx < nB, _becke_s(mu), torch.ones_like(mu))
        p = torch.prod(s, dim=2) * h                                 # (m, K)
        own = torch.where(bsel == ihome, p, torch.zeros_like(p)).sum(1)
        out[p0:p0 + chunk] = own / torch.clamp(p.sum(1), min=1e-300)
    return out


@dataclass(frozen=True)
class BeckeGrids:
    """Static Becke point cloud: host float64 coords and weights."""
    coords: np.ndarray    # (ng, 3)
    weights: np.ndarray   # (ng,)

    @property
    def size(self) -> int:
        return int(self.coords.shape[0])


def build_becke_grids(cell, n_rad: int = 50, n_theta: int = 12,
                      r_cut: float | None = None,
                      s_radius: float | None = None,
                      prune_tol: float = 1e-12, device=None) -> BeckeGrids:
    """The periodic Becke quadrature of ``cell`` (float64), partitioned on
    ``device`` (default: the GPU).

    Per-atom Treutler-Ahlrichs x product-angular grids with the compact
    Becke weights (module docstring). ``r_cut`` (default: twice the
    largest nearest-neighbour distance) is each partition function's
    support radius, ``s_radius`` (default ``r_cut``) the s-product partner
    radius; points whose partition weight is at most ``prune_tol`` are
    dropped. The same defaults, lists and pruning as the reference
    (``pyscf_isdf_tpu/ops/becke.py``), so the same points.
    """
    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    a = np.asarray(cell.a, dtype=np.float64)
    natm = cell.natm
    radii = np.array([bragg_radius(s) for s in cell.symbols])

    # nearest-neighbour distance per home atom (images included)
    imgs_nn = lattice.lattice_images(a, float(np.linalg.norm(a, axis=1).max()))
    all_nn = (cell.coords[None, :, :] + imgs_nn[:, None, :]).reshape(-1, 3)
    nn = np.empty(natm)
    for ia in range(natm):
        d = np.linalg.norm(all_nn - cell.coords[ia], axis=1)
        nn[ia] = d[d > 1e-8].min()
    if r_cut is None:
        r_cut = 2.0 * float(nn.max())
    if s_radius is None:
        s_radius = float(r_cut)
    r1 = 0.5 * r_cut

    r_list = 2.0 * r_cut + s_radius
    imgs = lattice.lattice_images(a, r_list)
    atoms_img = (cell.coords[None, :, :] + imgs[:, None, :]).reshape(-1, 3)
    radii_img = np.tile(radii, len(imgs))
    home0 = int(np.argmin(np.linalg.norm(imgs, axis=1))) * natm

    ang_vec, ang_w = angular_product(n_theta)
    coords_out, w_out = [], []
    for ia in range(natm):
        r, wr = treutler_ahlrichs(n_rad, max(radii[ia], 0.4))
        keep_r = r <= r_cut
        r, wr = r[keep_r], wr[keep_r]
        pts = (cell.coords[ia][None, None, :]
               + r[:, None, None] * ang_vec[None, :, :]).reshape(-1, 3)
        w0 = (wr[:, None] * ang_w[None, :]).ravel()

        # static per-atom neighbour list: every atom within r_list of the
        # owner (normaliser atoms within 2 r_cut and their s-partners)
        sel = np.linalg.norm(atoms_img - cell.coords[ia], axis=1) <= r_list
        sel[home0 + ia] = True
        idx = np.where(sel)[0]
        B, rB = atoms_img[idx], radii_img[idx]
        ihome = int(np.searchsorted(idx, home0 + ia))
        dist = np.linalg.norm(B[:, None, :] - B[None, :, :], axis=2)
        np.fill_diagonal(dist, 1.0)
        inv_dist = 1.0 / dist
        np.fill_diagonal(inv_dist, 0.0)
        # Becke's heteronuclear size adjustment nu = mu + a (1 - mu^2)
        chi = rB[:, None] / rB[None, :]
        u = (chi - 1.0) / (chi + 1.0)
        adjust = np.clip(u / (u * u - 1.0), -0.45, 0.45)
        np.fill_diagonal(adjust, 0.0)
        pair_on = dist <= s_radius
        np.fill_diagonal(pair_on, False)
        npart = max(1, int(pair_on.sum(1).max()))
        partners = np.full((len(idx), npart), len(idx), dtype=np.int64)
        for b in range(len(idx)):
            nb = np.nonzero(pair_on[b])[0]
            partners[b, :nb.size] = nb

        pw = _partition(torch.as_tensor(pts, **f64), torch.as_tensor(B, **f64),
                        torch.as_tensor(inv_dist, **f64),
                        torch.as_tensor(adjust, **f64),
                        torch.as_tensor(partners, device=device),
                        r1, r_cut, ihome).cpu().numpy()
        keep = pw > prune_tol
        coords_out.append(pts[keep])
        w_out.append((w0 * pw)[keep])
    return BeckeGrids(coords=np.concatenate(coords_out),
                      weights=np.concatenate(w_out))


def eval_ao_and_grad(cell, coords, kpt=None, need_grad=True, device=None,
                     timer=None):
    """Periodic AO values (ng, nao) and gradients (3, ng, nao) on a cloud,
    float64 (complex128 at a k-point ``kpt``) on ``device``.

    At Gamma the values come from kernel K1 on slabs with the 1e-16 cull
    and the tight image radius, and the plain evaluator sums the gradients
    alone. The gradients, and the Bloch AOs at a k-point, come from the
    plain lattice-summed evaluator with its exact derivatives
    (:func:`~pyscf_isdf_tpu_torch.ops.ao_eval.eval_ao_deriv1`), the
    terms the reference differentiates by three ``jax.jvp`` pushes.
    ``timer`` records the Gamma stages 'becke_ao_plan' (K1's host plan),
    'becke_k1' (its launches) and 'becke_grad'.
    """
    from pyscf_isdf_tpu_torch.ops.cuda_ao import (
        DROP, TIGHT_RCUT_PRECISION, make_ao_evaluator,
    )
    from pyscf_isdf_tpu_torch.utils.timing import null_timer

    timer = timer or null_timer
    device = resolve_device(device)
    f64 = dict(dtype=torch.float64, device=device)
    coords = np.asarray(coords, dtype=np.float64)
    packed = PackedBasis.from_cell(cell)
    images = torch.as_tensor(cell.lattice_images(), **f64)
    c = torch.as_tensor(coords, **f64)
    if kpt is not None:
        ao, grad = eval_ao_deriv1(packed, c, images, torch.as_tensor(kpt, **f64))
        return ao, (grad if need_grad else None)
    with timer("becke_ao_plan"):
        evaluate = make_ao_evaluator(cell, coords=coords, dtype=torch.float64,
                                     device=device, drop=DROP,
                                     rcut_precision=TIGHT_RCUT_PRECISION)
    with timer("becke_k1"):
        ao = evaluate()
    if not need_grad:
        return ao, None
    with timer("becke_grad"):
        return ao, eval_ao_deriv1(packed, c, images, values=False)[1]


def parse_xc_grids(xc_grids: str):
    """None for 'uniform', else the (n_rad, n_theta) of 'becke' (defaults)
    or 'becke:n_rad,n_theta'."""
    if xc_grids == "uniform":
        return None
    if xc_grids == "becke":
        return {}
    if xc_grids.startswith("becke:"):
        n_rad, n_theta = map(int, xc_grids.split(":", 1)[1].split(","))
        return dict(n_rad=n_rad, n_theta=n_theta)
    raise ValueError(f"unknown xc_grids {xc_grids!r} "
                     "(expected 'uniform' or 'becke[:n_rad,n_theta]')")


def becke_xc_inputs(cell, xc_grids: str, need_grad: bool, kpts=None,
                    device=None, timer=None):
    """The Becke cloud's XC inputs of one driver, or None for 'uniform':
    (AO values, AO gradients or None, weights (ng,) tensor, the grid).

    At Gamma (``kpts`` None) the AOs are (ng, nao) and the gradients
    (3, ng, nao); with ``kpts`` (nk, 3) they are stacked per k-point,
    (nk, ng, nao) and (nk, 3, ng, nao) complex. ``timer`` records the
    stages 'becke_grid' and 'becke_ao', and within 'becke_ao' at Gamma
    those of :func:`eval_ao_and_grad`.
    """
    from pyscf_isdf_tpu_torch.utils.timing import null_timer

    opts = parse_xc_grids(xc_grids)
    if opts is None:
        return None
    timer = timer or null_timer
    device = resolve_device(device)
    with timer("becke_grid"):
        bg = build_becke_grids(cell, device=device, **opts)
    with timer("becke_ao"):
        if kpts is None:
            ao, grad = eval_ao_and_grad(cell, bg.coords, need_grad=need_grad,
                                        device=device, timer=timer)
        else:
            pairs = [eval_ao_and_grad(cell, bg.coords, kpt=k, need_grad=need_grad,
                                      device=device)
                     for k in np.reshape(kpts, (-1, 3))]
            ao = torch.stack([p[0] for p in pairs])
            grad = torch.stack([p[1] for p in pairs]) if need_grad else None
    w = torch.as_tensor(bg.weights, dtype=torch.float64, device=device)
    return ao, grad, w, bg


# Same contractions as the uniform-grid quadrature of scf/hf.py with a
# per-point weight vector (atomic-grid weights are not uniform).
def vxc_lda(aoR, dm, w, xc):
    t = aoR @ dm
    rho = torch.clamp((t * aoR).sum(-1), min=0.0)
    exc, vrho, _ = xc.exc_vxc(rho)
    vmat = (aoR * (w * vrho)[:, None]).T @ aoR
    return torch.sum(w * rho * exc), vmat, torch.sum(w * rho)


def _gga_terms(aoR, ao_grad, dm):
    t = aoR @ dm
    rho = torch.clamp((t * aoR).sum(-1), min=0.0)
    grad_rho = 2.0 * torch.einsum("gi,xgi->xg", t, ao_grad)
    return rho, grad_rho, (grad_rho * grad_rho).sum(0)


def vxc_gga(aoR, ao_grad, dm, w, xc):
    rho, grad_rho, sigma = _gga_terms(aoR, ao_grad, dm)
    exc, vrho, vsigma = xc.exc_vxc(rho, sigma)
    aow = 0.5 * vrho[:, None] * aoR + 2.0 * torch.einsum(
        "xg,xgi->gi", grad_rho * vsigma, ao_grad)
    half = aoR.T @ (w[:, None] * aow)
    return torch.sum(w * rho * exc), half + half.T, torch.sum(w * rho)


def vxc_mgga(aoR, ao_grad, dm, w, xc):
    rho, grad_rho, sigma = _gga_terms(aoR, ao_grad, dm)
    tau = 0.5 * ((ao_grad @ dm) * ao_grad).sum((0, 2))
    exc, vrho, vsigma, vtau = xc.exc_vxc_mgga(rho, sigma, tau)
    aow = 0.5 * vrho[:, None] * aoR + 2.0 * torch.einsum(
        "xg,xgi->gi", grad_rho * vsigma, ao_grad)
    half = aoR.T @ (w[:, None] * aow)
    nao = aoR.shape[1]
    vtau_term = 0.5 * ((ao_grad * (w * vtau)[:, None]).reshape(-1, nao).T
                       @ ao_grad.reshape(-1, nao))
    return torch.sum(w * rho * exc), half + half.T + vtau_term, torch.sum(w * rho)


def vxc(aoR, ao_grad, dm, w, xc):
    """(e_xc, vxc, n_elec) on the Becke cloud for an LDA, GGA or meta-GGA
    (e_xc and n_elec as device scalars)."""
    if xc.family == "mgga":
        return vxc_mgga(aoR, ao_grad, dm, w, xc)
    if xc.family == "gga":
        return vxc_gga(aoR, ao_grad, dm, w, xc)
    return vxc_lda(aoR, dm, w, xc)

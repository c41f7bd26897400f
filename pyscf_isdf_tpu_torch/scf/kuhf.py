"""k-point sampled spin-polarised SCF (KUHF / KUKS, torch).

Combines the Bloch-orbital machinery of :mod:`pyscf_isdf_tpu_torch.scf.khf`
with the spin handling of :mod:`pyscf_isdf_tpu_torch.scf.uhf` (reference
semantics: pyscf/pbc/scf/kuhf.py, pyscf/pbc/dft/kuks.py): per-spin density
matrices at every k, Coulomb from the total density, exchange per spin, and
a global per-spin filling across k-points. J, K, Vxc, the eigensolves and
the DIIS extrapolation run on the system's device; the occupation sort and
DIIS's small linear solve on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df import fftdf_k
from pyscf_isdf_tpu_torch.ops import becke as becke_mod, coulomb
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.diis import DIIS
from pyscf_isdf_tpu_torch.scf.hf import rsh_coeffs
from pyscf_isdf_tpu_torch.scf.khf import (
    KSCFSystem, _eig_all, _trace, bloch_ao_gradients,
    exchange_engines_k,
)
from pyscf_isdf_tpu_torch.scf.occupations import exact_count_occ


def _occ_spin(mo_e_k, nocc_tot):
    """Exactly ``nocc_tot`` spin orbitals filled across k (a stable
    argsort, which does not overfill a degenerate level at the Fermi
    energy); per-k numpy arrays."""
    return exact_count_occ(mo_e_k, nocc_tot, scale=1.0)


def vxc_spin_kpts(aoR_k, ao_grad_k, dm_a, dm_b, weight, xcspec):
    """Spin-resolved k-point XC energy and potential matrices.

    The spin-polarised counterpart of :func:`scf.khf.vxc_kpts` (reference
    semantics: pyscf/pbc/dft/numint.py nr_uks): the densities are the
    k-averages sum_k Re tr(D_s[k] ao ao^*) / nk, and the GGA potential is
    the symmetrised 1/2 vrho ao + (2 vs_ss grad rho_s + vs_ab grad rho_t)
    . grad ao form. Returns (e_xc as a float, vxc_a, vxc_b), each vxc
    (nk, nao, nao) complex. Takes an LDA or GGA functional, as the
    reference's does. ``weight`` is the uniform grid's scalar or a
    per-point (ng,) tensor (Becke grids).
    """
    nk = aoR_k.shape[0]
    ta = aoR_k @ dm_a
    tb = aoR_k @ dm_b
    rho_a = torch.clamp((ta * aoR_k.conj()).sum((0, 2)).real / nk, min=0.0)
    rho_b = torch.clamp((tb * aoR_k.conj()).sum((0, 2)).real / nk, min=0.0)
    ao_h = aoR_k.conj().transpose(1, 2)

    per_point = torch.is_tensor(weight)

    def wsum(x):
        return float((weight * x).sum() if per_point else weight * x.sum())

    if xcspec.family != "gga":
        exc, (va, vb), _ = xcspec.exc_vxc_spin(rho_a, rho_b)
        if per_point:
            return (wsum((rho_a + rho_b) * exc), (ao_h * (weight * va)) @ aoR_k,
                    (ao_h * (weight * vb)) @ aoR_k)
        return (wsum((rho_a + rho_b) * exc),
                weight * ((ao_h * va) @ aoR_k), weight * ((ao_h * vb) @ aoR_k))
    if ao_grad_k is None:
        raise ValueError("vxc_spin_kpts: a GGA needs ao_grad_k")
    ga = 2.0 / nk * torch.einsum("kgj,kxgj->xg", ta.conj(), ao_grad_k).real
    gb = 2.0 / nk * torch.einsum("kgj,kxgj->xg", tb.conj(), ao_grad_k).real
    exc, (va, vb), (vsaa, vsab, vsbb) = xcspec.exc_vxc_spin(
        rho_a, rho_b, (ga * ga).sum(0), (ga * gb).sum(0), (gb * gb).sum(0))

    def vmat_k(vrho, vs_ss, g_s, g_t):
        aow = 0.5 * vrho[:, None] * aoR_k + torch.einsum(
            "xg,kxgi->kgi", (2.0 * vs_ss * g_s + vsab * g_t).to(aoR_k.dtype),
            ao_grad_k)
        half = ao_h @ (weight[:, None] * aow) if per_point else weight * (ao_h @ aow)
        return half + half.conj().transpose(1, 2)

    return (wsum((rho_a + rho_b) * exc),
            vmat_k(va, vsaa, ga, gb), vmat_k(vb, vsbb, gb, ga))


def kuhf_kernel(
    system: KSCFSystem,
    xc: Optional[str] = None,
    exxdiv: str = "ewald",
    nelec: Optional[tuple] = None,
    max_cycle: int = 100,
    conv_tol: float = 1e-10,
    diis_space: int = 8,
    df: str = "fftdf",
    isdf_c: float = 8.0,
    isdf_precision: Optional[str] = None,
    verbose: bool = False,
    xc_grids: str = "uniform",
    device=None,
    timer=None,
):
    """Run the k-point spin-polarised SCF on ``device`` (default: the GPU),
    where ``system`` must have been built. xc=None (or 'hf') -> KUHF, else
    KUKS with an LDA or GGA functional (the reference's KUKS takes no
    meta-GGA; one raises ``ValueError`` here too).

    Args:
        nelec: (n_alpha, n_beta) per cell; default from the cell's
            electron count and spin.
        df: 'fftdf' (exact pair-density FFT exchange) or 'isdf' (the
            shared-xi k-point ISDF factorization, one per kernel); a
            range-separated hybrid builds the full-range and long-range
            exchange of the engine. ``exxdiv`` 'vcut_sph' or 'vcut_ws'
            truncates the full-range exchange kernels of either engine.
        xc_grids: 'uniform' or 'becke[:n_rad,n_theta]' (the Becke
            atomic-grid XC quadrature, Bloch AOs per k-point).
        timer: optional StageTimer; records the Becke build stages.

    ``isdf_precision='dd'`` is not ported and raises ``NotImplementedError``.

    Returns a dict with e_tot (per cell), mo_energy and mo_coeff ((alpha,
    beta) per-k tensor lists), mo_occ ((alpha, beta) (nk, nmo) numpy),
    nelec, dm (D_alpha, D_beta) each (nk, nao, nao), converged, niter.
    """
    if isdf_precision is not None:
        raise NotImplementedError(f"isdf_precision={isdf_precision!r}: the "
                                  "port solves in float64")
    becke_mod.parse_xc_grids(xc_grids)
    if df not in ("fftdf", "isdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'fftdf' or 'isdf'")
    device = require_device(system.aoR_k, device)
    cell = system.cell
    nk = len(system.kpts)
    xcspec = XCSpec(xc) if xc is not None else None
    if xcspec is not None and xcspec.family == "mgga":
        raise ValueError(f"kuhf_kernel: {xcspec.name} is a meta-GGA; KUKS "
                         "takes an LDA or GGA functional")
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    is_dft = xcspec is not None and xcspec.family != "hf"
    mad_add = hyb * system.madelung
    if rsh:
        mad_add = hyb * system.madelung \
            + (alpha - hyb) * coulomb.madelung_omega(cell, system.kpts, omega)
    if nelec is None:
        na = (cell.nelectron + cell.spin) // 2
        nb = cell.nelectron - na
    else:
        na, nb = nelec

    aoR_k, mesh, weight = system.aoR_k, system.mesh, system.weight
    get_k_spin = None
    if need_k:
        fns = exchange_engines_k(system, df, isdf_c, omega if rsh else None,
                                 exxdiv=exxdiv)
        if rsh:
            def get_k_spin(dm):
                return hyb * fns[0](dm) + (alpha - hyb) * fns[1](dm)
        else:
            def get_k_spin(dm):
                return hyb * fns[0](dm)
    need_grad = is_dft and xcspec.family == "gga"
    becke = becke_mod.becke_xc_inputs(cell, xc_grids, need_grad, kpts=system.kpts,
                                      device=device, timer=timer) \
        if is_dft else None
    if becke is None:
        xc_ao, xc_w = aoR_k, weight
        xc_grad = bloch_ao_gradients(system) if need_grad else None
    else:
        xc_ao, xc_grad, xc_w, _ = becke

    S, hcore, X = system.S, system.hcore, system.X

    def occupations(mo_e, n):
        flat = torch.cat(mo_e).cpu().numpy()
        return _occ_spin(np.split(flat, np.cumsum([len(e) for e in mo_e])[:-1]),
                         n * nk)

    def make_dm(mo_c, occs):
        return torch.stack([
            (c * torch.as_tensor(o, dtype=c.dtype, device=device)) @ c.conj().T
            for c, o in zip(mo_c, occs)])

    mo_e, mo_c = _eig_all(hcore, X)
    occ_a, occ_b = occupations(mo_e, na), occupations(mo_e, nb)
    dm = torch.stack([make_dm(mo_c, occ_a), make_dm(mo_c, occ_b)])

    diis = DIIS(space=diis_space)
    e_last = 0.0
    conv = False
    for it in range(max_cycle):
        dm_t = dm[0] + dm[1]
        vj = fftdf_k.get_j_kpts(aoR_k, dm_t, system.coulG, mesh, weight)
        veff = vj.expand(2, -1, -1, -1).clone()
        e_xc = 0.0
        if is_dft:
            e_xc, vxc_a, vxc_b = vxc_spin_kpts(xc_ao, xc_grad, dm[0], dm[1],
                                               xc_w, xcspec)
            veff += torch.stack([vxc_a, vxc_b])
        e_k = 0.0
        if need_k:
            vk = torch.stack([get_k_spin(dm[0]), get_k_spin(dm[1])])
            if exxdiv == "ewald":
                vk = vk + mad_add * (S @ dm @ S)
            veff -= vk
            e_k = -0.5 * (_trace(dm[0], vk[0]) + _trace(dm[1], vk[1])) / nk

        F = hcore + veff
        sds = S @ dm @ F - F @ dm @ S
        err = torch.cat([(x.conj().T @ sds[s, k] @ x).reshape(-1)
                         for s in range(2) for k, x in enumerate(X)])
        F = diis.update(F, err)
        (ea, ca), (eb, cb) = _eig_all(F[0], X), _eig_all(F[1], X)
        occ_a, occ_b = occupations(ea, na), occupations(eb, nb)
        dm_new = torch.stack([make_dm(ca, occ_a), make_dm(cb, occ_b)])

        e1 = _trace(dm_t, hcore) / nk
        ecoul = 0.5 * _trace(dm_t, vj) / nk
        e_tot = float(e1 + ecoul + e_xc + e_k + system.e_nuc)
        de = abs(e_tot - e_last)
        err_norm = float(torch.linalg.norm(err)) / max(1, err.numel()) ** 0.5
        if verbose:
            print(f"cycle {it:3d}  E = {e_tot:.12f}  dE = {de:.2e}")
        dm = dm_new
        if de < conv_tol and err_norm < np.sqrt(conv_tol):
            conv = True
            break
        e_last = e_tot

    return {
        "e_tot": e_tot,
        "mo_energy": (ea, eb),
        "mo_coeff": (ca, cb),
        "mo_occ": (np.asarray(occ_a), np.asarray(occ_b)),
        "nelec": (na, nb),
        "dm": (dm[0], dm[1]),
        "converged": conv,
        "niter": it + 1,
    }

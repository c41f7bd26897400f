"""k-point restricted open-shell SCF (KROHF / KROKS, torch).

Roothaan single-Fock construction at every k-point (reference semantics:
pyscf/pbc/scf/krohf.py:383 built on pyscf/scf/rohf.py): per-spin
UHF-style veff combined into the projector-coupled effective Fock of
:func:`~pyscf_isdf_tpu_torch.scf.rohf.roothaan_fock`, batched over k, so
doubly-, singly-occupied and virtual spaces share one Bloch orbital set
per k. Occupations are a global fill across k: the lowest nb*nk orbitals
doubly occupied, the next (na-nb)*nk singly, counted exactly (see
:func:`_occupations`). J, K, Vxc, the eigensolves and DIIS's extrapolation
run on the system's device; the occupation sort and DIIS's small linear
solve on the host.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df import fftdf_k
from pyscf_isdf_tpu_torch.ops import coulomb
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.diis import DIIS
from pyscf_isdf_tpu_torch.scf.hf import rsh_coeffs
from pyscf_isdf_tpu_torch.scf.khf import (
    KSCFSystem, _eig_all, _trace, bloch_ao_gradients, exchange_engines_k,
)
from pyscf_isdf_tpu_torch.scf.kuhf import vxc_spin_kpts
from pyscf_isdf_tpu_torch.scf.rohf import roothaan_fock
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def _occupations(mo_e_k, n_docc, n_socc):
    """Global (2/1/0) fill across k: exactly ``n_docc`` doubly and
    ``n_socc`` singly occupied orbitals, in the order of a stable argsort
    of the k-stacked spectrum.

    The reference (pyscf_isdf_tpu/scf/krohf.py:27-42) fills every level
    within 1e-12 of the last doubly (singly) occupied energy, which puts
    more electrons in when that level is degenerate; the port counts
    exactly, as its other k-point fillings do.
    """
    flat = np.concatenate([np.asarray(e, dtype=np.float64) for e in mo_e_k])
    order = np.argsort(flat, kind="stable")
    occ = np.zeros(flat.size)
    occ[order[:n_docc]] = 2.0
    occ[order[n_docc:n_docc + n_socc]] = 1.0
    return np.split(occ, np.cumsum([len(e) for e in mo_e_k])[:-1])


def krohf_kernel(
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
    device=None,
    timer=None,
):
    """Run KROHF (xc=None or 'hf') or KROKS (LDA or GGA) to convergence on
    ``device`` (default: the GPU), where ``system`` must have been built.

    Args:
        nelec: (n_alpha, n_beta) per cell; default from the cell's
            electron count and spin.
        df: 'fftdf' (exact pair-density FFT exchange) or 'isdf' (the
            shared-xi k-point ISDF factorization); a range-separated
            hybrid builds the full-range and long-range exchange of the
            engine.
        timer: optional StageTimer; records each iteration as 'cycle'.

    ``isdf_precision='dd'`` is not ported and raises
    ``NotImplementedError``; a meta-GGA raises ``ValueError`` (KROKS takes
    an LDA or GGA functional, as KUKS does).

    Returns a dict with e_tot (per cell), mo_energy and mo_coeff (per-k
    tensor lists), mo_occ (per-k numpy arrays), dm (D_alpha, D_beta) each
    (nk, nao, nao), nelec, converged and niter.
    """
    if isdf_precision is not None:
        raise NotImplementedError(f"isdf_precision={isdf_precision!r}: the "
                                  "port solves in float64")
    if df not in ("fftdf", "isdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'fftdf' or 'isdf'")
    if exxdiv not in (None, "ewald"):
        raise NotImplementedError(f"exxdiv={exxdiv!r} with k-points")
    device = require_device(system.aoR_k, device)
    timer = timer or null_timer
    cell = system.cell
    nk = len(system.kpts)
    xcspec = XCSpec(xc) if xc is not None else None
    if xcspec is not None and xcspec.family == "mgga":
        raise ValueError(f"krohf_kernel: {xcspec.name} is a meta-GGA; KROKS "
                         "takes an LDA or GGA functional")
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    is_dft = xcspec is not None and xcspec.family != "hf"
    mad_add = hyb * system.madelung
    if rsh:
        mad_add = mad_add + (alpha - hyb) * coulomb.madelung_omega(cell, system.kpts, omega)
    if nelec is None:
        na = (cell.nelectron + cell.spin) // 2
        nb = cell.nelectron - na
    else:
        na, nb = nelec
    if na < nb:
        raise ValueError(f"nelec {nelec}: KROHF needs n_alpha >= n_beta")

    aoR_k, mesh, weight = system.aoR_k, system.mesh, system.weight
    get_k_spin = None
    if need_k:
        fns = exchange_engines_k(system, df, isdf_c, omega if rsh else None)

        def get_k_spin(dm):
            vk = hyb * fns[0](dm)
            if rsh:
                vk = vk + (alpha - hyb) * fns[1](dm)
            return vk
    ao_grad_k = None
    if is_dft and xcspec.family == "gga":
        ao_grad_k = bloch_ao_gradients(system)

    S, hcore, X = system.S, system.hcore, system.X

    def occupations(mo_e):
        flat = torch.cat(mo_e).cpu().numpy()
        e_host = np.split(flat, np.cumsum([len(e) for e in mo_e])[:-1])
        return _occupations(e_host, nb * nk, (na - nb) * nk)

    def make_dm(mo_c, occs, keep):
        return torch.stack([
            (c * torch.as_tensor(keep(o), dtype=c.dtype, device=device)) @ c.conj().T
            for c, o in zip(mo_c, occs)])

    mo_e, mo_c = _eig_all(hcore, X)
    diis = DIIS(space=diis_space)
    e_last = 0.0
    conv = False
    for it in range(max_cycle):
        with timer("cycle"):
            occs = occupations(mo_e)
            dm = torch.stack([make_dm(mo_c, occs, lambda o: (o >= 1).astype(float)),
                              make_dm(mo_c, occs, lambda o: (o == 2).astype(float))])
            dm_t = dm[0] + dm[1]
            vj = fftdf_k.get_j_kpts(aoR_k, dm_t, system.coulG, mesh, weight)
            veff = vj.expand(2, -1, -1, -1).clone()
            e_xc = 0.0
            if is_dft:
                e_xc, vxc_a, vxc_b = vxc_spin_kpts(aoR_k, ao_grad_k, dm[0], dm[1],
                                                   weight, xcspec)
                veff += torch.stack([vxc_a, vxc_b])
            e_k = 0.0
            if need_k:
                vk = torch.stack([get_k_spin(dm[0]), get_k_spin(dm[1])])
                if exxdiv == "ewald":
                    vk = vk + mad_add * (S @ dm @ S)
                veff -= vk
                e_k = -0.5 * (_trace(dm[0], vk[0]) + _trace(dm[1], vk[1])) / nk

            R = roothaan_fock(hcore + veff[0], hcore + veff[1], dm[0], dm[1], S)
            sds = S @ dm_t @ R - R @ dm_t @ S
            err = torch.cat([(x.conj().T @ sds[k] @ x).reshape(-1)
                             for k, x in enumerate(X)])
            R = diis.update(R, err)
            mo_e, mo_c = _eig_all(R, X)

            e1 = _trace(dm_t, hcore) / nk
            ecoul = 0.5 * _trace(dm_t, vj) / nk
            e_tot = float(e1 + ecoul + e_xc + e_k + system.e_nuc)
            de = abs(e_tot - e_last)
            err_norm = float(torch.linalg.norm(err)) / max(1, err.numel()) ** 0.5
            if verbose:
                print(f"cycle {it:3d}  E = {e_tot:.12f}  dE = {de:.2e}  |err| = {err_norm:.2e}")
            if de < conv_tol and err_norm < np.sqrt(conv_tol):
                conv = True
                break
            e_last = e_tot

    return {
        "e_tot": e_tot,
        "mo_energy": mo_e,
        "mo_coeff": mo_c,
        "mo_occ": occupations(mo_e),
        "dm": (dm[0], dm[1]),
        "nelec": (na, nb),
        "converged": conv,
        "niter": it + 1,
    }

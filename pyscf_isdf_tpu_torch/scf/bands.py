"""Band energies at arbitrary k-points from a converged density (torch).

Reference semantics: pyscf/pbc/scf/khf.py:581-607 (``get_bands``) — build
the Fock operator from the converged density at new "band" k-points and
diagonalize. Hartree, LDA, GGA, hybrid and range-separated functionals:

  * local part: J + Vxc from the converged density on the grid; GGA
    matrix elements use the band k-point's spectral AO gradients with
    grad rho from the SCF density;
  * exact exchange: pair-density FFT build between band AOs and every
    density k-point (:func:`~pyscf_isdf_tpu_torch.df.fftdf_k.get_k_band`);
    the ewald probe-charge shift is applied only where a band k coincides
    with a density k (|kb - k| < 1e-8), as in the reference.

The band k-points go through in batches (AOs, S/T, the Fock builds, the
exchange sums and the eigensolves on the device; the nonlocal PP one
band k-point at a time); the kernels coulG(k2 - kb) are built on the host
once per distinct transfer.

Bands evaluated at the SCF k-points reproduce the converged mo_energy.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.df import fftdf, fftdf_k
from pyscf_isdf_tpu_torch.ops import coulomb, pp as pp_ops
from pyscf_isdf_tpu_torch.ops.ao_eval import (
    ao_gradient_fft, ao_gradient_fft_k, eval_ao_kpts,
)
from pyscf_isdf_tpu_torch.ops.ft_ao import overlap_and_kinetic
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.hf import rsh_coeffs
from pyscf_isdf_tpu_torch.scf.khf import _eig_all, bloch_ao_gradients, orthogonalizers

# elements of one batch's largest tables: the band AOs (nb, ng, nao), the
# kernels and phases (nb, nk, ng), one FFT chunk (rows, nao, ng)
_BAND_BLOCK = 1 << 24


class _PairKernels:
    """coulG(k2 - kb) per transfer, built on the host once per distinct q."""

    def __init__(self, cell, kpts_scf, exxdiv, omega, device):
        self.args = dict(exxdiv=exxdiv, kpts=kpts_scf, omega=omega)
        self.cell, self.kpts, self.device = cell, kpts_scf, device
        self._cache = {}

    def __call__(self, kb):
        """(nb, nk, ng) kernels of the band k-points ``kb`` (nb, 3)."""
        out = []
        for k in kb:
            row = []
            for k2 in self.kpts:
                q = k2 - k
                key = tuple(np.round(q, 12))
                if key not in self._cache:
                    self._cache[key] = coulomb.get_coulG(self.cell, k=q, **self.args)
                row.append(self._cache[key])
            out.append(np.stack(row))
        return torch.as_tensor(np.stack(out), dtype=torch.float64, device=self.device)


def get_bands(system, scf_res, kpts_band, xc=None, exxdiv="ewald", device=None):
    """Band eigenvalues and vectors at ``kpts_band`` on ``device``
    (default: the GPU), where ``system`` must have been built.

    Args:
        system: SCFSystem (Gamma) or KSCFSystem with converged grid data.
        scf_res: result dict of scf_kernel / kscf_kernel (uses its dm).
        kpts_band: (nb, 3) or (3,) band k-points (1/Bohr).
        xc: the functional the SCF was run with (None -> Hartree-Fock).
            A meta-GGA raises ``ValueError``, as the reference's does (its
            band Fock has no tau term).
        exxdiv: 'ewald' (the probe-charge shift at band k-points on the
            SCF set) or 'vcut_sph' (the spherically truncated exchange
            kernel, radius from the SCF k-mesh; no shift).

    Returns (mo_energy (nb, nmo) tensor, mo_coeff list of (nao, nmo)
    tensors); a list of energies instead when the band k-points keep
    different orthogonalizer ranks.
    """
    is_k = hasattr(system, "aoR_k")
    device = require_device(system.aoR_k if is_k else system.aoR, device)
    cell, mesh, weight = system.cell, system.mesh, system.weight
    xcspec = XCSpec(xc) if xc is not None else None
    if xcspec is not None and xcspec.family == "mgga":
        raise ValueError(f"get_bands: {xcspec.name} is a meta-GGA; the band "
                         "Fock takes an LDA, GGA or hybrid functional")
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    is_dft = xcspec is not None and xcspec.family != "hf"
    is_gga = is_dft and xcspec.family == "gga"
    f64 = dict(dtype=torch.float64, device=device)
    cdt = torch.complex128

    # the converged density (and its gradient for a GGA) on the grid
    grho = None
    if is_k:
        aoR_k, kpts_scf = system.aoR_k, np.asarray(system.kpts)
        nk = aoR_k.shape[0]
        dm_k = torch.as_tensor(scf_res["dm"], device=device).to(cdt)
        t = aoR_k @ dm_k
        rho = (t * aoR_k.conj()).sum((0, 2)).real / nk
        if is_gga:
            grho = 2.0 / nk * torch.einsum("kgj,kxgj->xg", t.conj(),
                                           bloch_ao_gradients(system)).real
    else:
        aoR_k, kpts_scf, nk = system.aoR[None].to(cdt), np.zeros((1, 3)), 1
        dm = torch.as_tensor(scf_res["dm"], device=device).to(system.aoR.dtype)
        dm_k = dm[None].to(cdt)
        rho = fftdf.get_rho(system.aoR, dm)
        if is_gga:
            ao_grad = ao_gradient_fft(system.aoR, mesh, system.Gv)
            grho = 2.0 * torch.einsum("gi,xgi->xg", system.aoR @ dm, ao_grad)

    vR = fftdf.ifft3(system.coulG * fftdf.fft3(rho.to(cdt), mesh), mesh).real
    vrho = vsigma = None
    if is_dft:
        rho_c = torch.clamp(rho, min=1e-30)
        if is_gga:
            sigma = torch.clamp((grho * grho).sum(0), min=1e-30)
            _, vrho, vsigma = xcspec.exc_vxc(rho_c, sigma)
        else:
            _, vrho, _ = xcspec.exc_vxc(rho_c)
            vR = vR + vrho
    v_pp = pp_ops.vpploc_real(cell) if cell.pseudos else pp_ops.vnuc_real(cell)
    # the band Fock's local potential: the PP (its ifft carries the grid
    # weight) and J + Vxc at the grid weight
    v_loc = torch.as_tensor(v_pp, **f64) + weight * vR

    kernels, kernels_lr = None, None
    mad_add = 0.0
    if need_k:
        kernels = _PairKernels(cell, kpts_scf, "vcut_sph" if exxdiv == "vcut_sph" else None,
                               None, device)
        mad_add = hyb * coulomb.madelung(cell, kpts_scf)
        if rsh:
            kernels_lr = _PairKernels(cell, kpts_scf, None, omega, device)
            mad_add += (alpha - hyb) * coulomb.madelung_omega(cell, kpts_scf, omega)

    coords = torch.as_tensor(cell.uniform_grid(), **f64)
    Gv = torch.as_tensor(cell.get_Gv(), **f64)
    kscf_t = torch.as_tensor(kpts_scf, **f64)
    kpts_band = np.reshape(np.asarray(kpts_band, dtype=np.float64), (-1, 3))
    ng, nao = aoR_k.shape[1], aoR_k.shape[2]
    block = max(1, _BAND_BLOCK // (ng * max(nk, nao)))
    chunk = max(1, _BAND_BLOCK // (ng * nao))
    es, cs = [], []
    for b0 in range(0, len(kpts_band), block):
        kb = kpts_band[b0:b0 + block]
        kb_t = torch.as_tensor(kb, **f64)
        aoRb = eval_ao_kpts(cell, kb, device=device)                 # (n, ng, nao)
        S, F = overlap_and_kinetic(cell, kpt=kb, device=device)       # (n, nao, nao)
        if cell.pseudos:
            F = F + torch.stack([pp_ops.get_vppnl(cell, kpt=k, device=device).to(cdt)
                                 for k in kb])
        aoRb_h = aoRb.conj().transpose(1, 2)
        F = F + (aoRb_h * v_loc) @ aoRb
        if is_gga:
            grad_b = torch.stack([ao_gradient_fft_k(aoRb[i], mesh, Gv, kb_t[i], coords)
                                  for i in range(len(kb))])          # (n, 3, ng, nao)
            aow = 0.5 * vrho[:, None] * aoRb + 2.0 * torch.einsum(
                "xg,nxgi->ngi", (grho * vsigma).to(cdt), grad_b)
            half = weight * (aoRb_h @ aow)
            F = F + half + half.conj().transpose(1, 2)
        if need_k:
            phase = torch.exp(-1j * (coords @ (kscf_t[None] - kb_t[:, None]).transpose(1, 2)
                                     ).transpose(1, 2))             # (n, nk, ng)
            vk = hyb * fftdf_k.get_k_band(aoRb, aoR_k, dm_k, kernels(kb), phase, mesh,
                                          weight / nk, chunk=chunk)
            if rsh:
                vk = vk + (alpha - hyb) * fftdf_k.get_k_band(
                    aoRb, aoR_k, dm_k, kernels_lr(kb), phase, mesh, weight / nk,
                    chunk=chunk)
            if exxdiv == "ewald":
                for i, k in enumerate(kb):
                    hits = np.nonzero(np.linalg.norm(kpts_scf - k, axis=1) < 1e-8)[0]
                    if len(hits):
                        vk[i] += mad_add * (S[i] @ dm_k[hits[0]] @ S[i])
            F = F - 0.5 * vk
        e, c = _eig_all(F, orthogonalizers(S))
        es.extend(e)
        cs.extend(c)
    if len({e.shape[0] for e in es}) == 1:
        es = torch.stack(es)
    return es, cs

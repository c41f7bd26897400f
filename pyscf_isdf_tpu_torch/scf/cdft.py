"""Constrained DFT: external-potential shifts and charge constraints (torch).

Reference: pyscf/pbc/dft/cdft.py (orbital-shift cDFT, whose reported
energy is the plain functional of the constrained density) and the
charge-constraint method it points to (a Lagrange multiplier on a
fragment population, optimized so the constraint is met at SCF
convergence). The Gamma SCF takes a one-body ``v_ext`` added to the Fock
matrix and left out of the energy; this module builds the two constraint
potentials on top:

  * :func:`orbital_shift` — shift one orbital by a constant:
    V = offset * S c c^T S / (c^T S c);
  * :func:`lowdin_population_op` + :func:`cdft_kernel` — hold the Loewdin
    population of a set of AOs at a target by a secant iteration on the
    multiplier of V = lam * P, each inner SCF started from the previous
    density.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.scf.hf import scf_kernel


def orbital_shift(S, coeff, offset: float):
    """Projector potential shifting one orbital by ``offset`` Hartree.

    Args:
        S: (nao, nao) overlap tensor.
        coeff: (nao,) orbital coefficients in the AO basis (any
            normalization; the projector normalizes by c^T S c).
    """
    c = torch.as_tensor(coeff, dtype=torch.float64, device=S.device).reshape(-1)
    Sc = S @ c
    return offset * torch.outer(Sc, Sc) / float(c @ Sc)


def lowdin_population_op(S, ao_indices: Sequence[int]):
    """Loewdin population operator of a fragment: N = tr(P D) with
    P = S^1/2 diag(w) S^1/2, w selecting the fragment AOs."""
    w, v = torch.linalg.eigh(S)
    s_half = (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T
    sel = torch.zeros(S.shape[0], dtype=S.dtype, device=S.device)
    sel[torch.as_tensor(list(ao_indices), dtype=torch.long, device=S.device)] = 1.0
    return (s_half * sel) @ s_half


def cdft_kernel(
    system,
    xc: Optional[str],
    ao_indices: Sequence[int],
    target: float,
    lam0: float = 0.0,
    lam1: float = 0.5,
    tol: float = 1e-6,
    max_outer: int = 30,
    device=None,
    **scf_kwargs,
):
    """Charge-constrained SCF on ``device`` (default: the GPU), where
    ``system`` must have been built: find lam so that the Loewdin
    population of ``ao_indices`` equals ``target`` at convergence of
    ``scf_kernel(..., v_ext=lam * P)``.

    Returns the converged SCF result dict extended with ``lam`` (the
    multiplier), ``population``, ``constraint_op`` and ``n_scf`` (the
    inner SCFs run).
    """
    require_device(system.aoR, device)
    P = lowdin_population_op(system.S, ao_indices)
    state = {"dm": scf_kwargs.pop("dm0", None), "n": 0}

    def population(lam):
        res = scf_kernel(system, xc=xc, v_ext=lam * P, dm0=state["dm"], **scf_kwargs)
        state.update(dm=res["dm"], res=res, n=state["n"] + 1)
        return float(torch.einsum("ij,ji->", P, res["dm"]))

    # secant iteration on the multiplier (population decreases with lam)
    n0 = population(lam0)
    if abs(n0 - target) < tol:
        lam1, n1 = lam0, n0
    else:
        n1 = population(lam1)
    it = 0
    while abs(n1 - target) > tol and it < max_outer:
        if abs(n1 - n0) < 1e-14:
            raise RuntimeError("cdft: population insensitive to the multiplier "
                               "(constraint unreachable)")
        lam0, lam1 = lam1, lam1 + (target - n1) * (lam1 - lam0) / (n1 - n0)
        n0 = n1
        n1 = population(lam1)
        it += 1
    if abs(n1 - target) > tol:
        raise RuntimeError(
            f"cdft: constraint not met after {max_outer} outer iterations "
            f"(population {n1:.6f}, target {target:.6f})")
    res = dict(state["res"])
    res.update(lam=float(lam1), population=float(n1), constraint_op=P, n_scf=state["n"])
    return res

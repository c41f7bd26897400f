"""k-point SCF on the irreducible Brillouin zone (KRHF/KRKS with ksymm, torch).

IBZ analog of :mod:`pyscf_isdf_tpu_torch.scf.khf` (reference semantics:
pyscf/pbc/scf/khf_ksymm.py + pyscf/pbc/lib/kpts.py:32,369,441-631): the
density is carried at nk_ibz irreducible k-points with integer weights and
expanded to the full BZ once per cycle on the device through the
space-group AO rotations (:func:`pyscf_isdf_tpu_torch.symm.expand_dm`,
one batched product with a rotation table built once). Per-iteration
savings against the full-BZ loop:

  - eigensolves, DIIS state and occupations: nk_ibz instead of nk,
  - the exchange build's band loop: nk_ibz x nk instead of nk x nk (the
    pair-density FFT engine and the ISDF GEMM engine take ``k1_idx``).

J and Vxc come from the full-BZ density; their matrix elements (a
(nk, ng, nao) product, small beside the exchange) are kept at the IBZ
k-points.

The loop is :func:`pyscf_isdf_tpu_torch.scf.khf.kscf_kernel`'s, given the
reduction as data (band rows, weights, expansion); this module computes
the reduction and hands it over.

The expansion itself is exact (the AO rotation matrices are covariant to
machine precision); residual IBZ-vs-full-BZ energy differences are the
grid's own symmetry-breaking collocation error, which vanishes with mesh
convergence.
"""
from __future__ import annotations

from typing import Optional

from pyscf_isdf_tpu_torch import symm
from pyscf_isdf_tpu_torch.scf.khf import KSCFSystem, kscf_kernel
from pyscf_isdf_tpu_torch.scf.khf import _weighted_occ  # noqa: F401  (reference name)


def kscf_ibz_kernel(
    system: KSCFSystem,
    info: Optional[symm.IBZInfo] = None,
    xc: Optional[str] = None,
    exxdiv: str = "ewald",
    max_cycle: int = 60,
    conv_tol: float = 1e-10,
    diis_space: int = 8,
    df: str = "fftdf",
    isdf_c: float = 8.0,
    isdf_precision: Optional[str] = None,
    sigma: float = 0.0,
    smearing_method: str = "fermi",
    xc_grids: str = "uniform",
    verbose: bool = False,
    device=None,
    timer=None,
):
    """Run the IBZ k-point SCF on ``device`` (default: the GPU), where
    ``system`` must have been built. xc=None -> KRHF ('hf' too), else KRKS.

    ``system`` must be built on the FULL k-point set (the one-time setup
    keeps full-BZ AO values for the exchange sum); the iteration state
    lives on the IBZ of ``info`` (default: :func:`symm.make_kpts_ibz` of
    the system's k-points). ``df`` is 'fftdf' or 'isdf' (the shared-xi
    k-point factorization at ``isdf_c``); a range-separated hybrid
    combines the engine's full-range and long-range exchange as in
    ``kscf_kernel``.

    ``sigma > 0`` enables finite-temperature occupations over the
    WEIGHTED IBZ spectrum (occupations.smearing_occ_ibz — the
    symmetry-reduced chemical-potential search); the result then also
    carries ``entropy``, ``mu`` and ``e_free`` in the same conventions
    as the full-BZ driver. ``timer`` records each iteration as 'cycle'.

    ``isdf_precision='dd'`` is not ported and raises
    ``NotImplementedError``; a Becke ``xc_grids`` integrates the expanded
    full-zone density on the Becke cloud.

    Returns a dict with e_tot, mo_energy, mo_coeff (per-IBZ-k tensor
    lists), mo_occ (per-IBZ-k numpy arrays), dm (nk_ibz, nao, nao),
    dm_full (nk, nao, nao), converged, niter, ibz (the IBZInfo), entropy,
    mu and e_free.
    """
    if df not in ("fftdf", "isdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'fftdf' or 'isdf'")
    if info is None:
        info = symm.make_kpts_ibz(system.cell, system.kpts)
    return kscf_kernel(system, xc=xc, exxdiv=exxdiv, max_cycle=max_cycle,
                       conv_tol=conv_tol, diis_space=diis_space, df=df,
                       isdf_c=isdf_c, isdf_precision=isdf_precision,
                       verbose=verbose, sigma=sigma,
                       smearing_method=smearing_method, xc_grids=xc_grids,
                       device=device, timer=timer, ibz=info)

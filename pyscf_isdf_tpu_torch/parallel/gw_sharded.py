"""Frequency-split G0W0: the imaginary-axis self-energy over the ranks.

The GW-AC workload (``gw/rgw.py``) is a sum over quadrature frequencies of
independent Pi-build / dielectric-solve / W-contraction programs. Here the
frequency axis is split into contiguous shares, one per rank; each rank
runs the same chunked program (:func:`~pyscf_isdf_tpu_torch.gw.rgw._sigma_iw_batched`)
on its share, and one all_reduce sums the self-energy. There is no other
traffic.

Zero-weight padding makes any nw divisible by the world size without
changing the quadrature (padded frequencies carry weight 0, at frequency
1.0).
"""
from __future__ import annotations

import numpy as np

from pyscf_isdf_tpu_torch.gw.rgw import _sigma_iw_batched


def sigma_iw_sharded(Lmo, mo_energy, nocc, freqs, wts, omega_grid, ef, mesh):
    """Distributed drop-in for :func:`~pyscf_isdf_tpu_torch.gw.rgw._sigma_iw_batched`.

    ``mesh`` is this rank's :class:`~pyscf_isdf_tpu_torch.parallel.mesh.RankGroup`;
    every rank passes the same replicated inputs and gets the same
    (nmo, nw_sigma) complex self-energy on the device of ``Lmo``.
    """
    P, r = mesh.world, mesh.rank
    freqs = np.asarray(freqs, dtype=np.float64)
    wts = np.asarray(wts, dtype=np.float64)
    pad = (-len(freqs)) % P
    freqs_p = np.concatenate([freqs, np.ones(pad)])
    wts_p = np.concatenate([wts, np.zeros(pad)])
    n = len(freqs_p) // P
    share = slice(r * n, (r + 1) * n)
    sig = _sigma_iw_batched(Lmo, mo_energy, nocc, freqs_p[share], wts_p[share],
                            omega_grid, ef)
    return mesh.all_reduce(sig)

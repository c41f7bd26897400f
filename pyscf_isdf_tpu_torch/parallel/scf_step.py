"""One grid-split SCF iteration (the multi-rank hot loop).

One step: dm -> (J by the distributed Poisson solve, K by replicated ISDF
GEMMs, LDA Vxc with the quadrature summed over the ranks) -> Fock ->
eigensolve -> new dm. Grid-sized tensors live as x-slabs, one per rank;
nao-sized matrices are replicated.
"""
from __future__ import annotations

import torch

from pyscf_isdf_tpu_torch.df import isdf as isdf_mod
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.parallel import distributed_fft as dfft


def lda_spec(xc):
    """The XCSpec of ``xc`` (None: Hartree-Fock, no XC). The grid-split steps
    take local functionals only: LDA-type, with the exact-exchange weight
    of the spec."""
    if xc is None:
        return None
    spec = XCSpec(xc)
    if spec.family != "lda" or spec.omega:
        raise ValueError(f"{xc!r}: the grid-split SCF step takes xc=None or an "
                         "LDA-type functional")
    return spec


def make_scf_step(dev_mesh, mesh3, weight, nocc, xc: str | None = None,
                  exxdiv_madelung: float = 0.0):
    """Build one rank's split SCF-iteration function.

    Returns ``step(dm, aoR, coulG_t, isdf, hcore, X, S) -> (dm_new, e_elec)``
    where ``aoR`` is this rank's x-slab (ngrids / P, nao) and ``coulG_t``
    this rank's slab of
    :func:`~pyscf_isdf_tpu_torch.parallel.distributed_fft.coulG_transposed_layout`;
    the other arguments are replicated, and so are the results (e_elec a
    0-d tensor).
    """
    grp = dev_mesh
    mesh3 = tuple(mesh3)
    xcspec = lda_spec(xc)
    hyb = 1.0 if xcspec is None else xcspec.hyb

    def grid_part(aoR_l, coulG_t_l, dm):
        rho_l = ((aoR_l @ dm) * aoR_l).sum(-1)
        vR_l = dfft.poisson_slab(rho_l, coulG_t_l, mesh3, grp)
        parts = [weight * ((aoR_l.T * vR_l) @ aoR_l)]
        if xcspec is not None:
            exc, vrho, _ = xcspec.exc_vxc(rho_l)
            parts.append(weight * ((aoR_l.T * vrho) @ aoR_l))
            e_xc = weight * (rho_l * exc).sum()
        else:
            parts.append(torch.zeros_like(parts[0]))
            e_xc = torch.zeros((), dtype=aoR_l.dtype, device=aoR_l.device)
        # one all_reduce for vj, vxc and e_xc
        flat = torch.cat([parts[0].reshape(-1), parts[1].reshape(-1), e_xc[None]])
        flat = grp.all_reduce(flat)
        n = dm.numel()
        return flat[:n].reshape(dm.shape), flat[n:2 * n].reshape(dm.shape), flat[-1]

    def step(dm, aoR, coulG_t, isdf, hcore, X, S):
        vj, vxc, e_xc = grid_part(aoR, coulG_t, dm)
        veff = vj + vxc
        e_k = torch.zeros((), dtype=dm.dtype, device=dm.device)
        if hyb > 0:
            vk = isdf_mod.get_k(isdf, dm)
            vk = vk + exxdiv_madelung * (S @ dm @ S)
            veff = veff - 0.5 * hyb * vk
            e_k = -0.25 * hyb * torch.einsum("ij,ji->", dm, vk)
        F = hcore + veff
        e, u = torch.linalg.eigh(X.T @ F @ X)
        Cocc = (X @ u)[:, :nocc]
        dm_new = 2.0 * Cocc @ Cocc.T
        e_elec = (torch.einsum("ij,ji->", dm, hcore)
                  + 0.5 * torch.einsum("ij,ji->", dm, vj) + e_xc + e_k)
        return dm_new, e_elec

    return step

"""Fixed-count one-program SCF with simple density mixing (Gamma point).

The reference compiles a fixed number of Fock-build / eigensolve /
mixing cycles into one XLA program (``lax.fori_loop``): J via the FFT
Poisson solve, K via ISDF GEMMs for a hybrid, the XC potential, the
eigensolve and the mixed density. The port runs the same cycle through
:func:`pyscf_isdf_tpu_torch.scf.jit_diis.run_cycles`: on the GPU the
first cycle eagerly, then replays of two CUDA graphs around the eager
eigensolve, ``n_iter`` cycles in all with no convergence test.
"""
from __future__ import annotations

import torch

from pyscf_isdf_tpu_torch.df import fftdf, isdf as isdf_mod
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.hf import _vxc
from pyscf_isdf_tpu_torch.scf.jit_diis import _Driver, run_cycles


def make_jit_scf(system, xc="lda,vwn", hyb_df=None, n_iter: int = 30,
                 mixing: float = 0.3):
    """Build ``run(dm0) -> (dm, e_elec)`` running ``n_iter`` cycles.

    Args:
        hyb_df: a built ISDF factorization when the functional is a global
            hybrid or HF (range-separated hybrids need
            :func:`~pyscf_isdf_tpu_torch.scf.jit_diis.make_jit_scf_diis`).
        mixing: linear density mixing factor (new = m*new + (1-m)*old).

    ``e_elec`` (without e_nuc) is the energy of the last cycle's input
    density; the returned callable's ``stats`` hold the last run's cycle
    count, capture seconds and per-cycle times.
    """
    xcspec = XCSpec(xc) if xc is not None else None
    hyb = 1.0 if xcspec is None else xcspec.hyb
    if xcspec is not None and xcspec.omega:
        raise ValueError(f"{xc}: range-separated functionals need make_jit_scf_diis")
    if hyb > 0 and hyb_df is None:
        raise ValueError("hybrid jit SCF needs a built ISDF (hyb_df)")
    is_dft = xcspec is not None and xcspec.family != "hf"
    aoR = system.aoR
    dtype, device = aoR.dtype, aoR.device
    mesh, w = system.mesh, system.weight
    coulG = system.coulG
    hcore, X, S = (system.hcore.to(dtype), system.X.to(dtype), system.S.to(dtype))
    mad = system.madelung
    nocc = system.nelec // 2
    nrank = X.shape[1]
    ao_grad = None
    if is_dft and xcspec.family in ("gga", "mgga"):
        ao_grad = ao_gradient_fft(aoR, mesh, system.Gv)

    def run(dm0):
        kw = dict(dtype=dtype, device=device)
        dm = torch.as_tensor(dm0, **kw).clone(memory_format=torch.contiguous_format)
        e_elec = torch.zeros((), **kw)
        Fp = torch.zeros((nrank, nrank), **kw)
        u = torch.zeros((nrank, nrank), **kw)

        def fock():                                     # graph A
            vj = fftdf.get_j(aoR, dm, coulG, mesh, w)
            veff = vj
            e = torch.einsum("ij,ji->", dm, hcore) + 0.5 * torch.einsum("ij,ji->", dm, vj)
            if is_dft:
                e_xc, vxc, _ = _vxc(aoR, ao_grad, dm, w, xcspec)
                veff = veff + vxc
                e = e + e_xc
            if hyb > 0:
                vk = isdf_mod.get_k(hyb_df, dm) + mad * (S @ dm @ S)
                veff = veff - 0.5 * hyb * vk
                e = e - 0.25 * hyb * torch.einsum("ij,ji->", dm, vk)
            e_elec.copy_(e)
            Fp.copy_(X.T @ (hcore + veff) @ X)

        def eig():                                      # eager
            u.copy_(torch.linalg.eigh(Fp)[1])

        def mix():                                      # graph B
            C = X @ u[:, :nocc]
            dm.copy_(mixing * (2.0 * C @ C.T) + (1 - mixing) * dm)

        stats = run_cycles([(fock, True), (eig, False), (mix, True)], device, n_iter)
        return (dm, float(e_elec)), stats

    return _Driver(run)


def run_scf_jit(system, xc="lda,vwn", n_iter: int = 30, isdf_c: float = 8.0,
                mixing: float = 0.3, dm0=None):
    """Convenience wrapper: build the ISDF factorization for a hybrid, run,
    return (e_tot, dm), the density on the system's device."""
    xcspec = XCSpec(xc) if xc is not None else None
    hyb = 1.0 if xcspec is None else xcspec.hyb
    hyb_df = None
    if hyb > 0:
        hyb_df = isdf_mod.build_isdf(system.aoR, system.coulG, system.mesh,
                                     system.weight, c=isdf_c)
    run = make_jit_scf(system, xc=xc, hyb_df=hyb_df, n_iter=n_iter, mixing=mixing)
    nao = system.aoR.shape[1]
    if dm0 is None:
        dm0 = 2.0 / nao * torch.eye(nao, dtype=torch.float64)
    dm, e_elec = run(dm0)
    return e_elec + system.e_nuc, dm

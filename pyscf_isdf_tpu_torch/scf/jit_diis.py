"""One-program SCF with in-loop CDIIS: the SCF cycle as CUDA-graph replays.

The reference runs the whole SCF as one XLA program (``jax.jit`` around a
``lax.while_loop``): per cycle J (FFT Poisson), K (ISDF GEMMs or exact
FFT exchange), Vxc, the Fock matrix, a CDIIS extrapolation over a
fixed-size circular history (a small static-shape bordered solve), the
eigensolves and the new density, and a convergence test on
(dE, ||[F,D]||) deciding whether to go on.

The port keeps that loop's state on the device in static tensors (``it``,
``dm``, ``e_last``, ``de``, ``errn``, the Fock and error histories,
``cnt``) and writes one cycle as functions that update them in place. On
the GPU (:func:`run_cycles`) the first cycle runs eagerly on a side
stream, which creates the cuFFT plans and the cuBLAS/cuSOLVER workspaces;
the cycle is then captured into CUDA graphs and replayed. The loop test
``(it < max_cycle) & ((de > tol) | (errn > sqrt(tol)))`` is computed on
the device, and one flag is copied to pinned host memory after each
cycle, so the iteration count is the reference's. ``torch.linalg.eigh``
checks its error code on the host, which a capture does not allow, so
each cycle is two graphs with the eager eigensolve between them: graph A
builds the Fock matrix, the energy and the DIIS extrapolation; graph B
forms the density and the convergence scalars. A capture or replay that
fails raises; the driver never falls back to an eager loop. On the CPU
the same cycle functions run eagerly in the same loop.

Two entry points, as the reference's:
  * :func:`make_jit_scf_diis` / :func:`run_scf_jit_diis`: Gamma point.
  * :func:`make_kscf_jit_diis` / :func:`run_kscf_jit_diis`: k-point
    sampled, complex, batched over k, exact-count filling across k.
"""
from __future__ import annotations

import math
import time

import torch

from pyscf_isdf_tpu_torch.df import fftdf, fftdf_k
from pyscf_isdf_tpu_torch.ops import coulomb
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft
from pyscf_isdf_tpu_torch.ops.xc import XCSpec
from pyscf_isdf_tpu_torch.scf.hf import _vxc, exchange_engines, rsh_coeffs
from pyscf_isdf_tpu_torch.scf.khf import _vxc_k, bloch_ao_gradients, exchange_engines_k


def run_cycles(cycle, device, max_cycle: int, flag=None) -> dict:
    """Run one SCF cycle after another on ``device``.

    Args:
        cycle: sequence of (fn, capturable) steps of one cycle; each ``fn()``
            updates static tensors in place and reads no value on the host.
            On CUDA a capturable step is replayed from a CUDA graph, the
            others run eagerly between the replays.
        max_cycle: the most cycles to run.
        flag: device bool scalar the cycle sets to "go on"; None runs
            exactly ``max_cycle`` cycles.

    Returns stats: ``cycles`` run, on CUDA ``capture_s`` (seconds to
    capture the graphs) and ``cycle_ms`` (CUDA-event milliseconds of each
    replayed cycle, eager steps and the flag read included).
    """
    stats = {"cycles": 0, "capture_s": None, "cycle_ms": []}
    if max_cycle <= 0:
        return stats
    if device.type != "cuda":
        while stats["cycles"] < max_cycle:
            for fn, _ in cycle:
                fn()
            stats["cycles"] += 1
            if flag is not None and not bool(flag):
                break
        return stats

    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):               # cycle 1, eager: the warm-up
        for fn, _ in cycle:
            fn()
    cur.wait_stream(side)
    stats["cycles"] = 1
    if stats["cycles"] >= max_cycle or (flag is not None and not bool(flag)):
        return stats

    t0 = time.perf_counter()
    pool = torch.cuda.graph_pool_handle()      # the graphs replay in capture order
    steps = []
    for fn, capturable in cycle:
        if capturable:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool):
                fn()
            steps.append(g.replay)
        else:
            steps.append(fn)
    torch.cuda.synchronize(device)
    stats["capture_s"] = time.perf_counter() - t0

    flag_host = torch.ones((), dtype=torch.bool).pin_memory()
    while stats["cycles"] < max_cycle and bool(flag_host):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(cur)
        for step in steps:
            step()
        if flag is not None:
            flag_host.copy_(flag, non_blocking=True)
        e1.record(cur)
        e1.synchronize()
        stats["cycle_ms"].append(e0.elapsed_time(e1))
        stats["cycles"] += 1
    return stats


def _diis_solve(err_hist, n_filled, space):
    """CDIIS coefficients from the error history (masked bordered solve).

    err_hist: (m, L) flattened error vectors (complex ok); slots >= n_filled
    (a device scalar) are unfilled and forced to coefficient 0 through
    identity rows. ``solve_ex`` leaves its error code on the device.
    """
    B = (err_hist.conj() @ err_hist.T).real             # (m, m)
    Bn = B / torch.clamp(B.abs().max(), min=1e-30)
    m = space
    mask = torch.arange(m, device=B.device) < n_filled
    maskf = mask.to(Bn.dtype)
    A = torch.zeros((m + 1, m + 1), dtype=Bn.dtype, device=Bn.device)
    A[:m, :m] = Bn * (maskf[:, None] * maskf[None, :])
    # regularisation on filled slots, identity rows on empty ones
    A.diagonal()[:m] += torch.ones_like(maskf).masked_fill_(mask, 1e-12)
    A[:m, m] = -maskf
    A[m, :m] = -maskf
    rhs = torch.zeros(m + 1, dtype=Bn.dtype, device=Bn.device)
    rhs[m:].fill_(-1.0)                  # a fill kernel: no host copy to capture
    c = torch.linalg.solve_ex(A, rhs)[0][:m]
    return c * maskf


def _state(device, rdtype, **tensors):
    """The loop's device state: the given tensors, the step counters and
    the convergence scalars (inf before the first cycle, as the
    reference's carry)."""
    st = dict(tensors)
    kw = dict(dtype=rdtype, device=device)
    st.update(it=torch.zeros((), dtype=torch.int64, device=device),
              cnt=torch.zeros((), dtype=torch.int64, device=device),
              e_last=torch.full((), math.inf, **kw),
              e_new=torch.full((), math.inf, **kw),
              de=torch.full((), math.inf, **kw),
              errn=torch.full((), math.inf, **kw),
              flag=torch.ones((), dtype=torch.bool, device=device))
    return st


def _diis_step(st, F, err, m):
    """Write F and err into slot it % m, solve for the CDIIS coefficients
    and return the extrapolated Fock matrix."""
    slot = torch.remainder(st["it"], m).reshape(1)
    st["F_hist"].index_copy_(0, slot, F[None])
    st["e_hist"].index_copy_(0, slot, err.reshape(1, -1))
    st["cnt"].copy_(torch.clamp(st["cnt"] + 1, max=m))
    c = _diis_solve(st["e_hist"], st["cnt"], m).to(F.dtype)
    return torch.tensordot(c, st["F_hist"], dims=1)


def _close_cycle(st, dm_new, max_cycle, conv_tol):
    """Advance the state past one cycle and set the loop test."""
    st["de"].copy_((st["e_new"] - st["e_last"]).abs())
    st["it"].add_(1)
    st["dm"].copy_(dm_new)
    st["e_last"].copy_(st["e_new"])
    st["flag"].copy_((st["it"] < max_cycle)
                     & ((st["de"] > conv_tol) | (st["errn"] > conv_tol ** 0.5)))


def _finish(st, conv_tol):
    converged = bool((st["de"] <= conv_tol) & (st["errn"] <= conv_tol ** 0.5))
    return st["dm"], float(st["e_last"]), int(st["it"]), converged


class _Driver:
    """``run(dm0) -> (dm, e_elec, n_iter, converged)``; ``stats`` holds the
    last run's :func:`run_cycles` statistics."""

    def __init__(self, run):
        self._run = run
        self.stats = {}

    def __call__(self, dm0):
        out, self.stats = self._run(dm0)
        return out


def make_jit_scf_diis(system, xc=None, exxdiv="ewald", df="isdf",
                      isdf_c: float = 10.0, max_cycle: int = 60,
                      conv_tol: float = 1e-10, diis_space: int = 8):
    """Build ``run(dm0) -> (dm, e_elec, n_iter, converged)`` (Gamma point).

    Exchange runs through ISDF GEMMs (df='isdf', built here) or the exact
    pair-density FFT build (df='fftdf'); a range-separated hybrid builds
    the full-range and the long-range exchange (from one shared ISDF fit).
    ``e_elec`` excludes e_nuc. The returned callable's ``stats`` hold the
    last run's cycle count, capture seconds and per-cycle times.
    """
    if df not in ("isdf", "fftdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'isdf' or 'fftdf'")
    xcspec = XCSpec(xc) if xc is not None else None
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    is_dft = xcspec is not None and xcspec.family != "hf"
    aoR = system.aoR
    dtype, device = aoR.dtype, aoR.device
    mesh, w = system.mesh, system.weight
    coulG = system.coulG
    hcore, X, S = (system.hcore.to(dtype), system.X.to(dtype), system.S.to(dtype))
    # combined probe-charge shift (the host loop's RSH semantics)
    mad = hyb * system.madelung if exxdiv == "ewald" else 0.0
    coulGs = [coulG]
    if rsh:
        coulGs.append(torch.as_tensor(coulomb.get_coulG(system.cell, exxdiv=None,
                                                        omega=omega),
                                      dtype=dtype, device=device))
        if exxdiv == "ewald":
            mad += (alpha - hyb) * coulomb.madelung_omega(system.cell, None, omega)
    k_fns = exchange_engines(system, df, coulGs, isdf_c)[0] if need_k else ()
    ao_grad = None
    if is_dft and xcspec.family in ("gga", "mgga"):
        ao_grad = ao_gradient_fft(aoR, mesh, system.Gv)
    nocc = system.nelec // 2
    nao, nrank = X.shape
    m = diis_space

    def fock_and_energy(dm):
        vj = fftdf.get_j(aoR, dm, coulG, mesh, w)
        veff = vj
        e_elec = torch.einsum("ij,ji->", dm, hcore) + 0.5 * torch.einsum("ij,ji->", dm, vj)
        if is_dft:
            e_xc, vxc, _ = _vxc(aoR, ao_grad, dm, w, xcspec)
            veff = veff + vxc
            e_elec = e_elec + e_xc
        if need_k:
            vk = hyb * k_fns[0](dm)
            if rsh:
                vk = vk + (alpha - hyb) * k_fns[1](dm)
            vk = vk + mad * (S @ dm @ S)
            veff = veff - 0.5 * vk
            e_elec = e_elec - 0.25 * torch.einsum("ij,ji->", dm, vk)
        return hcore + veff, e_elec

    def run(dm0):
        st = _state(device, dtype,
                    dm=torch.as_tensor(dm0, dtype=dtype, device=device).clone(
                        memory_format=torch.contiguous_format),
                    F_hist=torch.zeros((m, nao, nao), dtype=dtype, device=device),
                    e_hist=torch.zeros((m, nrank * nrank), dtype=dtype, device=device),
                    Fp=torch.zeros((nrank, nrank), dtype=dtype, device=device),
                    u=torch.zeros((nrank, nrank), dtype=dtype, device=device))

        def fock_diis():                                # graph A
            dm = st["dm"]
            F, e_elec = fock_and_energy(dm)
            err = X.T @ (S @ dm @ F - F @ dm @ S) @ X
            st["errn"].copy_(torch.linalg.norm(err) / nrank)
            st["e_new"].copy_(e_elec)
            st["Fp"].copy_(X.T @ _diis_step(st, F, err, m) @ X)

        def eig():                                      # eager
            st["u"].copy_(torch.linalg.eigh(st["Fp"])[1])

        def density():                                  # graph B
            C = X @ st["u"][:, :nocc]
            _close_cycle(st, 2.0 * C @ C.T, max_cycle, conv_tol)

        stats = run_cycles([(fock_diis, True), (eig, False), (density, True)],
                           device, max_cycle, st["flag"])
        return _finish(st, conv_tol), stats

    return _Driver(run)


def run_scf_jit_diis(system, xc=None, exxdiv="ewald", df="isdf",
                     isdf_c: float = 10.0, max_cycle: int = 60,
                     conv_tol: float = 1e-10, dm0=None):
    """Convenience wrapper; returns (e_tot, dm, n_iter, converged), the
    density on the system's device. The default start is the uniform
    density 2/nao I."""
    run = make_jit_scf_diis(system, xc=xc, exxdiv=exxdiv, df=df, isdf_c=isdf_c,
                            max_cycle=max_cycle, conv_tol=conv_tol)
    nao = system.aoR.shape[1]
    if dm0 is None:
        dm0 = 2.0 / nao * torch.eye(nao, dtype=torch.float64)
    dm, e_elec, it, conv = run(dm0)
    return e_elec + system.e_nuc, dm, it, conv


def make_kscf_jit_diis(system, xc=None, exxdiv="ewald", df="isdf",
                       isdf_c: float = 10.0, max_cycle: int = 60,
                       conv_tol: float = 1e-10, diis_space: int = 8):
    """k-point driver: ``run(dm0_k) -> (dm_k, e_elec, n_iter, converged)``.

    Requires full-rank overlaps at every k. Occupations are an exact-count
    fill across k (a stable sort of all eigenvalues). Exchange through the
    shared-xi k-point ISDF (df='isdf', built here) or the exact FFT build
    (df='fftdf'). The returned e_elec excludes e_nuc.
    """
    if df not in ("isdf", "fftdf"):
        raise ValueError(f"unknown df engine {df!r}: use 'isdf' or 'fftdf'")
    xcspec = XCSpec(xc) if xc is not None else None
    hyb, alpha, omega = rsh_coeffs(xcspec)
    rsh = omega != 0.0
    need_k = hyb > 0 or alpha > 0
    is_dft = xcspec is not None and xcspec.family != "hf"
    aoR_k = system.aoR_k
    cdtype, device = aoR_k.dtype, aoR_k.device
    rdtype = torch.float64 if cdtype == torch.complex128 else torch.float32
    nk, ng, nao = aoR_k.shape
    if any(x.shape != (nao, nao) for x in system.X):
        raise ValueError("k-point jit driver needs full-rank overlaps")
    mesh, w = system.mesh, system.weight
    coulG = system.coulG
    hcore, S = system.hcore.to(cdtype), system.S.to(cdtype)
    X = torch.stack(system.X).to(cdtype)
    mad = hyb * system.madelung if exxdiv == "ewald" else 0.0
    if rsh and exxdiv == "ewald":
        mad += (alpha - hyb) * coulomb.madelung_omega(system.cell, system.kpts, omega)
    k_fns = exchange_engines_k(system, df, isdf_c, omega if rsh else None) \
        if need_k else ()
    ao_grad_k = None
    if is_dft and xcspec.family in ("gga", "mgga"):
        ao_grad_k = bloch_ao_gradients(system)
    nocc_tot = system.nelec_tot // 2
    m = diis_space

    def tr(a, b):
        return torch.einsum("kij,kji->", a, b).real / nk

    def fock_and_energy(dm):
        vj = fftdf_k.get_j_kpts(aoR_k, dm, coulG, mesh, w)
        veff = vj
        e_elec = tr(dm, hcore) + 0.5 * tr(dm, vj)
        if is_dft:
            e_xc, vxc = _vxc_k(aoR_k, ao_grad_k, dm, w, xcspec)
            veff = veff + vxc
            e_elec = e_elec + e_xc
        if need_k:
            vk = hyb * k_fns[0](dm)
            if rsh:
                vk = vk + (alpha - hyb) * k_fns[1](dm)
            vk = vk + mad * (S @ dm @ S)
            veff = veff - 0.5 * vk
            e_elec = e_elec - 0.25 * tr(dm, vk)
        return hcore + veff, e_elec

    def run(dm0):
        kw = dict(dtype=cdtype, device=device)
        st = _state(device, rdtype,
                    dm=torch.as_tensor(dm0, **kw).clone(memory_format=torch.contiguous_format),
                    F_hist=torch.zeros((m, nk, nao, nao), **kw),
                    e_hist=torch.zeros((m, nk * nao * nao), **kw),
                    Fp=torch.zeros((nk, nao, nao), **kw),
                    u=torch.zeros((nk, nao, nao), **kw),
                    e=torch.zeros((nk, nao), dtype=rdtype, device=device))

        def fock_diis():                                # graph A
            dm = st["dm"]
            F, e_elec = fock_and_energy(dm)
            sdf = S @ dm @ F
            err = sdf - sdf.conj().transpose(1, 2)
            st["errn"].copy_(torch.linalg.norm(err) / (nk * nao))
            st["e_new"].copy_(e_elec)
            st["Fp"].copy_(X.conj().transpose(1, 2) @ _diis_step(st, F, err, m) @ X)

        def eig():                                      # eager
            e, u = torch.linalg.eigh(st["Fp"])
            st["e"].copy_(e)
            st["u"].copy_(u)

        def density():                                  # graph B
            C = X @ st["u"]
            # exact-count fill: a <= fermi threshold would overfill a
            # degenerate Fermi level
            order = torch.argsort(st["e"].reshape(-1), stable=True)
            occ = torch.zeros(nk * nao, dtype=rdtype, device=device).index_fill_(
                0, order[:nocc_tot], 2.0).reshape(nk, 1, nao)
            _close_cycle(st, (C * occ) @ C.conj().transpose(1, 2), max_cycle, conv_tol)

        stats = run_cycles([(fock_diis, True), (eig, False), (density, True)],
                           device, max_cycle, st["flag"])
        return _finish(st, conv_tol), stats

    return _Driver(run)


def run_kscf_jit_diis(system, xc=None, exxdiv="ewald", df="isdf",
                      isdf_c: float = 10.0, max_cycle: int = 60,
                      conv_tol: float = 1e-10, dm0=None):
    """Convenience wrapper; returns (e_tot, dm_k, n_iter, converged), the
    density on the system's device. The default start is 2/nao I at
    every k."""
    run = make_kscf_jit_diis(system, xc=xc, exxdiv=exxdiv, df=df, isdf_c=isdf_c,
                             max_cycle=max_cycle, conv_tol=conv_tol)
    nk, _, nao = system.aoR_k.shape
    if dm0 is None:
        dm0 = (2.0 / nao * torch.eye(nao, dtype=torch.complex128)).expand(nk, nao, nao)
    dm, e_elec, it, conv = run(dm0)
    return e_elec + system.e_nuc, dm, it, conv

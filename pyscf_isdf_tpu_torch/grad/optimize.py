"""Geometry optimization on autograd forces (FIRE integrator).

The forces come from :mod:`~pyscf_isdf_tpu_torch.grad.rhf`; the
optimizer is FIRE (Bitzek et al., PRL 97, 170201 (2006)), which needs only
(E, F) evaluations. :func:`optimize_cell` relaxes the lattice too, on the
stress of :mod:`~pyscf_isdf_tpu_torch.grad.stress`.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np


def optimize(cell0, xc=None, exxdiv="ewald", maxsteps=50, fmax=2e-3,
             dt0=0.35, verbose=False, device=None):
    """Relax atom positions at fixed lattice on ``device`` (default: the
    GPU). Returns (cell, info dict).

    fmax: convergence threshold on max |force component| (Ha/Bohr).
    Grid egg-box noise bounds the useful fmax from below (~1e-4 on
    typical meshes); choose fmax above it. Each step's SCF converges to
    1e-10.
    """
    from pyscf_isdf_tpu_torch.grad.rhf import rhf_gradient
    from pyscf_isdf_tpu_torch.scf import build_scf_system, scf_kernel

    def rebuild(positions):
        # shells reference atoms by index, so moving a frozen Cell is
        # swapping its coordinate table
        return replace(cell0, coords=np.asarray(positions, dtype=float))

    pos = np.array(cell0.coords, dtype=float)
    vel = np.zeros_like(pos)
    dt, a_fire = dt0, 0.1
    n_up = 0
    traj = []
    dm0 = None
    for step in range(maxsteps):
        cell = rebuild(pos)
        system = build_scf_system(cell, device=device)
        res = scf_kernel(system, xc=xc, exxdiv=exxdiv, conv_tol=1e-10, dm0=dm0)
        dm0 = res["dm"]
        force = -rhf_gradient(system, res, xc=xc, exxdiv=exxdiv, device=device)
        fnorm = np.abs(force).max()
        traj.append((res["e_tot"], fnorm))
        if verbose:
            print(f"opt step {step:3d}  E = {res['e_tot']:.10f}  "
                  f"max|F| = {fnorm:.2e}  dt = {dt:.3f}")
        if fnorm < fmax:
            return cell, {"converged": True, "e_tot": res["e_tot"],
                          "nsteps": step + 1, "traj": traj, "positions": pos}
        # FIRE update
        if float(np.vdot(force, vel)) > 0:
            n_up += 1
            fhat = force / (np.linalg.norm(force) + 1e-300)
            vel = (1 - a_fire) * vel + a_fire * np.linalg.norm(vel) * fhat
            if n_up > 5:
                dt = min(dt * 1.1, 4 * dt0)
                a_fire *= 0.99
        else:
            vel[:] = 0.0
            dt *= 0.5
            a_fire = 0.1
            n_up = 0
        vel = vel + dt * force
        dr = dt * vel
        steplen = np.abs(dr).max()
        if steplen > 0.2:                      # trust radius (Bohr)
            dr *= 0.2 / steplen
        pos = pos + dr
    return rebuild(pos), {"converged": False, "e_tot": traj[-1][0],
                          "nsteps": maxsteps, "traj": traj, "positions": pos}


def optimize_cell(cell0, xc=None, exxdiv="ewald", maxsteps=30, fmax=2e-3,
                  smax=2e-4, step_eps=0.5, verbose=False, device=None):
    """Variable-cell relaxation on ``device`` (default: the GPU): positions
    and lattice, on the autograd forces and stress tensor.

    Steepest descent on the strain (eps step = -step_eps * vol * sigma,
    scaled into a trust region) alternating with damped descent on the
    positions. The FFT mesh is regenerated each step to hold ke_cutoff
    fixed: with a fixed mesh count an expanding cell lowers the effective
    cutoff and the quadrature softening adds a spurious expansive stress.
    The optimizer descends the true E(V) of the given basis (minimal
    gth-szv diamond is unbound against free atoms: its cell relaxation runs
    away); use a polarized basis for physical lattice constants.

    Returns (cell, info) with info["pressure"] the final -tr(sigma)/3.
    """
    from pyscf_isdf_tpu_torch import lattice
    from pyscf_isdf_tpu_torch.grad.rhf import rhf_gradient
    from pyscf_isdf_tpu_torch.grad.stress import stress_tensor
    from pyscf_isdf_tpu_torch.scf import build_scf_system, scf_kernel

    ke0 = float(np.min(lattice.mesh_to_cutoff(cell0.a, cell0.mesh)))
    cell = cell0
    traj = []
    dm0 = None
    for step in range(maxsteps):
        system = build_scf_system(cell, device=device)
        res = scf_kernel(system, xc=xc, exxdiv=exxdiv, conv_tol=1e-10, dm0=dm0)
        dm0 = res["dm"]
        force = -rhf_gradient(system, res, xc=xc, exxdiv=exxdiv, device=device)
        sigma = stress_tensor(system, res, xc=xc, exxdiv=exxdiv, device=device)
        fnorm = np.abs(force).max()
        snorm = np.abs(sigma).max()
        traj.append((res["e_tot"], fnorm, snorm))
        if verbose:
            print(f"cellopt {step:3d}  E = {res['e_tot']:.10f}  "
                  f"max|F| = {fnorm:.2e}  max|sigma| = {snorm:.2e}")
        if fnorm < fmax and snorm < smax:
            return cell, {"converged": True, "e_tot": res["e_tot"],
                          "nsteps": step + 1, "traj": traj,
                          "pressure": -np.trace(sigma) / 3}
        # strain step: dE = vol * sigma : d eps, descend along -sigma
        deps = -step_eps * cell.vol * sigma
        dmax = np.abs(deps).max()
        if dmax > 0.02:                       # trust region on strain
            deps *= 0.02 / dmax
        F = np.eye(3) + deps
        # position step: damped descent in the strained frame
        dr = force * min(0.5, 0.2 / max(fnorm, 1e-12))
        new_a = cell.a @ F.T
        cell = replace(cell, a=new_a, coords=np.asarray((cell.coords + dr) @ F.T, dtype=float),
                       mesh=tuple(int(m) for m in lattice.cutoff_to_mesh(new_a, ke0)))
        dm0 = None                            # lattice changed: fresh guess
    return cell, {"converged": False, "e_tot": traj[-1][0], "nsteps": maxsteps,
                  "traj": traj, "pressure": -np.trace(sigma) / 3}

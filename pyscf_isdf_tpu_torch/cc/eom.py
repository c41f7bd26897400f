"""EOM-CCSD (EE / IP / EA) (torch).

Two routes, as in the JAX package:

- the exact determinant-space similarity transform (:func:`eom_ccsd`):
  Hbar = e^{-T} H e^{T} in the determinant basis (the Slater-Condon
  machinery of cc/fci.py and the excitation-operator matrix of the
  converged t1/t2), projected on {Phi0, singles, doubles} (EE),
  {1h, 2h1p} (IP) or {1p, 2p1h} (EA). The nilpotent series terminates
  exactly; O(FCI-dim^2) memory, the oracle of small systems;
- the polynomial-cost Jacobian route: the EOM-EE matrix is the Jacobian
  of the CCSD amplitude residual, so its sigma vector is one forward-mode
  JVP (``torch.func.jvp``) through the ground-state update
  (gccsd._update_blocks), on the device; the dense Jacobian takes its
  columns in vmapped batches, and the ARPACK and GMRES solvers of the
  iterative and shift-invert paths stay on the host
  (``scipy.sparse.linalg``). IP and EA are exact subblocks of the EE
  Jacobian with one non-interacting continuum orbital
  (:func:`_augment_continuum`).

Array-level functions compute on the device of their integrals;
:func:`eom_from_scf` takes a built system and runs on ``device``
(default: the GPU). Spectra come back as numpy arrays.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from pyscf_isdf_tpu_torch.cc.fci import _phase, build_hamiltonian
from pyscf_isdf_tpu_torch.device import require_device, to_host

# columns of the dense Jacobian per vmapped sigma batch
_SIGMA_BATCH = 64


def _excitation_terms(dets, no, nv):
    """Host bookkeeping of T's matrix: singles (J, I, i, a, sign) and
    doubles (J, I, i, j, a, b, sign), orbital indices relative to their
    block."""
    index = {d: i for i, d in enumerate(dets)}
    s1, s2 = [], []
    for I, d in enumerate(dets):
        occ = set(d)
        occ_o = [p for p in d if p < no]            # hole-space orbitals
        virt_v = [a for a in range(no, no + nv) if a not in occ]
        for i in occ_o:
            for a in virt_v:
                J = index.get(tuple(sorted(occ - {i} | {a})))
                if J is None:
                    continue
                d1 = tuple(sorted(occ - {i}))
                s1.append((J, I, i, a - no, _phase(d, i) * _phase(d1, a)))
        for i, j in combinations(occ_o, 2):
            for a, b in combinations(virt_v, 2):
                J = index.get(tuple(sorted(occ - {i, j} | {a, b})))
                if J is None:
                    continue
                # a_a^+ a_b^+ a_j a_i: a_i first
                d1 = tuple(sorted(occ - {i}))
                d2 = tuple(sorted(occ - {i, j}))
                d3 = tuple(sorted(set(d2) | {b}))
                sgn = (_phase(d, i) * _phase(d1, j)
                       * _phase(d2, b) * _phase(d3, a))
                s2.append((J, I, i, j, a - no, b - no, sgn))

    def cols(rows, n):
        a = np.asarray(rows, dtype=np.float64).reshape(-1, n)
        return [a[:, k].astype(np.int64) for k in range(n - 1)] + [a[:, -1]]

    return cols(s1, 5), cols(s2, 7)


def excitation_matrix(t1, t2, dets, nocc):
    """Matrix of T = sum t1_ia a_a^+ a_i + 1/4 sum t2_ijab a_a^+ a_b^+ a_j
    a_i in the given determinant basis (any particle-number sector), on
    the device of ``t2``."""
    t2 = torch.as_tensor(t2)
    dev = t2.device
    t1 = torch.as_tensor(t1, device=dev)
    no, nv = t1.shape
    dt = torch.promote_types(t1.dtype, t2.dtype)
    T = torch.zeros((len(dets), len(dets)), dtype=dt, device=dev)
    s1, s2 = _excitation_terms(dets, no, nv)

    def t(a):
        return torch.as_tensor(a, device=dev)

    for terms, amp in ((s1, lambda x: t1[x[2], x[3]]),
                       (s2, lambda x: t2[x[2], x[3], x[4], x[5]])):
        if len(terms[0]):
            x = [t(c) for c in terms]
            T.index_put_((x[0], x[1]), x[-1].to(dt) * amp(x).to(dt),
                         accumulate=True)
    return T


def _expm_nilpotent(T, max_rank):
    out = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    term = out
    for k in range(1, max_rank + 1):
        term = term @ T / k
        if not bool(term.abs().max() > 0):
            break
        out = out + term
    return out


def _projection(ref, nso, sector):
    occ = set(ref)
    vir = list(range(len(ref), nso))
    proj = []
    if sector == "ee":
        proj.append(tuple(ref))
        for i in ref:
            for a in vir:
                proj.append(tuple(sorted(occ - {i} | {a})))
        for i, j in combinations(ref, 2):
            for a, b in combinations(vir, 2):
                proj.append(tuple(sorted(occ - {i, j} | {a, b})))
    elif sector == "ip":
        for i in ref:
            proj.append(tuple(sorted(occ - {i})))
        for i, j in combinations(ref, 2):
            for a in vir:
                proj.append(tuple(sorted(occ - {i, j} | {a})))
    else:  # ea
        for a in vir:
            proj.append(tuple(sorted(occ | {a})))
        for i in ref:
            for a, b in combinations(vir, 2):
                proj.append(tuple(sorted(occ - {i} | {a, b})))
    return proj


def _hbar(h1so, eri_so, t1, t2, no, dets, nel):
    """(Hbar, index of dets) in the determinant basis ``dets``."""
    H = build_hamiltonian(h1so, eri_so, dets)
    T = excitation_matrix(t1, t2, dets, no).to(H.device)
    dt = torch.promote_types(H.dtype, T.dtype)
    H, T = H.to(dt), T.to(dt)
    eT = _expm_nilpotent(T, nel + 2)
    eTm = _expm_nilpotent(-T, nel + 2)
    return eTm, H, eT


def eom_ccsd(h1so, eri_so, t1, t2, nocc, sector="ee", nroots=6):
    """Eigenvalues of the projected Hbar in the given sector, on the device
    of ``eri_so``.

    Returns the sorted (real part) electronic sector energies (numpy);
    callers form excitation energies, IPs or EAs by differencing with the
    CCSD ground-state electronic energy (the lowest EE root).
    """
    eri_so = torch.as_tensor(eri_so)
    nso = eri_so.shape[0]
    no = int(nocc)
    nel = {"ee": no, "ip": no - 1, "ea": no + 1}[sector]
    dets = list(combinations(range(nso), nel))
    if len(dets) > 20000:
        raise MemoryError(
            f"determinant space {len(dets)} too large for the exact "
            "transform; use eom_ee_iterative (polynomial-cost Jacobian "
            "sigma) for EE, or reduce the orbital space")
    index = {d: i for i, d in enumerate(dets)}
    eTm, H, eT = _hbar(h1so, eri_so, t1, t2, no, dets, nel)
    Hbar = eTm @ H @ eT
    idx = torch.as_tensor([index[d] for d in _projection(range(no), nso,
                                                          sector)],
                          device=Hbar.device)
    w = torch.linalg.eigvals(Hbar[idx][:, idx]).cpu().numpy()
    return np.real(np.sort_complex(w)[:nroots])


def _antisym_basis(no, nv):
    """Index maps between packed (i<j, a<b) doubles and the full
    antisymmetric t2."""
    ij = [(i, j) for i in range(no) for j in range(i + 1, no)]
    ab = [(a, b) for a in range(nv) for b in range(a + 1, nv)]
    return ij, ab


def _make_sigma(f, eri, t1, t2, nocc):
    """The EOM-EE sigma: the JVP of the CCSD amplitude residual at (t1, t2),
    on the device of ``eri``. Returns (sigma, no, nv, dtype); sigma(r1, r2)
    takes tangents of that dtype (one forward-mode pass), sigma.batched
    takes them with a leading batch axis (vmapped torch.func.jvp)."""
    from pyscf_isdf_tpu_torch.cc.gccsd import _update_blocks, make_blocks

    eri = torch.as_tensor(eri)
    dev = eri.device
    f = torch.as_tensor(f, device=dev)
    t2 = torch.as_tensor(t2, device=dev)
    dt = torch.promote_types(torch.promote_types(f.dtype, eri.dtype), t2.dtype)
    f = f.to(dt)
    no = int(nocc)
    nv = f.shape[0] - no
    B = make_blocks(eri.to(dt), no)
    e = torch.diagonal(f).real
    D1 = e[:no, None] - e[None, no:]
    D2 = (e[:no, None, None, None] + e[None, :no, None, None]
          - e[None, None, no:, None] - e[None, None, None, no:])
    t1 = torch.as_tensor(t1, device=dev).to(dt)
    t2 = t2.to(dt)

    def resid(a, b):
        t1n, t2n = _update_blocks(a, b, f, B, no)
        return (t1n - a) * D1, (t2n - b) * D2

    def sigma(r1, r2):
        with fwAD.dual_level():
            o1, o2 = resid(fwAD.make_dual(t1, r1), fwAD.make_dual(t2, r2))
            return fwAD.unpack_dual(o1).tangent, fwAD.unpack_dual(o2).tangent

    # the same JVP through torch.func, which vmaps over a batch of tangents
    sigma.batched = torch.func.vmap(
        lambda r1, r2: torch.func.jvp(resid, (t1, t2), (r1, r2))[1])
    return sigma, no, nv, dt


def _packers(no, nv, dtype, device):
    """Maps between the packed antisymmetric vector (singles and i<j, a<b
    doubles) and full (t1, t2) tensors on ``device``; both take a leading
    batch shape."""
    ij, ab = _antisym_basis(no, nv)
    ns = no * nv
    dim = ns + len(ij) * len(ab)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    I = t(np.repeat([p[0] for p in ij], len(ab)))
    J = t(np.repeat([p[1] for p in ij], len(ab)))
    A_ = t(np.tile([p[0] for p in ab], len(ij)))
    B_ = t(np.tile([p[1] for p in ab], len(ij)))

    def unpack(v):
        bs = v.shape[:-1]
        r1 = v[..., :ns].reshape(bs + (no, nv))
        d = v[..., ns:]
        r2 = torch.zeros(bs + (no, no, nv, nv), dtype=dtype, device=device)
        r2[..., I, J, A_, B_] = d
        r2[..., J, I, A_, B_] = -d
        r2[..., I, J, B_, A_] = -d
        r2[..., J, I, B_, A_] = d
        return r1, r2

    def pack(s1, s2):
        bs = s1.shape[:-2]
        return torch.cat([s1.reshape(bs + (ns,)), s2[..., I, J, A_, B_]], -1)

    return pack, unpack, dim


def _dense(sigma, pack, unpack, dim, dtype, device, sel=None):
    """The dense matrix of the packed sigma (restricted to the packed
    indices ``sel`` when given), its columns in vmapped batches."""
    n = dim if sel is None else len(sel)
    cols = []
    for c0 in range(0, n, _SIGMA_BATCH):
        c1 = min(c0 + _SIGMA_BATCH, n)
        V = torch.zeros((c1 - c0, dim), dtype=dtype, device=device)
        rows = torch.arange(c1 - c0, device=device)
        V[rows, (rows + c0) if sel is None else sel[c0:c1]] = 1.0
        s = pack(*sigma.batched(*unpack(V)))
        cols.append(s if sel is None else s[:, sel])
    return torch.cat(cols).T


def eom_ee_jacobian(f, eri, t1, t2, nocc):
    """Dense EOM-EE-CCSD matrix at polynomial per-element cost: the
    Jacobian of the CCSD amplitude residual, A_{mu nu} = <mu|[Hbar,
    tau_nu]|0>, in the packed antisymmetric basis (singles and i<j, a<b
    doubles), on the device of ``eri``."""
    sigma, no, nv, dt = _make_sigma(f, eri, t1, t2, nocc)
    dev = torch.as_tensor(eri).device
    pack, unpack, dim = _packers(no, nv, dt, dev)
    return _dense(sigma, pack, unpack, dim, dt, dev)


def _host_mv(sigma, pack, unpack, dt, dev, sel=None, dim_full=None):
    """A numpy matvec of the packed sigma for scipy's solvers."""
    np_dt = np.complex128 if dt.is_complex else np.float64

    def mv(v):
        x = torch.as_tensor(np.asarray(v, dtype=np_dt), device=dev)
        if sel is not None:
            full = torch.zeros(dim_full, dtype=dt, device=dev)
            full[sel] = x
            x = full
        s = pack(*sigma(*unpack(x)))
        return to_host(s if sel is None else s[sel])

    return mv, np_dt


def _arnoldi(mv, dim, np_dt, nroots, target, solve_tol, vectors):
    """ARPACK on the host: 'SR' roots, or shift-invert about ``target``
    with full-restart GMRES inner solves."""
    from scipy.sparse.linalg import LinearOperator, eigs, gmres

    op = LinearOperator((dim, dim), matvec=mv, dtype=np_dt)
    k = min(nroots, dim - 2)
    if target is None:
        return eigs(op, k=k, which="SR", return_eigenvectors=vectors)
    shifted = LinearOperator((dim, dim), matvec=lambda v: mv(v) - target * v,
                             dtype=np_dt)
    restart = min(dim, 300)

    def inv_mv(b):
        x, info = gmres(shifted, b, rtol=solve_tol, atol=0.0,
                        restart=restart, maxiter=20)
        if info != 0:
            raise RuntimeError(
                f"shift-invert inner solve stalled (info={info}); move "
                "`target` off an eigenvalue")
        return x

    opinv = LinearOperator((dim, dim), matvec=inv_mv, dtype=np_dt)
    return eigs(op, k=k, sigma=target, OPinv=opinv, which="LM",
                return_eigenvectors=vectors)


def eom_ee_iterative(f, eri, t1, t2, nocc, nroots=4, target=None,
                     solve_tol=1e-8):
    """Matrix-free EOM-EE: scipy's implicitly restarted Arnoldi on the
    device sigma (never forms A).

    Falls back to the dense Jacobian for small spaces (Arnoldi needs
    k < dim - 1). Near-degenerate complex-conjugate pairs of the
    nonsymmetric EOM matrix are filtered out, so the result may hold fewer
    than ``nroots`` energies.

    ``target``: an energy shift for shift-invert Arnoldi, so that the
    roots nearest it converge first (interior roots); the inverse is
    applied by full-restart GMRES solves of (A - target) x = b on the same
    sigma.
    """
    sigma, no, nv, dt = _make_sigma(f, eri, t1, t2, nocc)
    dev = torch.as_tensor(eri).device
    pack, unpack, dim = _packers(no, nv, dt, dev)
    if dim < max(3 * nroots, 40):           # Arnoldi needs k < dim-1
        w = torch.linalg.eigvals(
            _dense(sigma, pack, unpack, dim, dt, dev)).cpu().numpy()
    else:
        mv, np_dt = _host_mv(sigma, pack, unpack, dt, dev)
        w = _arnoldi(mv, dim, np_dt, nroots, target, solve_tol, False)
    w = np.sort(w.real[np.abs(w.imag) < 1e-6])
    return w[:nroots]


def eom_ee_energies(f, eri, t1, t2, nocc, nroots=6):
    """EOM-EE-CCSD excitation energies from the residual Jacobian."""
    w = torch.linalg.eigvals(eom_ee_jacobian(f, eri, t1, t2, nocc)).cpu().numpy()
    w = np.sort(w.real[np.abs(w.imag) < 1e-6])
    return w[:nroots]


def eom_from_scf(system, scf_res, cc_out, sector="ee", nroots=6, device=None):
    """Spin-orbital integrals from a Gamma SCF and converged CCSD
    amplitudes, on ``device`` (default: the GPU), where ``system`` must
    live -> sector energies relative to CCSD (numpy)."""
    from pyscf_isdf_tpu_torch.cc.gccsd import _mo_eri_gamma, spinorb_from_spatial

    dev = require_device(system.aoR, device)
    mo_c = torch.as_tensor(scf_res["mo_coeff"], device=dev)
    h1mo = mo_c.conj().T @ system.hcore @ mo_c
    h1so, eri_so = spinorb_from_spatial(h1mo, _mo_eri_gamma(system, mo_c))
    no = system.nelec
    t1 = torch.as_tensor(cc_out["t1"], device=dev)
    t2 = torch.as_tensor(cc_out["t2"], device=dev)
    w = eom_ccsd(h1so, eri_so, t1, t2, no, sector=sector,
                 nroots=nroots + (1 if sector == "ee" else 0))
    if sector == "ee":
        # the lowest EE root is the CCSD ground state
        return (w - w[0])[1:]
    e_gs = eom_ccsd(h1so, eri_so, t1, t2, no, sector="ee", nroots=1)[0]
    # ip: E_n(N-1) - E_0(N), positive when ionization costs energy;
    # ea: E_n(N+1) - E_0(N), negative for a bound extra electron
    return w - e_gs


# ------------------------------------------------- production IP/EA (Gamma)
def _augment_continuum(f, eri, t1, t2, nocc, sector, eps_x):
    """Pad the spin-orbital problem with one non-interacting 'continuum'
    orbital at energy ``eps_x`` (zero eri, zero off-diagonal f, zero t).

    IP- and EA-EOM-CCSD are exact subblocks of the augmented EE Jacobian:
    H carries no continuum terms and T no continuum amplitudes, so the
    one-continuum sector is invariant. An EE excitation into the continuum
    virtual is an ionization (r1[i,x] = 1h, r2[ij,ax] = 2h1p, eigenvalue
    IP + eps_x); one out of a continuum occupied is an attachment
    (r1[x,a] = 1p, r2[xj,ab] = 2p1h, eigenvalue EA - eps_x). Reference
    counterpart: the EOMIP/EOMEA classes, pyscf/cc/eom_rccsd.py:83, and
    pyscf/pbc/cc/eom_kccsd_rhf.py at k.

    Returns (f2, eri2, t12, t22, no2) on the device of ``eri``.
    """
    eri = torch.as_tensor(eri)
    dev = eri.device
    f = torch.as_tensor(f, device=dev)
    t1 = torch.as_tensor(t1, device=dev)
    t2 = torch.as_tensor(t2, device=dev)
    nso = f.shape[0]
    no = int(nocc)
    pos = no if sector == "ea" else nso   # insert occ before virtuals
    ix = torch.as_tensor(np.r_[0:pos, pos + 1:nso + 1], device=dev)
    f2 = torch.zeros((nso + 1, nso + 1),
                     dtype=torch.promote_types(f.dtype, eri.dtype), device=dev)
    f2[ix[:, None], ix[None, :]] = f.to(f2.dtype)
    f2[pos, pos] = eps_x
    eri2 = torch.zeros((nso + 1,) * 4, dtype=eri.dtype, device=dev)
    eri2[ix[:, None, None, None], ix[None, :, None, None],
         ix[None, None, :, None], ix[None, None, None, :]] = eri
    no2 = no + 1 if sector == "ea" else no
    nv = nso - no
    nv2 = nso + 1 - no2
    t12 = torch.zeros((no2, nv2), dtype=t1.dtype, device=dev)
    t22 = torch.zeros((no2, no2, nv2, nv2), dtype=t2.dtype, device=dev)
    if sector == "ea":                     # the dummy occ is the last occ
        t12[:no, :] = t1
        t22[:no, :no, :, :] = t2
    else:                                  # the dummy vir is the last vir
        t12[:, :nv] = t1
        t22[:, :, :nv, :nv] = t2
    return f2, eri2, t12, t22, no2


def _sector_indices(no2, nv2, sector):
    """Packed-vector indices of the one-continuum amplitudes.

    The continuum orbital is the last occupied (ea) or last virtual (ip),
    so every sector pair (a, x) / (i, x) exists in the i<j / a<b packed
    ordering of :func:`_packers` with the continuum index second.
    """
    ij, ab = _antisym_basis(no2, nv2)
    ns = no2 * nv2
    ij_pos = {p: n for n, p in enumerate(ij)}
    ab_pos = {p: n for n, p in enumerate(ab)}
    sel = []
    if sector == "ip":
        x = nv2 - 1
        sel += [i * nv2 + x for i in range(no2)]            # r1[i, x]
        sel += [ns + ij_pos[(i, j)] * len(ab) + ab_pos[(a, x)]
                for (i, j) in ij for a in range(nv2 - 1)]   # r2[ij, ax]
    else:
        x = no2 - 1
        sel += [x * nv2 + a for a in range(nv2)]            # r1[x, a]
        sel += [ns + ij_pos[(i, x)] * len(ab) + ab_pos[p]
                for i in range(no2 - 1) for p in ab]        # r2[ix, ab]
    return np.asarray(sel, dtype=np.int64)


def eom_ip_ea_energies(f, eri, t1, t2, nocc, sector="ip", nroots=4,
                       target=None, eps_x=0.5, solve_tol=1e-8,
                       return_weights=False):
    """Production-cost EOM-IP/EA-CCSD: the one-continuum-orbital subblock
    of the EE residual Jacobian (see :func:`_augment_continuum`), on the
    device of ``eri``.

    Returns sorted E_n(N-1) - E_0(N) (ip: positive when ionization costs
    energy) or E_n(N+1) - E_0(N) (ea: negative for a bound attached
    electron), the conventions of :func:`eom_from_scf`. ``target`` (in the
    same convention) enables shift-invert Arnoldi for interior roots.

    ``return_weights=True`` also returns per root the pole strength
    ||r1||^2 / ||r||^2 (the 1h or 1p fraction of the normalized right
    eigenvector) and the normalized r1 amplitudes: ``(energies, weights,
    r1s)``.
    """
    f_h = to_host(f)
    no = int(nocc)
    # keep the quasi-Newton denominators of the residual away from zero
    # (they cancel in the JVP, but a near-zero entry loses digits): nudge
    # eps_x off any accidental degeneracy of the continuum level
    e = np.real(np.diag(f_h))
    for _ in range(8):
        gaps = np.concatenate([
            np.abs(e - eps_x),
            np.abs(e[:no, None] + e[None, :no] - eps_x).ravel(),
            np.abs(e[:, None] - e[None, no:] - eps_x).ravel(),
        ])
        if gaps.min() > 1e-4:
            break
        eps_x += 0.237
    shift = eps_x if sector == "ip" else -eps_x

    f2, eri2, t12, t22, no2 = _augment_continuum(
        f, eri, t1, t2, no, sector, eps_x)
    sigma, _, nv2, dt = _make_sigma(f2, eri2, t12, t22, no2)
    dev = eri2.device
    pack, unpack, dim_full = _packers(no2, nv2, dt, dev)
    sel_np = _sector_indices(no2, nv2, sector)
    sel = torch.as_tensor(sel_np, device=dev)
    dim = len(sel_np)

    if dim < max(3 * nroots, 40):
        w, vecs = torch.linalg.eig(
            _dense(sigma, pack, unpack, dim_full, dt, dev, sel=sel))
        w, vecs = w.cpu().numpy(), vecs.cpu().numpy()
    else:
        mv, np_dt = _host_mv(sigma, pack, unpack, dt, dev, sel=sel,
                             dim_full=dim_full)
        w, vecs = _arnoldi(mv, dim, np_dt, nroots,
                           None if target is None else target + shift,
                           solve_tol, True)
    real = np.abs(w.imag) < 1e-6
    order = np.argsort(w.real[real])[:nroots]
    w_out = w.real[real][order] - shift
    if not return_weights:
        return w_out
    # pole strengths: the sector-packed vector leads with the 1h (ip:
    # r1[i, x], n1 = no2) or 1p (ea: r1[x, a], n1 = nv2) amplitudes
    n1 = no2 if sector == "ip" else nv2
    V = vecs[:, real][:, order]
    norms = np.sum(np.abs(V) ** 2, axis=0)
    weights = np.sum(np.abs(V[:n1]) ** 2, axis=0) / norms
    r1s = (V[:n1] / np.sqrt(norms)[None, :]).T
    return w_out, weights, r1s

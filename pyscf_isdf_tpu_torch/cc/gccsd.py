"""Spin-orbital (general) CCSD and perturbative triples, einsum-native (torch).

The reference's coupled-cluster family (pyscf/pbc/cc: KCCSD is spin-orbital
CCSD over Bloch orbitals, pyscf/pbc/cc/kccsd.py; the Gamma-point driver
pyscf/cc/ccsd.py), as the JAX package carries it over:

- The amplitude update is one pure function of einsums (Stanton et al.,
  JCP 94, 4334 (1991)) with no in-place writes and no host syncs, so
  ``cc/eom.py`` differentiates through it (a forward-mode JVP).
- One update serves the Gamma point (real float64) and k-point sampling
  (complex128, the momentum-blocked composite index of ``cc/kccsd.py``):
  every integral is kept in the orientation of its Wick contraction
  (amplitude-occupied and projection-virtual indices in bra slots), so the
  only terms the real tables hide are the driving terms f_ai and
  <ab||ij> and the conjugated triples.
- DIIS extrapolates the stacked amplitude vector on the device
  (``scf/diis.DIIS``; only its small B-matrix solve is on the host).

Array-level functions compute on the device of their tensor inputs;
``ccsd`` and ``uccsd`` take a built system and run on ``device`` (default:
the GPU), where the system must live.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.scf.diis import DIIS, diis_coefficients

ein = torch.einsum


def _t(a, device=None):
    """``a`` as a tensor (numpy arrays land on the CPU unless ``device``)."""
    return torch.as_tensor(a, device=device)


def spinorb_from_spatial(h1, eri_chem):
    """Expand spatial-orbital h1 and chemist (pq|rs) ERIs to spin orbitals.

    Interleaved spin convention: spin-orbital 2p+s is spatial p, spin s, so
    an energy-ordered spatial basis keeps the occupied block leading.

    Returns (h1_so, eri_so) with eri_so = <PQ||RS>, the antisymmetrized
    physicist integrals, on the device of ``eri_chem``.
    """
    eri_chem = _t(eri_chem)
    h1 = _t(h1, eri_chem.device)
    nso = 2 * h1.shape[0]
    dev = eri_chem.device
    sp = torch.arange(nso, device=dev) // 2
    sz = torch.arange(nso, device=dev) % 2
    same = sz[:, None] == sz[None, :]
    h1so = h1[sp[:, None], sp[None, :]] * same
    chem = eri_chem[sp[:, None, None, None], sp[None, :, None, None],
                    sp[None, None, :, None], sp[None, None, None, :]]
    chem = chem * (same[:, :, None, None] & same[None, None, :, :])
    phys = chem.permute(0, 2, 1, 3)          # <PR|QS> = (PQ|RS)
    return h1so, phys - phys.transpose(2, 3)


def _pij(x):
    return x - x.transpose(0, 1)


def _pab(x):
    return x - x.transpose(2, 3)


_BLOCK_NAMES = ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovoo", "oovo",
                "ovvv", "vovv", "vvvo", "vvoo", "vvvv")


def make_blocks(eri, no):
    """The occupied/virtual blocks of <pq||rs> that the update reads (views)."""
    o, v = slice(None, no), slice(no, None)
    ix = {"o": o, "v": v}
    return {name: eri[ix[name[0]], ix[name[1]], ix[name[2]], ix[name[3]]]
            for name in _BLOCK_NAMES}


def _update(t1, t2, f, eri, no):
    """One CCSD amplitude update (Stanton-style intermediates).

    eri is <pq||rs> (antisymmetrized physicist); f the (block-diagonal)
    Fock matrix. The orientation of each integral is complex-Hermitian-safe
    (see the module docstring).
    """
    return _update_blocks(t1, t2, f, make_blocks(eri, no), no)


def _update_blocks(t1, t2, f, B, no, ein=torch.einsum):
    """The update on the blocks of :func:`make_blocks`; ``ein`` is the einsum
    (:func:`_split_einsum` on the DTensors of :func:`kernel_sharded`)."""
    o, v = slice(None, no), slice(no, None)
    fov = f[o, v]
    e = torch.diagonal(f).real
    eo, ev = e[:no], e[no:]
    D1 = eo[:, None] - ev[None, :]
    D2 = (eo[:, None, None, None] + eo[None, :, None, None]
          - ev[None, None, :, None] - ev[None, None, None, :])

    t11 = ein("ia,jb->ijab", t1, t1)
    tau_t = t2 + 0.5 * (t11 - t11.transpose(2, 3))
    tau = t2 + t11 - t11.transpose(2, 3)

    Foo = f[o, o] - torch.diag(torch.diagonal(f[o, o]))
    Fvv = f[v, v] - torch.diag(torch.diagonal(f[v, v]))

    Fae = (Fvv - 0.5 * ein("me,ma->ae", fov, t1)
           + ein("mf,mafe->ae", t1, B["ovvv"])
           - 0.5 * ein("mnaf,mnef->ae", tau_t, B["oovv"]))
    Fmi = (Foo + 0.5 * ein("ie,me->mi", t1, fov)
           + ein("ne,mnie->mi", t1, B["ooov"])
           + 0.5 * ein("inef,mnef->mi", tau_t, B["oovv"]))
    Fme = fov + ein("nf,mnef->me", t1, B["oovv"])

    w1 = ein("je,mnie->mnij", t1, B["ooov"])
    Wmnij = (B["oooo"] + w1 - w1.transpose(2, 3)
             + 0.25 * ein("ijef,mnef->mnij", tau, B["oovv"]))
    w2 = ein("mb,amef->abef", t1, B["vovv"])
    Wabef = (B["vvvv"] - w2 + w2.transpose(0, 1)
             + 0.25 * ein("mnab,mnef->abef", tau, B["oovv"]))
    Wmbej = (B["ovvo"]
             + ein("jf,mbef->mbej", t1, B["ovvv"])
             - ein("nb,mnej->mbej", t1, B["oovo"])
             - ein("jnfb,mnef->mbej",
                   0.5 * t2 + ein("jf,nb->jnfb", t1, t1), B["oovv"]))

    t1new = (f[v, o].T
             + ein("ie,ae->ia", t1, Fae)
             - ein("ma,mi->ia", t1, Fmi)
             + ein("imae,me->ia", t2, Fme)
             - ein("nf,naif->ia", t1, B["ovov"])
             - 0.5 * ein("imef,maef->ia", t2, B["ovvv"])
             - 0.5 * ein("mnae,nmei->ia", t2, B["oovo"])) / D1

    x_ab = ein("ijae,be->ijab", t2, Fae - 0.5 * ein("mb,me->be", t1, Fme))
    x_ij = ein("imab,mj->ijab", t2, Fmi + 0.5 * ein("je,me->mj", t1, Fme))
    x_ring = (ein("imae,mbej->ijab", t2, Wmbej)
              - ein("ie,ma,mbej->ijab", t1, t1, B["ovvo"]))
    t2new = (B["vvoo"].permute(2, 3, 0, 1)         # <ab||ij>
             + _pab(x_ab) - _pij(x_ij)
             + 0.5 * ein("mnab,mnij->ijab", tau, Wmnij)
             + 0.5 * ein("ijef,abef->ijab", tau, Wabef)
             + _pij(_pab(x_ring))
             + _pij(ein("ie,abej->ijab", t1, B["vvvo"]))
             - _pab(ein("ma,mbij->ijab", t1, B["ovoo"]))) / D2
    return t1new, t2new


def energy(t1, t2, f, eri, no):
    """CC correlation energy <0|H̄|0> (real part), a 0-d tensor."""
    o, v = slice(None, no), slice(no, None)
    oovv = eri[o, o, v, v]
    e = (ein("ia,ia->", f[o, v], t1)
         + 0.25 * ein("ijab,ijab->", oovv, t2)
         + 0.5 * ein("ijab,ia,jb->", oovv, t1, t1))
    return e.real


def _mp2_start(f, eri, no):
    """t1 = f_ai / D1 and t2 = <ab||ij> / D2, the first-order amplitudes."""
    e = torch.diagonal(f).real
    D1 = e[:no, None] - e[None, no:]
    D2 = (e[:no, None, None, None] + e[None, :no, None, None]
          - e[None, None, no:, None] - e[None, None, None, no:])
    return f[no:, :no].T / D1, eri[no:, no:, :no, :no].permute(2, 3, 0, 1) / D2


def kernel(f, eri, nocc, conv_tol=1e-9, max_cycle=100, diis_space=8,
           verbose=False):
    """Solve the CCSD amplitude equations on the device of ``eri``.

    Args:
        f: (nso, nso) Fock matrix (real or complex Hermitian).
        eri: (nso,)*4 antisymmetrized <pq||rs>.
        nocc: number of occupied spin orbitals (leading block).
    Returns dict with e_corr (float), t1, t2 (tensors), converged, niter.
    """
    eri = _t(eri)
    f = _t(f, eri.device)
    f = f.to(torch.promote_types(f.dtype, eri.dtype))
    no = int(nocc)
    nv = f.shape[0] - no
    t1, t2 = _mp2_start(f, eri, no)
    B = make_blocks(eri, no)

    diis = DIIS(space=diis_space)
    e_last = float(energy(t1, t2, f, eri, no))
    conv = False
    it = 0
    for it in range(1, max_cycle + 1):
        t1n, t2n = _update_blocks(t1, t2, f, B, no)
        vec = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        err = vec - torch.cat([t1.reshape(-1), t2.reshape(-1)])
        vec = diis.update(vec, err)
        t1 = vec[:no * nv].reshape(no, nv)
        t2 = vec[no * nv:].reshape(no, no, nv, nv)
        e_cc = float(energy(t1, t2, f, eri, no))
        de = abs(e_cc - e_last)
        rnorm = float(torch.linalg.norm(err))
        if verbose:
            print(f"CCSD cycle {it:3d}  E_corr = {e_cc:.12f}  "
                  f"dE = {de:.2e}  |r| = {rnorm:.2e}")
        e_last = e_cc
        if de < conv_tol and rnorm < np.sqrt(conv_tol):
            conv = True
            break
    return {"e_corr": e_last, "t1": t1, "t2": t2, "converged": conv,
            "niter": it}


def _split_einsum(eq, *ops):
    """``torch.einsum`` over DTensors that are split (``Shard``) along one
    index label, by hand: each rank contracts its local pieces, with the
    replicated operands narrowed to its columns of that label. The result
    is split along the label when the output keeps it, else a partial sum
    (``Partial``). Of operands split along different labels the largest is
    kept split and the others are gathered; partial operands are reduced
    first. DTensor's own einsum flattens split dimensions, which its
    propagation refuses in some torch versions (2.11), and left to itself
    it forms the (nv,)*4 ladder tau <mn||ef> whole on every rank: here it
    stays split over f, the larger operand <mn||ef> being kept split.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lhs, out = eq.replace(" ", "").split("->")
    labels = lhs.split(",")
    mesh = next(o.device_mesh for o in ops if isinstance(o, DTensor))
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(o, mesh, [Replicate()])
           for o in ops]
    ops = [o.redistribute(placements=[Replicate()]) if o.placements[0].is_partial()
           else o for o in ops]
    size = {lab: n for lb, o in zip(labels, ops) for lab, n in zip(lb, o.shape)}
    split = [(o.numel(), i, labels[i][o.placements[0].dim])
             for i, o in enumerate(ops) if o.placements[0].is_shard()]
    if not split:
        return DTensor.from_local(torch.einsum(eq, *[o.to_local() for o in ops]), mesh,
                                  [Replicate()])
    lab = max(split)[2]
    n, world, rank = size[lab], mesh.size(), mesh.get_local_rank()
    width = -(-n // world)                       # torch.chunk's split of Shard
    start = min(rank * width, n)
    stop = min(start + width, n)
    pieces = []
    for i, o in enumerate(ops):
        if o.placements[0].is_shard() and labels[i][o.placements[0].dim] == lab:
            pieces.append(o.to_local())
            continue
        full = o if o.placements[0].is_replicate() else o.redistribute(
            placements=[Replicate()])
        t = full.to_local()
        if lab in labels[i]:
            t = t.narrow(labels[i].index(lab), start, stop - start)
        pieces.append(t)
    res = torch.einsum(eq, *pieces).contiguous()
    if lab not in out:
        return DTensor.from_local(res, mesh, [Partial()])
    shape = tuple(size[c] for c in out)
    stride = tuple(int(torch.tensor(shape[k + 1:]).prod()) for k in range(len(shape)))
    return DTensor.from_local(res, mesh, [Shard(out.index(lab))], shape=shape,
                              stride=stride)


def kernel_sharded(f, eri, nocc, mesh=None, conv_tol=1e-9, max_cycle=100,
                   diis_space=8, verbose=False):
    """SPMD CCSD over the ranks of a process group, the reference's mpicc
    analog (pyscf/pbc/mpicc, MPI-parallel KCCSD), done with
    ``torch.distributed.tensor``: every ``*v`` block of
    :func:`make_blocks` and t2 are DTensors split over their trailing
    virtual axis (``Shard(3)``), f, t1 and the other blocks replicated, and
    the same :func:`_update_blocks` runs on them, its einsums through
    :func:`_split_einsum` and its elementwise terms through DTensor's
    propagation (collectives inserted by the two). Each rank stores 1/P of
    t2 and of every ``*v`` block.
    DIIS runs on the local pieces: the Gram of the error vectors is the
    replicated t1 part plus the all_reduce of the local t2 parts.

    Args:
        f, eri, nocc: as :func:`kernel`, the same on every rank.
        mesh: a 1-D ``DeviceMesh`` (default: every rank of the default
            process group, on the device type of ``eri``).
    Returns dict with e_corr (float), t1 (replicated tensor), t2 (a DTensor
    split over its last axis), blocks (the placed integral blocks),
    converged, niter.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    eri = _t(eri)
    f = _t(f, eri.device)
    f = f.to(torch.promote_types(f.dtype, eri.dtype))
    no = int(nocc)
    nv = f.shape[0] - no
    if mesh is None:
        mesh = init_device_mesh(eri.device.type, (dist.get_world_size(),))
    rep, split = [Replicate()], [Shard(3)]

    def place(x, placements):       # every rank holds x: no data moves
        return distribute_tensor(x.contiguous(), mesh, placements,
                                 src_data_rank=None)

    B = {k: place(b, split if k[-1] == "v" else rep)
         for k, b in make_blocks(eri, no).items()}
    f_d = place(f, rep)
    t1, t2 = _mp2_start(f, eri, no)
    t1, t2 = place(t1, rep), place(t2, split)
    t2_shape = (no, no, nv, nv)
    t2_stride = (no * nv * nv, nv * nv, nv, 1)
    fov = f_d[:no, no:]

    def e_corr(t1, t2):
        terms = ((1.0, _split_einsum("ia,ia->", fov, t1)),
                 (0.25, _split_einsum("ijab,ijab->", B["oovv"], t2)),
                 (0.5, _split_einsum("ijab,ia,jb->", B["oovv"], t1, t1)))
        return sum(c * float(x.full_tensor().real) for c, x in terms)

    vecs, errs = [], []
    e_last = e_corr(t1, t2)
    conv = False
    it = 0
    for it in range(1, max_cycle + 1):
        t1n, t2n = _update_blocks(t1, t2, f_d, B, no, ein=_split_einsum)
        # contiguous local pieces: from_local below states contiguous strides
        t1n = t1n.redistribute(mesh, rep).to_local().contiguous()
        t2n = t2n.redistribute(mesh, split).to_local().contiguous()
        vecs.append((t1n, t2n))
        errs.append(((t1n - t1.to_local()).reshape(-1),
                     (t2n - t2.to_local()).reshape(-1)))
        if len(vecs) > diis_space:
            vecs.pop(0)
            errs.pop(0)
        E1 = torch.stack([e[0] for e in errs])
        E2 = torch.stack([e[1] for e in errs])
        g2 = (E2.conj() @ E2.T).real.contiguous()
        dist.all_reduce(g2, group=mesh.get_group())
        gram = ((E1.conj() @ E1.T).real + g2).cpu().numpy()
        if len(vecs) >= 2:
            c = diis_coefficients(gram)
            t1l = sum(float(ci) * v[0] for ci, v in zip(c, vecs))
            t2l = sum(float(ci) * v[1] for ci, v in zip(c, vecs))
        else:
            t1l, t2l = t1n, t2n
        t1 = DTensor.from_local(t1l, mesh, rep)
        t2 = DTensor.from_local(t2l, mesh, split, shape=t2_shape,
                                stride=t2_stride)
        e_cc = e_corr(t1, t2)
        de = abs(e_cc - e_last)
        rnorm = float(np.sqrt(gram[-1, -1]))
        if verbose:
            print(f"CCSD(sharded) cycle {it:3d}  E_corr = {e_cc:.12f}  "
                  f"dE = {de:.2e}  |r| = {rnorm:.2e}")
        e_last = e_cc
        if de < conv_tol and rnorm < np.sqrt(conv_tol):
            conv = True
            break
    return {"e_corr": e_last, "t1": t1.to_local(), "t2": t2, "blocks": B,
            "converged": conv, "niter": it}


def _t_energy(t1, t2, f, eri, no):
    o, v = slice(None, no), slice(no, None)
    e = torch.diagonal(f).real
    eo, ev = e[:no], e[no:]
    D3 = (eo[:, None, None, None, None, None]
          + eo[None, :, None, None, None, None]
          + eo[None, None, :, None, None, None]
          - ev[None, None, None, :, None, None]
          - ev[None, None, None, None, :, None]
          - ev[None, None, None, None, None, :])

    # connected triples driving term, complex-safe orientations
    # <bc||ei> (projection virtuals bra, amplitude virtual + projection
    # occupied ket) and <ma||jk>
    xc = (ein("jkae,bcei->ijkabc", t2, eri[v, v, v, o])
          - ein("imbc,majk->ijkabc", t2, eri[o, v, o, o]))

    def p_ijk(x):
        return x - x.transpose(0, 1) - x.transpose(0, 2)

    def p_abc(x):
        return x - x.transpose(3, 4) - x.transpose(3, 5)

    xc = p_ijk(p_abc(xc))
    xd = p_ijk(p_abc(ein("ia,bcjk->ijkabc", t1, eri[v, v, o, o])))
    return (xc.conj() * (xc + xd) / D3).sum().real / 36.0


def ccsd_t(t1, t2, f, eri, nocc):
    """Perturbative triples E(T) (Raghavachari et al. 1989, the standard
    spin-orbital expression; it vanishes identically for two electrons).

    Builds the whole (no^3, nv^3) triples tensor: at the diamond 2x1x1
    supercell (no = nv = 16 spin orbitals) that is 268 MB complex."""
    eri = _t(eri)
    dev = eri.device
    f = _t(f, dev)
    f = f.to(torch.promote_types(f.dtype, eri.dtype))
    return float(_t_energy(_t(t1, dev), _t(t2, dev), f, eri, int(nocc)))


def thc_mo_eri(isdf, mo_coeff):
    """Full chemist MO ERI tensor from the ISDF/THC factors, on the device
    of the factorization:

        (pq|rs) ~= sum_PQ X_pP X_qP W_PQ X_rQ X_sQ,   X = aoRg @ C
    """
    Xg = isdf.aoRg @ _t(mo_coeff, isdf.aoRg.device).to(isdf.aoRg.dtype)
    nmo = Xg.shape[1]
    pair = (Xg[:, :, None] * Xg[:, None, :]).reshape(len(isdf.W), nmo * nmo)
    out = pair.T @ (isdf.W @ pair)
    return out.reshape(nmo, nmo, nmo, nmo)


def _mo_eri_gamma(system, mo_c):
    """Chemist (pq|rs) over the columns of ``mo_c`` from the FFT-grid
    transform (df/fft_ao2mo.general)."""
    from pyscf_isdf_tpu_torch.df import fft_ao2mo

    n = mo_c.shape[1]
    moR = system.aoR @ mo_c.to(system.aoR.dtype)
    return fft_ao2mo.general(moR, moR, moR, moR, system.coulG, system.mesh,
                             system.weight).reshape(n, n, n, n)


def ccsd(system, scf_res, nocc=None, with_t=False, conv_tol=1e-9,
         max_cycle=100, verbose=False, isdf=None, device=None):
    """Gamma-point closed-shell CCSD on a converged RHF/RKS reference, on
    ``device`` (default: the GPU), where ``system`` must live.

    ERIs from the FFT-grid MO transform (df/fft_ao2mo.general), or from the
    THC factors of ``isdf`` (:func:`thc_mo_eri`); orbital energies as they
    are (the exxdiv convention matches mp/mp2.py).
    """
    dev = require_device(system.aoR, device)
    mo_e = _t(scf_res["mo_energy"], dev).to(torch.float64)
    mo_c = _t(scf_res["mo_coeff"], dev)
    if nocc is None:
        nocc = system.nelec // 2
    if isdf is not None:
        eri_mo = thc_mo_eri(isdf, mo_c)          # the THC-CCSD integrals
    else:
        eri_mo = _mo_eri_gamma(system, mo_c)

    _, eri_so = spinorb_from_spatial(torch.diag(mo_e), eri_mo)
    f_so = torch.diag(mo_e.repeat_interleave(2))

    out = kernel(f_so, eri_so, 2 * nocc, conv_tol=conv_tol,
                 max_cycle=max_cycle, verbose=verbose)
    out["e_hf"] = scf_res["e_tot"]
    out["e_tot"] = scf_res["e_tot"] + out["e_corr"]
    if with_t:
        out["e_t"] = ccsd_t(out["t1"], out["t2"], f_so, eri_so, 2 * nocc)
        out["e_tot"] += out["e_t"]
    return out


def uhf_spinorb_basis(mo_coeff, mo_energy, nelec):
    """Occupied-first spin-orbital basis from a UHF reference.

    Columns are ordered [occ-alpha, occ-beta, vir-alpha, vir-beta] so the
    spin-agnostic kernels (this module's, cc/kccsd_blocked's) see one
    leading occupied block. Returns (C_cat, e_so, sz, nocc_so): C_cat
    stacks the per-spin spatial coefficients column-wise (a tensor on the
    device of ``mo_coeff``), e_so the float64 energies there, sz the numpy
    spin label of each column (0 alpha, 1 beta).
    """
    ca, cb = (_t(c) for c in mo_coeff)
    ea, eb = (_t(e, ca.device).to(torch.float64) for e in mo_energy)
    cb = cb.to(ca.device)
    na, nb = (int(n) for n in nelec)
    nma, nmb = ca.shape[1], cb.shape[1]
    C_cat = torch.cat([ca[:, :na], cb[:, :nb], ca[:, na:], cb[:, nb:]], dim=1)
    e_so = torch.cat([ea[:na], eb[:nb], ea[na:], eb[nb:]])
    sz = np.concatenate([np.zeros(na, int), np.ones(nb, int),
                         np.zeros(nma - na, int), np.ones(nmb - nb, int)])
    return C_cat, e_so, sz, na + nb


def antisymmetrize_spin_chem(chem, sz):
    """<PQ||RS> from chemist (PQ|RS) over spin-labelled columns.

    Unlike :func:`spinorb_from_spatial` (which expands a spatial tensor),
    the input is already an ERI over spin-orbital columns with per-spin
    spatial parts (UHF); only the spin masks and the chemist-to-physicist
    reorder and antisymmetrization remain.
    """
    chem = _t(chem)
    sz = torch.as_tensor(np.asarray(sz), device=chem.device)
    same = sz[:, None] == sz[None, :]
    chem = chem * (same[:, :, None, None] & same[None, None, :, :])
    phys = chem.permute(0, 2, 1, 3)
    return phys - phys.transpose(2, 3)


def uccsd(system, scf_res, with_t=False, conv_tol=1e-9, max_cycle=100,
          verbose=False, device=None):
    """Gamma-point spin-unrestricted CCSD (and optionally (T)) on a UHF/UKS
    reference, on ``device`` (default: the GPU), where ``system`` must live.

    Reference contract: pyscf/cc/uccsd.py. The UHF spin orbitals feed the
    one spin-orbital engine (:func:`kernel`), the same program that serves
    RHF through :func:`spinorb_from_spatial`; for a closed-shell reference
    it reduces to :func:`ccsd`.
    """
    dev = require_device(system.aoR, device)
    nelec = scf_res.get("nelec") or _uhf_nelec_fallback(system)
    C_cat, e_so, sz, nocc_so = uhf_spinorb_basis(
        tuple(_t(c, dev) for c in scf_res["mo_coeff"]),
        scf_res["mo_energy"], nelec)
    eri_so = antisymmetrize_spin_chem(_mo_eri_gamma(system, C_cat), sz)
    f_so = torch.diag(e_so)

    out = kernel(f_so, eri_so, nocc_so, conv_tol=conv_tol,
                 max_cycle=max_cycle, verbose=verbose)
    out["e_hf"] = scf_res["e_tot"]
    out["e_tot"] = scf_res["e_tot"] + out["e_corr"]
    if with_t:
        out["e_t"] = ccsd_t(out["t1"], out["t2"], f_so, eri_so, nocc_so)
        out["e_tot"] += out["e_t"]
    return out


def _uhf_nelec_fallback(system):
    cell = system.cell
    na = (cell.nelectron + cell.spin) // 2
    return na, cell.nelectron - na

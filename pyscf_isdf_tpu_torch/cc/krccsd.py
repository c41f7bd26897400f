"""Closed-shell (spatial-orbital) k-point CCSD, the production memory tier
(torch).

The blocked spin-orbital kernel (cc/kccsd_blocked.py) stores O(nk^3)
blocks, but spin-orbital blocks carry a 16-fold redundancy for an RHF
reference: at diamond 2x2x2 gth-dzvp its vvvv class alone is 30.7 GB. The
reference's production KCCSD is spatial-orbital
(pyscf/pbc/cc/kccsd_rhf.py:51-107).

No hand-transcribed closed-shell equations: for an RHF reference every
tensor of the spin-orbital CCSD program is fixed by at most three spatial
components (spin-flip symmetry and Sz conservation leave these patterns):

    4-index: c00 = T(up,up,up,up), cab = T(up,dn,up,dn),
             cba = T(up,dn,dn,up)           (mirrors by spin flip)
    2-index: one spin-diagonal component.

The spin sum of every contraction is enumerated mechanically
(:func:`skein`) and each surviving term runs through the momentum-blocked
einsum engine (kccsd_blocked.kein). The amplitude program is the
unchanged Stanton spin-orbital program of cc/gccsd.py.

Sizes at diamond 2x2x2 gth-dzvp (nmo 26, nocc 4, nvir 22 a k-point): each
stored spatial tensor (the 12 classes of <pq|rs> or <pq|sr>) is 3.26 GB,
the three components of the integrals 9.8 GB, the mixed-spin amplitude
63 MB. The largest gathered operand, Wabef for "ijef,abef->ijab" on the
(512 x 8)-block grid, is 15.4 GB per spin group; kein takes it in chunks
of ``kccsd_blocked.GATHER_BYTES``.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from pyscf_isdf_tpu_torch.cc.kccsd_blocked import (
    AO2MO_CHUNK, KAlgebra, _perm_last2, _scf_arrays, _transpose_t2_to_vvoo,
    blocked_denominators, kein, symmetrized_phys_tensor,
)
from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.scf.diis import DIIS
from pyscf_isdf_tpu_torch.utils.timing import null_timer

_P00 = (0, 0, 0, 0)
_PAB = (0, 1, 0, 1)
_PBA = (0, 1, 1, 0)
_P4 = (_P00, _PAB, _PBA)


def _flip(p):
    return tuple(1 - s for s in p)


def _canon(p):
    """Canonical key (first spin 0); RHF spin-flip symmetry is sign-free."""
    return _flip(p) if p[0] == 1 else p


class SK:
    """RHF spin-component tensor: dict {canonical pattern: blocked tensor}.

    4-index entries use kccsd_blocked's momentum-blocked layout
    (nk,nk,nk,d1..d4, fourth momentum implied); 2-index (nk,d1,d2).
    Missing patterns are zero.
    """

    def __init__(self, comps):
        self.c = dict(comps)

    @property
    def is2(self):
        return all(len(k) == 2 for k in self.c)

    def get(self, pattern):
        return self.c.get(_canon(pattern))

    def _binop(self, other, op):
        if isinstance(other, SK):
            out = {}
            for k in set(self.c) | set(other.c):
                a, b = self.c.get(k), other.c.get(k)
                if a is None:
                    a = torch.zeros_like(b)
                if b is None:
                    b = torch.zeros_like(a)
                out[k] = op(a, b)
            return SK(out)
        return SK({k: op(v, other) for k, v in self.c.items()})

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __mul__(self, s):
        return SK({k: v * s for k, v in self.c.items()})

    __rmul__ = __mul__

    def __truediv__(self, d):
        return SK({k: v / d for k, v in self.c.items()})


def _perm_pattern(p, perm):
    return tuple(p[i] for i in perm)


def sk_perm_ab(skt, ka):
    """Swap the two trailing labels (3rd/4th): the blocked _perm_last2 and
    the pattern reshuffle."""
    out = {}
    for p, arr in skt.c.items():
        q = _canon(_perm_pattern(p, (0, 1, 3, 2)))
        out[q] = out.get(q, 0) + _perm_last2(arr, ka)
    return SK(out)


def sk_perm_ij(skt):
    """Swap the two leading labels (1st/2nd): block axes (0,1) and orbital
    axes (3,4) and the pattern reshuffle."""
    out = {}
    for p, arr in skt.c.items():
        q = _canon(_perm_pattern(p, (1, 0, 2, 3)))
        out[q] = out.get(q, 0) + arr.transpose(0, 1).transpose(3, 4)
    return SK(out)


def _valid4(s):
    return s[0] + s[1] == s[2] + s[3]


def _valid(s):
    return _valid4(s) if len(s) == 4 else s[0] == s[1]


_GROUPS = {}


def _spin_groups(spec, keys_a, keys_b):
    """{(pattern of A, pattern of B, output pattern): weight} of ``spec``'s
    spin sum over the stored components ``keys_a``/``keys_b`` (cached)."""
    key = (spec, keys_a, keys_b)
    if key in _GROUPS:
        return _GROUPS[key]
    ins, out = spec.split("->")
    tA, tB = ins.split(",")
    labels = sorted(set(tA + tB + out))
    groups = {}
    for assign in itertools.product((0, 1), repeat=len(labels)):
        s = dict(zip(labels, assign))
        sa = tuple(s[x] for x in tA)
        sb = tuple(s[x] for x in tB)
        so = tuple(s[x] for x in out)
        if not (_valid(sa) and _valid(sb)):
            continue
        if out:
            if not _valid(so) or so[0] == 1:
                continue          # a mirror pattern: implied by symmetry
        ca, cb = _canon(sa), _canon(sb)
        if ca not in keys_a or cb not in keys_b:
            continue              # a zero component
        g = (ca, cb, so)
        groups[g] = groups.get(g, 0) + 1
    _GROUPS[key] = groups
    return groups


def skein(spec, A: SK, B: SK, ka: KAlgebra):
    """Spin-enumerated, momentum-blocked einsum between SK tensors.

    Enumerates up/dn assignments of the einsum labels, keeps those that
    conserve Sz on every tensor, groups assignments that touch identical
    stored components (spin-flip mirrors), and runs each group once
    through the momentum engine with an integer weight.
    """
    groups = _spin_groups(spec, frozenset(A.c), frozenset(B.c))
    out_c = {}
    scalar = 0.0
    for (ca, cb, so), w in groups.items():
        val = kein(spec, A.c[ca], B.c[cb], ka)
        if not so:
            scalar = scalar + w * val
        else:
            out_c[so] = out_c.get(so, 0) + w * val
    if not spec.split("->")[1]:
        return scalar
    return SK(out_c)


# ------------------------------------------------------------ the program
def make_rupdate(ka: KAlgebra):
    """Closed-shell blocked CCSD update: the gccsd._update_blocks program
    on SK tensors (the spin sum mechanical, the momenta blocked)."""

    def pij(x):
        return x - sk_perm_ij(x)

    def pab(x):
        return x - sk_perm_ab(x, ka)

    def update(t1, t2, fov, B, D1, D2, abij):
        def sein(s, a, b):
            return skein(s, a, b, ka)

        t11 = sein("ia,jb->ijab", t1, t1)
        tau_t = t2 + 0.5 * (t11 - sk_perm_ab(t11, ka))
        tau = t2 + t11 - sk_perm_ab(t11, ka)

        Fae = (sein("mf,mafe->ae", t1, B["ovvv"])
               - 0.5 * sein("mnaf,mnef->ae", tau_t, B["oovv"]))
        Fmi = (sein("ne,mnie->mi", t1, B["ooov"])
               + 0.5 * sein("inef,mnef->mi", tau_t, B["oovv"]))
        Fme = fov + sein("nf,mnef->me", t1, B["oovv"])

        w1 = sein("je,mnie->mnij", t1, B["ooov"])
        Wmnij = (B["oooo"] + w1 - sk_perm_ab(w1, ka)
                 + 0.25 * sein("ijef,mnef->mnij", tau, B["oovv"]))
        w2 = sein("mb,amef->abef", t1, B["vovv"])
        Wabef = (B["vvvv"] - w2 + sk_perm_ij(w2)
                 + 0.25 * sein("mnab,mnef->abef", tau, B["oovv"]))
        t1t1 = sein("jf,nb->jnfb", t1, t1)
        Wmbej = (B["ovvo"]
                 + sein("jf,mbef->mbej", t1, B["ovvv"])
                 - sein("nb,mnej->mbej", t1, B["oovo"])
                 - sein("jnfb,mnef->mbej", 0.5 * t2 + t1t1, B["oovv"]))

        t1new = (sein("ie,ae->ia", t1, Fae)
                 - sein("ma,mi->ia", t1, Fmi)
                 + sein("imae,me->ia", t2, Fme)
                 - sein("nf,naif->ia", t1, B["ovov"])
                 - 0.5 * sein("imef,maef->ia", t2, B["ovvv"])
                 - 0.5 * sein("mnae,nmei->ia", t2, B["oovo"])) / D1

        x_ab = sein("ijae,be->ijab", t2,
                    Fae - 0.5 * sein("mb,me->be", t1, Fme))
        x_ij = sein("imab,mj->ijab", t2,
                    Fmi + 0.5 * sein("je,me->mj", t1, Fme))
        ring_t1 = sein("ma,mbej->abej", t1, B["ovvo"])
        x_ring = (sein("imae,mbej->ijab", t2, Wmbej)
                  - sein("ie,abej->ijab", t1, ring_t1))
        t2new = (abij
                 + pab(x_ab) - pij(x_ij)
                 + 0.5 * sein("mnab,mnij->ijab", tau, Wmnij)
                 + 0.5 * sein("ijef,abef->ijab", tau, Wabef)
                 + pij(pab(x_ring))
                 + pij(sein("ie,abej->ijab", t1, B["vvvo"]))
                 - pab(sein("ma,mbij->ijab", t1, B["ovoo"]))) / D2
        return t1new, t2new

    return update


def sk_energy(t1, t2, B_oovv, ka):
    """<0|Hbar|0> (canonical f): 0.25 sum <ij||ab>(t2 + 2 t1 t1)."""
    t11 = skein("ia,jb->ijab", t1, t1, ka)
    e = skein("ijab,ijab->", B_oovv, t2 + 2.0 * t11, ka)
    return float(e.real) * 0.25


# ------------------------------------------------------- integral builder
_CLASSES = ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovoo", "oovo",
            "ovvv", "vovv", "vvvo", "vvoo", "vvvv")


def _t2_from_mixed(T, ka):
    """The SK amplitude from its mixed (up,dn,up,dn) component:
    c00 = T - perm_ab(T); cba = -perm_ab(T)."""
    Tp = _perm_last2(T, ka)
    return SK({_P00: T - Tp, _PAB: T, _PBA: -Tp})


def build_spatial_eris(system, scf_res, device=None, timer=None):
    """Momentum-blocked spatial <pq||rs> spin components per o/v class, on
    ``device`` (default: the GPU), where ``system`` must live.

    Per block (k1,k2,k3): direct V = <pq|rs> and exchange Vx = <pq|sr>
    from fft_ao2mo.ao2mo_7d (1/nk supercell normalization), both gathers
    of the symmetrized tensor; components c00 = V - Vx, cab = V,
    cba = -Vx. ``timer`` (a StageTimer) records 'ao2mo_7d',
    'symmetrize' and 'classes'.
    Returns (ka, B, eo, ev, no, nv) with eo/ev (nk, no/nv) numpy.
    """
    from pyscf_isdf_tpu_torch.df import fft_ao2mo

    timer = timer or null_timer
    dev = require_device(system.aoR_k, device)
    mo_c, mo_e, mo_occ = _scf_arrays(scf_res, dev)
    kpts = system.kpts
    nk = len(kpts)
    ka = KAlgebra(system.cell.a, kpts)

    noccs = (mo_occ > 0.5).sum(axis=1)
    if not np.all(noccs == noccs[0]):
        raise NotImplementedError(
            "closed-shell blocked KCCSD needs uniform per-k occupation")
    mo_cs, mo_es = [], []
    for k in range(nk):
        perm = np.argsort(mo_occ[k] < 0.5, kind="stable")
        mo_cs.append(mo_c[k][:, torch.as_tensor(perm, device=dev)])
        mo_es.append(mo_e[k][perm])
    no = int(noccs[0])
    nmo = mo_c[0].shape[1]
    nv = nmo - no

    with timer("ao2mo_7d"):
        eri7 = fft_ao2mo.ao2mo_7d(system, mo_cs, chunk=AO2MO_CHUNK, device=dev)
    with timer("symmetrize"):
        Vs = symmetrized_phys_tensor(eri7, ka, nk, nmo)
        del eri7
    with timer("classes"):
        g1, g2, _, g4 = ka.grid()
        xsrc = torch.as_tensor((g1 * nk + g2) * nk + g4, device=dev)
        Vf = Vs.reshape((nk**3,) + Vs.shape[3:])
        ix = {"o": slice(0, no), "v": slice(no, nmo)}
        B = {}
        for name in _CLASSES:
            s0, s1, s2, s3 = (ix[c] for c in name)
            V = Vf[:, s0, s1, s2, s3].contiguous()
            # <pq|sr> = Vs[k1,k2,k4] with its last two axes swapped
            Vx = Vf[:, s0, s1, s3, s2].index_select(0, xsrc).transpose(-1, -2)
            shp = (nk, nk, nk) + V.shape[1:]
            V, Vx = V.reshape(shp), Vx.reshape(shp)
            B[name] = SK({_P00: V - Vx, _PAB: V, _PBA: -Vx})
        del Vs, Vf

    e_k = np.stack(mo_es)
    return ka, B, e_k[:, :no], e_k[:, no:], no, nv


def _abij(B, ka):
    return SK({p: _transpose_t2_to_vvoo(arr, ka)
               for p, arr in B["vvoo"].c.items()})


def krccsd(system, scf_res, conv_tol=1e-9, max_cycle=100, diis_space=8,
           verbose=False, device=None, timer=None):
    """Closed-shell blocked KCCSD on ``device`` (default: the GPU), where
    ``system`` must live; e_corr per unit cell.

    Iterates on the mixed-spin spatial amplitude T[ki,kj,ka](i,j,a,b) (all
    other spin components are its antisymmetrizations); memory and flops
    are the spatial-orbital tier of the reference's kccsd_rhf. ``timer``
    records the ERI build's stages (:func:`build_spatial_eris`) and
    'iteration'. The result also carries 'e_mp2', the energy of the start
    (t1 = 0, t2 = MP2) per cell.
    """
    timer = timer or null_timer
    nk = len(system.kpts)
    ka, B, eo, ev, no, nv = build_spatial_eris(system, scf_res, device, timer)
    dev = B["oovv"].c[_PAB].device
    D1, D2 = blocked_denominators(ka, eo, ev, dev)

    dt = B["oovv"].c[_PAB].dtype
    fov = SK({(0, 0): torch.zeros((nk, no, nv), dtype=dt, device=dev)})
    abij = _abij(B, ka)
    T = abij.c[_PAB] / D2                      # MP2 start (mixed spin)
    t2 = _t2_from_mixed(T, ka)
    t1a = torch.zeros((nk, no, nv), dtype=T.dtype, device=dev)
    t1 = SK({(0, 0): t1a})

    update = make_rupdate(ka)
    diis = DIIS(space=diis_space)
    e_last = sk_energy(t1, t2, B["oovv"], ka)
    e_mp2 = e_last / nk
    conv = False
    it = 0
    n1 = t1a.numel()
    for it in range(1, max_cycle + 1):
        with timer("iteration"):
            t1n, t2n = update(t1, t2, fov, B, D1, D2, abij)
            Tn = t2n.c[_PAB]
            vec = torch.cat([t1n.c[(0, 0)].reshape(-1), Tn.reshape(-1)])
            err = vec - torch.cat([t1.c[(0, 0)].reshape(-1), T.reshape(-1)])
            vec = diis.update(vec, err)
            t1a = vec[:n1].reshape(nk, no, nv)
            T = vec[n1:].reshape((nk, nk, nk, no, no, nv, nv))
            t1 = SK({(0, 0): t1a})
            t2 = _t2_from_mixed(T, ka)
            e_cc = sk_energy(t1, t2, B["oovv"], ka)
            rnorm = float(torch.linalg.norm(err))
        de = abs(e_cc - e_last)
        if verbose:
            print(f"kRCCSD cycle {it:3d}  E_sc = {e_cc:.12f}  "
                  f"dE = {de:.2e}  |r| = {rnorm:.2e}")
        e_last = e_cc
        if de < conv_tol * nk and rnorm < np.sqrt(conv_tol * nk):
            conv = True
            break
    return {"e_corr": e_last / nk, "t1": t1a, "t2": T, "converged": conv,
            "niter": it, "e_hf": scf_res["e_tot"],
            "e_tot": scf_res["e_tot"] + e_last / nk, "e_mp2": e_mp2}

"""Momentum-blocked spin-orbital k-point CCSD (torch).

The composite-index KCCSD (cc/kccsd.py) materializes a dense (nk nso)^4
tensor; the reference runs k-conservation-blocked CCSD storing nk^3 blocks
(pyscf/pbc/cc/kccsd_rhf.py:51-107). Every tensor of the spin-orbital CCSD
program satisfies one momentum invariant:

    4-index T[P,Q,R,S]:  k1 + k2 - k3 - k4 = 0 (mod G)
    2-index T[P,Q]:      k1 = k2

so blocked storage keeps the first three momenta explicit and the fourth
implied: arr.shape = (nk, nk, nk, d1, d2, d3, d4) with k4 = k1 + k2 - k3;
2-tensors are (nk, d1, d2).

A small k-blocked einsum engine (:func:`kein`) maps the unchanged Gamma
einsum program (cc/gccsd.py) onto blocks: the plan (gather indices and
conservation masks) is solved on the host once per contraction signature
and cached, and execution is index gathers plus one batched
``torch.einsum``. The gathers are materialized, so the outer block grid
is taken in chunks that keep each gathered operand under
``GATHER_BYTES``; the chunks' results are the unchunked one's rows.

Sizes at diamond 2x2x2 gth-dzvp (nso 52 a k-point, 8 occupied, 44
virtual): the spin-orbital vvvv class alone is nk^3 44^4 16 B = 30.7 GB,
so this tier runs at gth-szv there and the closed-shell spatial tier
(cc/krccsd.py) carries dzvp.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device
from pyscf_isdf_tpu_torch.kpts_helper import get_kconserv
from pyscf_isdf_tpu_torch.scf.diis import DIIS

# sentinel orbital energy for occupation-padding columns (the value of
# mp/kmp2._PAD_E): padded amplitudes ~ residual/1e9 with exactly-zero
# residuals, so identically zero
_PAD_E = 1e9

# the largest gathered operand of one kein chunk, in bytes
GATHER_BYTES = 2 << 30

# MO pairs a batch of the k-point ERI transform (fft_ao2mo.ao2mo_7d's
# ``chunk``): at diamond 2x2x2 gth-dzvp its 16 issues 22 thousand
# launch-bound FFT batches
AO2MO_CHUNK = 256


# ------------------------------------------------------------ k arithmetic
class KAlgebra:
    """Integer index arithmetic on the Monkhorst-Pack momentum group."""

    def __init__(self, cell_a, kpts):
        kpts = np.reshape(kpts, (-1, 3))
        self.nk = len(kpts)
        kcons = get_kconserv(cell_a, kpts)       # kp - kq + kr - ks = 0
        g0 = self._gamma_index(cell_a, kpts)
        # ksub[a,b] = a - b ; kadd[a,b] = a + b
        self.ksub = kcons[:, :, g0]              # a - b + 0 = s
        self.kadd = kcons[:, g0, :]              # a - 0 + b = s
        self.kcons = kcons
        # content fingerprint for the plan cache: id() keys are unsound (a
        # freed object's id is reused, and a stale plan from another k-mesh
        # would gather wrong blocks); the raw tables are tiny
        self.fingerprint = (self.nk, self.ksub.tobytes(),
                            self.kadd.tobytes())

    @staticmethod
    def _gamma_index(cell_a, kpts):
        b = 2 * np.pi * np.linalg.inv(np.asarray(cell_a)).T
        frac = kpts @ np.linalg.inv(b)
        wrapped = frac - np.rint(frac)
        i = int(np.argmin(np.einsum("ki,ki->k", wrapped, wrapped)))
        if not np.allclose(wrapped[i], 0, atol=1e-8):
            raise ValueError("k-point set contains no Gamma point image")
        return i

    def k4(self, k1, k2, k3):
        """Implied fourth momentum k1 + k2 - k3 (array-friendly)."""
        return self.ksub[self.kadd[k1, k2], k3]

    def grid(self):
        """The (k1, k2, k3, k4) of every block, flattened, as numpy."""
        nk = self.nk
        g1, g2, g3 = np.meshgrid(np.arange(nk), np.arange(nk), np.arange(nk),
                                 indexing="ij")
        g1, g2, g3 = g1.ravel(), g2.ravel(), g3.ravel()
        return g1, g2, g3, self.k4(g1, g2, g3)


_INDEX_CACHE = {}


def _block_index(ka, name, fn, device):
    """A flat block index tensor built by ``fn(ka)`` (numpy), cached on
    ``device`` per k-mesh."""
    key = (ka.fingerprint, name, str(device))
    if key not in _INDEX_CACHE:
        _INDEX_CACHE[key] = torch.as_tensor(np.ascontiguousarray(fn(ka)),
                                            dtype=torch.int64, device=device)
    return _INDEX_CACHE[key]


# ------------------------------------------------------------ einsum plans
class _Plan:
    __slots__ = ("sub_exec", "idx", "mask", "out_is_2t", "nout", "ninner",
                 "dev")

    def on(self, device):
        """(idx_a, idx_b, mask) as tensors on ``device`` (cached)."""
        key = str(device)
        if key not in self.dev:
            self.dev[key] = (
                *(torch.as_tensor(np.array(i), dtype=torch.int64, device=device)
                  for i in self.idx),
                None if self.mask is None
                else torch.as_tensor(self.mask, dtype=torch.float64,
                                     device=device))
        return self.dev[key]


def _labels(term):
    return list(term)


def _make_plan(spec, shapes2t, ka: KAlgebra):
    """Solve the momentum structure of one blocked einsum.

    Args:
        spec: e.g. "mnaf,mnef->ae" (binary contraction only).
        shapes2t: tuple of bools, operand/output is a 2-tensor.
        ka: the momentum group.

    Returns a _Plan with flat gather indices per operand over the
    (nout, ninner) enumeration grid and an optional conservation mask.
    """
    nk = ka.nk
    ins, out = spec.split("->")
    terms = ins.split(",")
    assert len(terms) == 2, "kein is binary; split 3-operand einsums"
    is2t = shapes2t

    # label -> k expression (numpy arrays over the enumeration grid)
    kexpr = {}
    # output labels define the outer grid
    out_l = _labels(out)
    if not out_l:                       # scalar output (full contraction)
        nout = 1
    elif is2t[-1]:
        nout = nk
        for lbl in out_l:
            kexpr[lbl] = np.arange(nk)
    else:
        nout = nk**3
        g1, g2, g3 = np.meshgrid(np.arange(nk), np.arange(nk),
                                 np.arange(nk), indexing="ij")
        g1, g2, g3 = g1.ravel(), g2.ravel(), g3.ravel()
        kexpr[out_l[0]], kexpr[out_l[1]], kexpr[out_l[2]] = g1, g2, g3
        kexpr[out_l[3]] = ka.k4(g1, g2, g3)

    # constraints from the operands
    constraints = []                 # ("4t", [a,b,c,d]) or ("2t", [a,b])
    for t, term in enumerate(terms):
        constraints.append(("2t" if is2t[t] else "4t", _labels(term)))

    inner_axes = []                  # labels enumerated as inner loops
    masks = []

    def known(lbl):
        return lbl in kexpr

    progress = True
    pending = list(constraints)
    while pending:
        if not progress:
            # promote one unknown label of the first pending constraint to
            # a new inner enumeration axis
            for _, ls in pending:
                unk = [x for x in ls if not known(x)]
                if unk:
                    lbl = unk[0]
                    for k in list(kexpr):
                        kexpr[k] = np.broadcast_to(kexpr[k][..., None],
                                                   kexpr[k].shape + (nk,))
                    new_shape = (nout,) + (nk,) * (len(inner_axes) + 1)
                    kexpr[lbl] = np.broadcast_to(np.arange(nk), new_shape)
                    inner_axes.append(lbl)
                    break
            progress = True
            continue
        progress = False
        remaining = []
        for kind, ls in pending:
            unk = [x for x in ls if not known(x)]
            if kind == "2t":
                a, b = ls
                if known(a) and known(b):
                    masks.append((a, b, "eq"))
                    progress = True
                elif known(a):
                    kexpr[b] = kexpr[a]
                    progress = True
                elif known(b):
                    kexpr[a] = kexpr[b]
                    progress = True
                else:
                    remaining.append((kind, ls))
            else:
                if len(unk) == 0:
                    masks.append((ls, None, "cons"))
                    progress = True
                elif len(unk) == 1:
                    a, b, c, d = ls
                    lbl = unk[0]
                    # solve k_lbl from k1 + k2 - k3 - k4 = 0
                    br = [kexpr[x] if x != lbl else None for x in ls]
                    shp = np.broadcast_shapes(*[
                        np.shape(x) for x in br if x is not None])
                    br = [None if x is None else np.broadcast_to(x, shp)
                          for x in br]
                    if lbl == a:
                        v = ka.ksub[ka.kadd[br[2], br[3]], br[1]]
                    elif lbl == b:
                        v = ka.ksub[ka.kadd[br[2], br[3]], br[0]]
                    elif lbl == c:
                        v = ka.ksub[ka.kadd[br[0], br[1]], br[3]]
                    else:
                        v = ka.ksub[ka.kadd[br[0], br[1]], br[2]]
                    kexpr[lbl] = v
                    progress = True
                else:
                    remaining.append((kind, ls))
        pending = remaining

    # broadcast every expression to the full grid shape
    full_shape = (nout,) + (nk,) * len(inner_axes)

    def expand(x):
        x = np.asarray(x)
        while x.ndim < len(full_shape):
            x = x[..., None]
        return np.broadcast_to(x, full_shape)

    for k in kexpr:
        kexpr[k] = expand(kexpr[k])

    mask = None
    for m in masks:
        if m[-1] == "eq":
            cur = (kexpr[m[0]] == kexpr[m[1]])
        else:
            a, b, c, d = m[0]
            cur = (ka.k4(kexpr[a], kexpr[b], kexpr[c]) == kexpr[d])
        mask = cur if mask is None else (mask & cur)

    # gather indices per operand
    idx = []
    for t, term in enumerate(terms):
        ls = _labels(term)
        if is2t[t]:
            idx.append(kexpr[ls[0]])
        else:
            k1, k2, k3 = kexpr[ls[0]], kexpr[ls[1]], kexpr[ls[2]]
            idx.append((k1 * nk + k2) * nk + k3)

    ninner = int(np.prod(full_shape[1:], dtype=np.int64))
    plan = _Plan()
    plan.idx = [np.ascontiguousarray(i.reshape(nout, ninner)) for i in idx]
    plan.mask = (None if mask is None
                 else np.ascontiguousarray(
                     mask.reshape(nout, ninner).astype(np.float64)))
    plan.out_is_2t = is2t[-1]
    plan.nout = nout
    plan.ninner = ninner
    plan.dev = {}
    # executable einsum: prepend grid axes X (outer) Y (inner)
    plan.sub_exec = (",".join("XY" + t for t in terms) + "->X" + out)
    return plan


_PLAN_CACHE = {}


def _plan(spec, shapes2t, ka):
    key = (spec, shapes2t, ka.fingerprint)
    if key not in _PLAN_CACHE:
        _PLAN_CACHE[key] = _make_plan(spec, shapes2t, ka)
    return _PLAN_CACHE[key]


def kein(spec, A, B, ka: KAlgebra, max_bytes=None):
    """Blocked einsum over momentum-conserving tensors.

    A, B and the output are blocked tensors: 4-tensors (nk,nk,nk,d1..d4)
    with the fourth momentum implied (k4 = k1+k2-k3), 2-tensors
    (nk,d1,d2). The momentum bookkeeping is solved on the host once per
    spec and cached; execution is index gathers and one batched einsum per
    chunk of the outer block grid, the chunk sized so that a gathered
    operand stays under ``max_bytes`` (default ``GATHER_BYTES``).
    """
    nk = ka.nk
    a2 = (A.ndim == 3)
    b2 = (B.ndim == 3)
    out = spec.split("->")[1]
    o2 = (len(out) == 2)
    p = _plan(spec, (a2, b2, o2), ka)
    idx_a, idx_b, mask = p.on(A.device)

    Af = A.reshape((nk if a2 else nk**3,) + A.shape[(1 if a2 else 3):])
    Bf = B.reshape((nk if b2 else nk**3,) + B.shape[(1 if b2 else 3):])
    row = p.ninner * max(Af[0].numel() * Af.element_size(),
                         Bf[0].numel() * Bf.element_size())
    step = max(1, int((GATHER_BYTES if max_bytes is None else max_bytes)
                      // max(row, 1)))
    parts = []
    for x0 in range(0, p.nout, step):
        x1 = min(x0 + step, p.nout)
        Ag = Af[idx_a[x0:x1]]
        Bg = Bf[idx_b[x0:x1]]
        if mask is not None:
            m = mask[x0:x1]
            Ag = Ag * m.reshape(m.shape + (1,) * (Ag.ndim - 2))
        parts.append(torch.einsum(p.sub_exec, Ag, Bg))
    res = parts[0] if len(parts) == 1 else torch.cat(parts)
    if not out:
        return res[0]
    if o2:
        return res
    return res.reshape((nk, nk, nk) + res.shape[1:])


def gathered_bytes(spec, A, B, ka: KAlgebra):
    """Bytes of the larger operand :func:`kein` gathers for ``spec`` over
    the whole outer grid (before chunking)."""
    nk = ka.nk
    a2, b2 = A.ndim == 3, B.ndim == 3
    p = _plan(spec, (a2, b2, len(spec.split("->")[1]) == 2), ka)
    blk_a = A[0].numel() // (1 if a2 else nk * nk) * A.element_size()
    blk_b = B[0].numel() // (1 if b2 else nk * nk) * B.element_size()
    return p.nout * p.ninner * max(blk_a, blk_b)


# ------------------------------------------------------------ CCSD program
def _perm_last2(T, ka: KAlgebra):
    """Blocked transpose swapping the last two indices (3 <-> 4):
    out[k1,k2,k3,...,p3,p4] = T[k1,k2,k4][..., p4, p3] with
    k4 = k1+k2-k3 (self-inverse)."""
    nk = ka.nk
    idx = _block_index(
        ka, "perm_last2",
        lambda ka: (lambda g: (g[0] * nk + g[1]) * nk + g[3])(ka.grid()),
        T.device)
    Tf = T.reshape((nk**3,) + T.shape[3:])
    out = Tf[idx].transpose(-1, -2)
    return out.reshape(T.shape[:3] + out.shape[1:])


def _perm_first2(T, ka: KAlgebra):
    """Blocked transpose swapping the first two indices (1 <-> 2)."""
    return T.transpose(0, 1).transpose(3, 4)


def _transpose_t2_to_vvoo(B_vvoo, ka: KAlgebra):
    """<ab||ij> from the vvoo class: the blocked transpose (0,1,2,3) ->
    (2,3,0,1), out[ki,kj,ka][i,j,a,b] = B[ka,kb,ki][a,b,i,j] with
    kb = ki + kj - ka."""
    nk = ka.nk
    # source block (ka, kb, ki) of the output block (ki, kj, ka)
    idx = _block_index(
        ka, "t2_to_vvoo",
        lambda ka: (lambda g: (g[2] * nk + g[3]) * nk + g[0])(ka.grid()),
        B_vvoo.device)
    Bf = B_vvoo.reshape((nk**3,) + B_vvoo.shape[3:])
    out = Bf[idx].permute(0, 3, 4, 1, 2)
    return out.reshape((nk, nk, nk) + out.shape[1:])


def make_blocked_update(ka: KAlgebra, no: int, nv: int):
    """The blocked CCSD amplitude update.

    Mirrors gccsd._update_blocks contraction for contraction; the P(ij)
    and P(ab) antisymmetrizers become block permutations (swap the two
    occupied or virtual momenta along with the orbital axes).
    """
    def pij(x):      # swap i<->j: block axes (0,1) and orbital (3,4)
        return x - x.transpose(0, 1).transpose(3, 4)

    def pab(x):      # swap a<->b: a is block axis 2, b implied
        return x - _perm_last2(x, ka)

    def update(t1, t2, fov, foo_off, fvv_off, B, D1, D2):
        def ein2(s, a, b):
            return kein(s, a, b, ka)

        t11 = ein2("ia,jb->ijab", t1, t1)
        tau_t = t2 + 0.5 * (t11 - _perm_last2(t11, ka))
        tau = t2 + t11 - _perm_last2(t11, ka)

        Fae = (fvv_off - 0.5 * ein2("me,ma->ae", fov, t1)
               + ein2("mf,mafe->ae", t1, B["ovvv"])
               - 0.5 * ein2("mnaf,mnef->ae", tau_t, B["oovv"]))
        Fmi = (foo_off + 0.5 * ein2("ie,me->mi", t1, fov)
               + ein2("ne,mnie->mi", t1, B["ooov"])
               + 0.5 * ein2("inef,mnef->mi", tau_t, B["oovv"]))
        Fme = fov + ein2("nf,mnef->me", t1, B["oovv"])

        w1 = ein2("je,mnie->mnij", t1, B["ooov"])
        Wmnij = (B["oooo"] + w1 - _perm_last2(w1, ka)
                 + 0.25 * ein2("ijef,mnef->mnij", tau, B["oovv"]))
        w2 = ein2("mb,amef->abef", t1, B["vovv"])
        Wabef = (B["vvvv"] - w2 + _perm_first2(w2, ka)
                 + 0.25 * ein2("mnab,mnef->abef", tau, B["oovv"]))
        t1t1 = ein2("jf,nb->jnfb", t1, t1)
        Wmbej = (B["ovvo"]
                 + ein2("jf,mbef->mbej", t1, B["ovvv"])
                 - ein2("nb,mnej->mbej", t1, B["oovo"])
                 - ein2("jnfb,mnef->mbej", 0.5 * t2 + t1t1, B["oovv"]))

        t1new = (fov.conj()  # f[v,o].T == conj(fov) for a Hermitian f
                 + ein2("ie,ae->ia", t1, Fae)
                 - ein2("ma,mi->ia", t1, Fmi)
                 + ein2("imae,me->ia", t2, Fme)
                 - ein2("nf,naif->ia", t1, B["ovov"])
                 - 0.5 * ein2("imef,maef->ia", t2, B["ovvv"])
                 - 0.5 * ein2("mnae,nmei->ia", t2, B["oovo"])) / D1

        x_ab = ein2("ijae,be->ijab", t2,
                    Fae - 0.5 * ein2("mb,me->be", t1, Fme))
        x_ij = ein2("imab,mj->ijab", t2,
                    Fmi + 0.5 * ein2("je,me->mj", t1, Fme))
        ring_t1 = ein2("ma,mbej->abej", t1, B["ovvo"])
        x_ring = (ein2("imae,mbej->ijab", t2, Wmbej)
                  - ein2("ie,abej->ijab", t1, ring_t1))
        t2new = (_transpose_t2_to_vvoo(B["vvoo"], ka)
                 + pab(x_ab) - pij(x_ij)
                 + 0.5 * ein2("mnab,mnij->ijab", tau, Wmnij)
                 + 0.5 * ein2("ijef,abef->ijab", tau, Wabef)
                 + pij(pab(x_ring))
                 + pij(ein2("ie,abej->ijab", t1, B["vvvo"]))
                 - pab(ein2("ma,mbij->ijab", t1, B["ovoo"]))) / D2
        return t1new, t2new

    return update


def blocked_energy(t1, t2, fov, B_oovv, ka: KAlgebra, nk: int):
    t11 = kein("ia,jb->ijab", t1, t1, ka)
    oovv = B_oovv.reshape((-1,) + B_oovv.shape[3:])
    e = (torch.einsum("kia,kia->", fov, t1)
         + 0.25 * torch.einsum("xijab,xijab->", oovv,
                               t2.reshape((-1,) + t2.shape[3:]))
         + 0.5 * torch.einsum("xijab,xijab->", oovv,
                              t11.reshape((-1,) + t11.shape[3:])))
    return float(e.real)


# -------------------------------------------------------- integral builder
_BLOCKS = ("oooo", "ooov", "oovv", "ovov", "ovvo", "ovoo", "oovo",
           "ovvv", "vovv", "vvvo", "vvoo", "vvvv")

# output blocks of one symmetrization gather
_SYM_CHUNK = 64


def symmetrized_phys_tensor(eri7, ka, nk, nmo):
    """Blocked physicist tensor from the 7d chemist ERIs with
    <pq|rs> = <qp|sr> enforced exactly, on the device of ``eri7``.

    The grid transform breaks the bra/ket-swap symmetry at the aliasing
    level (~1e-5); projecting onto the exact symmetry keeps this kernel,
    the spin-adapted krccsd and the composite oracle at one common fixed
    point. The blocks are two gathers of ``eri7`` (the direct block
    (k1,k3,k2) and the partner (k2,k4,k1)), ``_SYM_CHUNK`` output blocks
    at a time."""
    g1, g2, g3, g4 = ka.grid()
    dev = eri7.device
    src = torch.as_tensor((g1 * nk + g3) * nk + g2, device=dev)
    par = torch.as_tensor((g2 * nk + g4) * nk + g1, device=dev)
    ef = eri7.reshape((nk**3,) + eri7.shape[3:])
    Vs = torch.empty((nk**3, nmo, nmo, nmo, nmo), dtype=eri7.dtype,
                     device=dev)
    for x0 in range(0, nk**3, _SYM_CHUNK):
        x1 = min(x0 + _SYM_CHUNK, nk**3)
        # Vf[k1,k2,k3] = eri7[k1,k3,k2].transpose(0,2,1,3) / nk
        vf = (ef[src[x0:x1]] / nk).permute(0, 1, 3, 2, 4)
        # Vf[k2,k1,k4].transpose(1,0,3,2)
        vp = (ef[par[x0:x1]] / nk).permute(0, 1, 3, 2, 4).permute(0, 2, 1, 4, 3)
        Vs[x0:x1] = 0.5 * (vf + vp)
    return Vs.reshape((nk, nk, nk) + Vs.shape[1:])


def _pad_basis(mo_c, mo_e, mo_occ, dev):
    """Per-k occupied-first MO columns padded to the largest occupied and
    virtual widths (zero columns at -+_PAD_E). Returns (mo_cs, e (nk, nmo)
    float64, nocc)."""
    nk = len(mo_c)
    noccs = (mo_occ > 0.5).sum(axis=1)
    nocc = int(noccs.max())
    nmo = mo_c[0].shape[1]
    nmo_pad = nocc + nmo - int(noccs.min())
    mo_cs = []
    e = np.empty((nk, nmo_pad))
    for k in range(nk):
        occ_i = np.where(mo_occ[k] > 0.5)[0]
        vir_i = np.where(mo_occ[k] <= 0.5)[0]
        C = torch.zeros((mo_c[k].shape[0], nmo_pad), dtype=mo_c[k].dtype,
                        device=dev)
        C[:, :len(occ_i)] = mo_c[k][:, torch.as_tensor(occ_i, device=dev)]
        C[:, nocc:nocc + len(vir_i)] = mo_c[k][:, torch.as_tensor(vir_i, device=dev)]
        e[k, :len(occ_i)] = mo_e[k][occ_i]
        e[k, len(occ_i):nocc] = -_PAD_E
        e[k, nocc:nocc + len(vir_i)] = mo_e[k][vir_i]
        e[k, nocc + len(vir_i):] = _PAD_E
        mo_cs.append(C)
    return mo_cs, e, nocc


def _scf_arrays(scf_res, dev):
    """(mo_c list of device tensors, mo_e (nk, nmo) and mo_occ numpy)."""
    from pyscf_isdf_tpu_torch.device import to_host

    mo_c = [torch.as_tensor(c, device=dev) for c in scf_res["mo_coeff"]]
    mo_e = np.asarray([to_host(e) for e in scf_res["mo_energy"]])
    mo_occ = np.asarray([to_host(o) for o in scf_res["mo_occ"]])
    return mo_c, mo_e, mo_occ


def build_blocked_eris(system, scf_res, device=None):
    """Momentum-blocked spin-orbital <pq||rs> classes and Fock pieces, on
    ``device`` (default: the GPU), where ``system`` must live.

    Chemist Bloch ERIs from df/fft_ao2mo.ao2mo_7d (with the 1/nk supercell
    normalization of cc/kccsd.py), spin-expanded and antisymmetrized per
    block, never as a composite tensor. Non-uniform per-k occupation
    (doped or metallic integer fills, shifted meshes) pads every k to the
    largest occupied and virtual widths with zero MO columns at sentinel
    energies (the reference's _padding_k_idx, pyscf/pbc/mp/kmp2.py:228):
    every residual term with a padded index vanishes and the +-1e9
    denominators pin those amplitudes at zero.
    Returns (ka, blocks, eo, ev, no, nv) with eo/ev (nk, no/nv) numpy.
    """
    from pyscf_isdf_tpu_torch.df import fft_ao2mo

    dev = require_device(system.aoR_k, device)
    mo_c, mo_e, mo_occ = _scf_arrays(scf_res, dev)
    kpts = system.kpts
    nk = len(kpts)
    ka = KAlgebra(system.cell.a, kpts)
    mo_cs, mo_es, nocc_sp = _pad_basis(mo_c, mo_e, mo_occ, dev)
    nmo = mo_cs[0].shape[1]

    eri7 = fft_ao2mo.ao2mo_7d(system, mo_cs, chunk=AO2MO_CHUNK, device=dev)
    Vs = symmetrized_phys_tensor(eri7, ka, nk, nmo)
    del eri7

    # spin expansion (interleaved, gccsd.spinorb_from_spatial)
    nso = 2 * nmo
    sp = np.arange(nso) // 2
    sz = np.arange(nso) % 2
    no, nv = 2 * nocc_sp, nso - 2 * nocc_sp
    blocks = _expand_spin_blocks(Vs, ka, nk, sp, sz, no, nv)

    e_so = np.repeat(mo_es, 2, axis=1)                  # (nk, nso)
    return ka, blocks, e_so[:, :no], e_so[:, no:], no, nv


def _expand_spin_blocks(Vs, ka, nk, sp, sz, no, nv):
    """Per-block spin expansion, antisymmetrization and o/v slicing.

    ``Vs[k1,k2,k3]`` is the symmetrized physicist <pq|rs> over a column
    set indexed by ``sp`` (the spatial column of each spin orbital) with
    spin labels ``sz``. RHF feeds a spatial tensor with sp = arange(nso)//2;
    UHF feeds a spin-orbital tensor with sp = arange(nso). The exchange
    partner <pq|sr> is block (k1,k2,k4) with its last two orbital axes
    swapped. Each class is one gather of its direct and exchange entries.
    """
    g1, g2, g3, g4 = ka.grid()
    if not np.array_equal(ka.kcons[g1, g3, g2], g4):
        raise RuntimeError("momentum bookkeeping mismatch")
    dev = Vs.device
    Vf = Vs.reshape((nk**3,) + Vs.shape[3:])
    xsrc = torch.as_tensor((g1 * nk + g2) * nk + g4, device=dev)
    sl = {"o": np.arange(no), "v": np.arange(no, no + nv)}
    blocks = {}
    for name in _BLOCKS:
        P, Q, R, S = (sl[c] for c in name)
        sp_ = [torch.as_tensor(sp[x], device=dev) for x in (P, Q, R, S)]
        i0 = sp_[0][:, None, None, None]
        i1 = sp_[1][None, :, None, None]
        i2 = sp_[2][None, None, :, None]
        i3 = sp_[3][None, None, None, :]
        # direct <pq|rs> needs (s1==s3)(s2==s4); exchange <pq|sr>
        # needs (s1==s4)(s2==s3)
        m_d = torch.as_tensor(
            (sz[P][:, None, None, None] == sz[R][None, None, :, None])
            & (sz[Q][None, :, None, None] == sz[S][None, None, None, :]),
            device=dev)
        m_x = torch.as_tensor(
            (sz[P][:, None, None, None] == sz[S][None, None, None, :])
            & (sz[Q][None, :, None, None] == sz[R][None, None, :, None]),
            device=dev)
        d = Vf[:, i0, i1, i2, i3] * m_d
        x = Vf[xsrc[:, None, None, None, None], i0[None], i1[None],
               i3[None], i2[None]] * m_x
        blocks[name] = (d - x).reshape((nk, nk, nk) + d.shape[1:])
    return blocks


def build_blocked_eris_uhf(system, scf_res, device=None):
    """Momentum-blocked spin-orbital ERIs for a KUHF/KUKS reference, on
    ``device`` (default: the GPU), where ``system`` must live.

    The UHF generalization of :func:`build_blocked_eris`: spin orbitals
    carry per-spin spatial parts, so the MO transform runs over the
    concatenated [occ-a, occ-b, vir-a, vir-b] column set per k (via
    gccsd.uhf_spinorb_basis) and the spin masks act on those columns
    (sp = identity), each of the four segments padded per spin and per k
    to its largest width. Reference contract: pyscf/pbc/cc/kccsd_uhf.py.
    """
    from pyscf_isdf_tpu_torch.cc.gccsd import uhf_spinorb_basis
    from pyscf_isdf_tpu_torch.device import to_host
    from pyscf_isdf_tpu_torch.df import fft_ao2mo

    dev = require_device(system.aoR_k, device)
    ca_k, cb_k = ([torch.as_tensor(c, device=dev) for c in cs]
                  for cs in scf_res["mo_coeff"])
    ea_k, eb_k = scf_res["mo_energy"]
    occ_a, occ_b = (np.asarray([to_host(o) for o in occ])
                    for occ in scf_res["mo_occ"])
    kpts = system.kpts
    nk = len(kpts)
    ka = KAlgebra(system.cell.a, kpts)

    na_k = (occ_a > 0.5).sum(axis=1)
    nb_k = (occ_b > 0.5).sum(axis=1)
    nma, nmb = ca_k[0].shape[1], cb_k[0].shape[1]
    na_m, nb_m = int(na_k.max()), int(nb_k.max())
    nva_m, nvb_m = nma - int(na_k.min()), nmb - int(nb_k.min())

    def _padded_basis(k):
        na, nb = int(na_k[k]), int(nb_k[k])
        C_cat, e_so, sz_k, _ = uhf_spinorb_basis(
            (ca_k[k], cb_k[k]), (ea_k[k], eb_k[k]), (na, nb))
        e_so = to_host(e_so)
        # C_cat columns: [occ-a (na), occ-b (nb), vir-a, vir-b]
        segs = [(0, na, na_m, 0, -_PAD_E),
                (na, na + nb, nb_m, 1, -_PAD_E),
                (na + nb, na + nb + (nma - na), nva_m, 0, _PAD_E),
                (na + nb + (nma - na), C_cat.shape[1], nvb_m, 1, _PAD_E)]
        C_out, e_out, sz_out = [], [], []
        for lo, hi_, width, spin, pe in segs:
            npadc = width - (hi_ - lo)
            C_out.append(C_cat[:, lo:hi_])
            e_out.append(e_so[lo:hi_])
            sz_out.append(sz_k[lo:hi_])
            if npadc:
                C_out.append(torch.zeros((C_cat.shape[0], npadc),
                                         dtype=C_cat.dtype, device=dev))
                e_out.append(np.full(npadc, pe))
                sz_out.append(np.full(npadc, spin, int))
        return (torch.cat(C_out, dim=1), np.concatenate(e_out),
                np.concatenate(sz_out))

    mo_cs, e_so_k = [], []
    sz = None
    for k in range(nk):
        C_cat, e_so, sz = _padded_basis(k)
        mo_cs.append(C_cat)
        e_so_k.append(e_so)
    nso = mo_cs[0].shape[1]
    no = na_m + nb_m
    nv = nso - no

    eri7 = fft_ao2mo.ao2mo_7d(system, mo_cs, chunk=AO2MO_CHUNK, device=dev)
    Vs = symmetrized_phys_tensor(eri7, ka, nk, nso)
    del eri7
    blocks = _expand_spin_blocks(Vs, ka, nk, np.arange(nso), sz, no, nv)

    e_so_k = np.stack(e_so_k)                    # (nk, nso)
    return ka, blocks, e_so_k[:, :no], e_so_k[:, no:], no, nv


def kccsd_blocked(system, scf_res, conv_tol=1e-9, max_cycle=100,
                  diis_space=8, verbose=False, device=None):
    """k-point CCSD correlation energy per unit cell, blocked storage, on
    ``device`` (default: the GPU), where ``system`` must live.

    Same physics and normalization as cc/kccsd.kccsd (e_corr per unit
    cell, convergence measured on the supercell energy), O(nk^3) memory.
    """
    nk = len(system.kpts)
    ka, B, eo, ev, no, nv = build_blocked_eris(system, scf_res, device)
    return _drive_blocked(ka, B, eo, ev, no, nv, scf_res["e_tot"], nk,
                          conv_tol, max_cycle, diis_space, verbose)


def kuccsd_blocked(system, scf_res, conv_tol=1e-9, max_cycle=100,
                   diis_space=8, verbose=False, device=None):
    """k-point spin-unrestricted CCSD (KUCCSD), blocked spin-orbital, on
    ``device`` (default: the GPU), where ``system`` must live.

    The UHF spin orbitals of kuhf_kernel feed the same momentum-blocked
    spin-orbital program as the restricted driver; only the ERI builder
    differs (:func:`build_blocked_eris_uhf`). Reference:
    pyscf/pbc/cc/kccsd_uhf.py. For a closed-shell reference it reduces to
    :func:`kccsd_blocked`.
    """
    nk = len(system.kpts)
    ka, B, eo, ev, no, nv = build_blocked_eris_uhf(system, scf_res, device)
    return _drive_blocked(ka, B, eo, ev, no, nv, scf_res["e_tot"], nk,
                          conv_tol, max_cycle, diis_space, verbose)


def blocked_denominators(ka, eo, ev, dev):
    """D1 (nk, no, nv) and the blocked D2 (nk,nk,nk, no,no,nv,nv) of the
    per-k energies eo/ev (numpy), on ``dev``."""
    nk = ka.nk
    g1, g2, g3, k4 = (x.reshape(nk, nk, nk) for x in ka.grid())
    D1 = torch.as_tensor(eo[:, :, None] - ev[:, None, :], device=dev)
    D2 = (eo[g1][:, :, :, :, None, None, None]
          + eo[g2][:, :, :, None, :, None, None]
          - ev[g3][:, :, :, None, None, :, None]
          - ev[k4][:, :, :, None, None, None, :])
    return D1, torch.as_tensor(D2, device=dev)


def _drive_blocked(ka, B, eo, ev, no, nv, e_hf, nk,
                   conv_tol, max_cycle, diis_space, verbose):
    dev = B["oovv"].device
    D1, D2 = blocked_denominators(ka, eo, ev, dev)

    dt = B["oovv"].dtype
    fov = torch.zeros((nk, no, nv), dtype=dt, device=dev)     # canonical HF
    foo_off = torch.zeros((nk, no, no), dtype=dt, device=dev)
    fvv_off = torch.zeros((nk, nv, nv), dtype=dt, device=dev)

    # MP2 start
    t2 = _transpose_t2_to_vvoo(B["vvoo"], ka) / D2
    t1 = torch.zeros((nk, no, nv), dtype=t2.dtype, device=dev)

    update = make_blocked_update(ka, no, nv)
    diis = DIIS(space=diis_space)
    e_last = blocked_energy(t1, t2, fov, B["oovv"], ka, nk)
    conv = False
    it = 0
    n1 = t1.numel()
    for it in range(1, max_cycle + 1):
        t1n, t2n = update(t1, t2, fov, foo_off, fvv_off, B, D1, D2)
        vec = torch.cat([t1n.reshape(-1), t2n.reshape(-1)])
        err = vec - torch.cat([t1.reshape(-1), t2.reshape(-1)])
        vec = diis.update(vec, err)
        t1 = vec[:n1].reshape(t1.shape)
        t2 = vec[n1:].reshape(t2.shape)
        e_cc = blocked_energy(t1, t2, fov, B["oovv"], ka, nk)
        de = abs(e_cc - e_last)
        rnorm = float(torch.linalg.norm(err))
        if verbose:
            print(f"kCCSD(blocked) cycle {it:3d}  E_sc = {e_cc:.12f}  "
                  f"dE = {de:.2e}  |r| = {rnorm:.2e}")
        e_last = e_cc
        if de < conv_tol * nk and rnorm < np.sqrt(conv_tol * nk):
            conv = True
            break
    return {"e_corr": e_last / nk, "t1": t1, "t2": t2, "converged": conv,
            "niter": it, "e_hf": e_hf, "e_tot": e_hf + e_last / nk}

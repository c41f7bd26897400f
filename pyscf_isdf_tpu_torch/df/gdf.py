"""Gaussian density fitting (GDF) assembled on the FFT grid (torch).

The reference's GDF (pyscf/pbc/df/df.py:127, builders gdf_builder.py:48 /
rsdf_builder.py:59) assembles 3-center integrals with libcint kernels.
The JAX package (``pyscf_isdf_tpu/df/gdf.py``) assembles the
Coulomb-metric fit on the SCF grid instead,

    j2c[P,Q]  = 1/vol sum_G  chi_P*(G) v(G) chi_Q(G)
    j3c[P,ij] = 1/vol sum_G  chi_P*(G) v(G) rho_ij(G),

with the auxiliary functions chi_P and the pair densities rho_ij both
collocated on the grid and Fourier transformed, so the fitted ERI is the
Coulomb-metric projection of the FFTDF ERI onto the auxiliary span. v is
the SCF Coulomb kernel (coulG, G=0 -> 0).

Here the same sums run in real space (Parseval): with the auxiliary
potentials V_P = Re ifft(v fft(chi_P)) on the grid,

    j2c[P,Q]  = w sum_r chi_P(r) V_Q(r),
    j3c[P,ij] = w sum_r V_P(r) ao_i(r) ao_j(r)        (w = vol / ngrids),

so the build takes naux FFTs instead of one per AO pair, and j3c is one
real GEMM of the potentials against the pair densities, formed
pair-chunk by pair-chunk (at diamond 3x3x3 the (nao^2, ngrids) complex
pair transforms of the reference's form would take 82.6 GB). The
auxiliary basis is collocated by kernel K1 on the uniform grid's bricks
(l up to 4). ``j2c`` is diagonalised on the device.

The auxiliary basis is an even-tempered product expansion (reference
pyscf/df/addons.py aug_etb semantics, as the JAX package re-derives it).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.utils.timing import null_timer


def aug_etb_spec(cell, beta: float = 2.0, l_extra: int = 2):
    """Even-tempered auxiliary basis spec per element.

    For each element, the product densities phi_i phi_j have exponents
    a_i + a_j and angular momenta |l_i - l_j| .. l_i + l_j; per aux l the
    exponent range is spanned by a geometric progression of ratio beta,
    and ``l_extra`` higher-l shells over the diffuse..mid range cover the
    two-centre products' off-centre multipoles. Returns
    {symbol: [[l, (exp, 1.0)], ...]}.
    """
    spec = {}
    by_symbol: dict[str, list] = {}
    for sh in cell.shells:
        by_symbol.setdefault(cell.symbols[sh.atom], []).append(sh)
    for sym, shells in by_symbol.items():
        emin: dict[int, float] = {}
        emax: dict[int, float] = {}
        for shi in shells:
            for shj in shells:
                for l in range(abs(shi.l - shj.l), shi.l + shj.l + 1):
                    lo = float(shi.exps.min() + shj.exps.min())
                    hi = float(shi.exps.max() + shj.exps.max())
                    emin[l] = min(emin.get(l, lo), lo)
                    emax[l] = max(emax.get(l, hi), hi)
        funcs = []
        for l in sorted(emin):
            n = max(1, int(np.ceil(np.log(emax[l] / emin[l]) / np.log(beta))) + 1)
            for e in emin[l] * beta ** np.arange(n):
                funcs.append([l, (float(e), 1.0)])
        lmax = max(emin)
        lo = min(emin.values())
        hi = np.sqrt(lo * max(emax.values()))     # diffuse..mid range
        n = max(1, int(np.ceil(np.log(hi / lo) / np.log(beta))) + 1)
        for l in range(lmax + 1, lmax + 1 + l_extra):
            for e in lo * beta ** np.arange(n):
                funcs.append([l, (float(e), 1.0)])
        spec[sym] = funcs
    return spec


def make_auxcell(cell, beta: float = 2.0, l_extra: int = 2):
    """The all-electron cell of the auxiliary basis on the cell's atoms."""
    from pyscf_isdf_tpu_torch.cell import build_cell

    atoms = [[s, tuple(c)] for s, c in zip(cell.symbols, cell.coords)]
    return build_cell(cell.a, atoms, aug_etb_spec(cell, beta=beta, l_extra=l_extra),
                      pseudo=None, mesh=tuple(cell.mesh), unit="Bohr")


@dataclass(frozen=True, eq=False)
class GDF:
    cderi: torch.Tensor    # (naux_kept, nao, nao) whitened 3c tensor
    naux: int


def collocate_aux(cell, auxcell, device, timer=None):
    """The auxiliary basis on the uniform grid through kernel K1 (bricks,
    the tight image radius
    :data:`~pyscf_isdf_tpu_torch.ops.cuda_ao.TIGHT_RCUT_PRECISION`):
    (ngrids, naux) float64."""
    from pyscf_isdf_tpu_torch.ops.cuda_ao import TIGHT_RCUT_PRECISION, make_ao_evaluator

    timer = timer or null_timer
    with timer("aux_plan"):
        evaluate = make_ao_evaluator(auxcell, dtype=torch.float64, device=device,
                                     rcut_precision=TIGHT_RCUT_PRECISION)
    with timer("aux_ao"):
        return evaluate()


def aux_potentials(aux, coulG, mesh, chunk: int = 256):
    """(naux, ngrids) Coulomb potentials Re ifft(v fft(chi_P)) of the
    auxiliary functions (columns of ``aux``) on the grid, ``chunk``
    functions a batch."""
    out = torch.empty((aux.shape[1], aux.shape[0]), dtype=aux.dtype,
                      device=aux.device)
    for p0 in range(0, aux.shape[1], chunk):
        f = aux[:, p0:p0 + chunk].T.to(torch.complex128)
        out[p0:p0 + chunk] = ifft3(coulG * fft3(f, mesh), mesh).real
    return out


def _pair_gemm(V, ao1, ao2, weight, chunk_elems: int = 1 << 28):
    """w * V @ pairs with pairs[r, (i, j)] = ao1_i(r) ao2_j(r), formed
    ``chunk`` rows i at a time: (nP, nao1 * nao2)."""
    ng, n1 = ao1.shape
    n2 = ao2.shape[1]
    dtype = torch.promote_types(V.dtype, ao1.dtype)
    out = torch.empty((V.shape[0], n1 * n2), dtype=dtype, device=V.device)
    step = max(1, chunk_elems // (ng * n2))
    for i0 in range(0, n1, step):
        i1 = min(n1, i0 + step)
        pairs = (ao1[:, i0:i1, None] * ao2[:, None, :]).reshape(ng, -1)
        out[:, i0 * n2:i1 * n2] = weight * (V @ pairs.to(dtype))
    return out


def build_gdf(cell, aoR, coulG, mesh, weight, beta: float = 2.0,
              l_extra: int = 2, lindep: float = 1e-10, aoR_aux=None,
              timer=None) -> GDF:
    """Assemble the whitened fit tensor cderi = j2c^{-1/2} j3c on the device
    of ``aoR`` (float64). ``timer`` records the stages 'aux_plan', 'aux_ao'
    (the collocation), 'aux_fft', 'j2c', 'j3c', 'eigh' and 'whiten'."""
    timer = timer or null_timer
    device = aoR.device
    nao = aoR.shape[1]
    if aoR_aux is None:
        auxcell = make_auxcell(cell, beta=beta, l_extra=l_extra)
        aoR_aux = collocate_aux(cell, auxcell, device, timer)
    aux = torch.as_tensor(aoR_aux, dtype=torch.float64, device=device)
    coulG = torch.as_tensor(coulG, dtype=torch.float64, device=device)
    aoR = aoR.to(torch.float64)
    with timer("aux_fft"):
        V = aux_potentials(aux, coulG, tuple(mesh))               # (naux, ng)
    with timer("j2c"):
        j2c = weight * (V @ aux)
        j2c = 0.5 * (j2c + j2c.T)
    del aux
    with timer("j3c"):
        j3c = _pair_gemm(V, aoR, aoR, weight)                     # (naux, nao^2)
    del V
    with timer("eigh"):
        w, U = torch.linalg.eigh(j2c)
        keep = w > w.max() * lindep
    with timer("whiten"):
        cd = (U[:, keep] / torch.sqrt(w[keep])).T @ j3c
    return GDF(cderi=cd.reshape(-1, nao, nao), naux=int(keep.sum()))


def get_jk_cd(cd, dm):
    """J and K of a density from a whitened fit tensor (naux, nao, nao):
    J = sum_P cd_P tr(cd_P D), K = sum_P cd_P D cd_P."""
    naux, nao, _ = cd.shape
    dm = dm.to(cd.dtype)
    rho = torch.einsum("pij,ji->p", cd, dm)
    vj = torch.einsum("p,pij->ij", rho, cd)
    t = cd @ dm                                                   # (p, i, l)
    vk = t.transpose(0, 1).reshape(nao, naux * nao) @ cd.reshape(naux * nao, nao)
    return vj, vk


def get_jk(gdf: GDF, dm):
    return get_jk_cd(gdf.cderi, dm)


def get_eri(gdf: GDF):
    """(nao^2, nao^2) fitted ERIs (ij|kl) = sum_P cd_P,ij cd_P,kl."""
    flat = gdf.cderi.reshape(gdf.cderi.shape[0], -1)
    return flat.T @ flat


# ------------------------------------------------------------------ k-point
@dataclass(frozen=True, eq=False)
class KGDF:
    """Per-(k1,k2) whitened fit tensors cd[k1][k2] = (naux_q, nao, nao)
    for the momentum-q = k2-k1 pair space."""

    cd: tuple          # cd[k1][k2]: (naux_q, nao, nao) complex
    nk: int


def canonical_q(cell, q):
    """q folded into the first zone (fractional parts in [-1/2, 1/2)) and
    its rounded fractional key: pairs (k1, k2) and (k2, k1) carry +X and
    -X = X - G, one momentum-transfer class with one whitened frame."""
    b_mat = 2.0 * np.pi * np.linalg.inv(cell.a.T)
    scaled = (q @ cell.a.T) / (2.0 * np.pi)
    frac = scaled - np.floor(scaled + 0.5 - 1e-9)
    return frac @ b_mat, tuple(np.round(frac, 10))


def build_gdf_kpts(cell, aoR_k, kpts, mesh, weight, beta: float = 2.0,
                   l_extra: int = 2, lindep: float = 1e-10, omega=None,
                   timer=None) -> KGDF:
    """k-point GDF build on the device of ``aoR_k``: for every (k1, k2)
    the pair densities conj(ao_k1) ao_k2 e^{-iqr} (q = k2-k1, folded) are
    fit in the Coulomb metric of v_q = coulG(q) (wrap-around included)
    against the q-boosted auxiliary functions chi_P e^{iqr}. Per q class
    the auxiliary potentials Vq_P = ifft(v_q fft(chi_P)) give
    j2c = w chi^T Vq and j3c = w conj(Vq e^{iqr}) pairs."""
    from pyscf_isdf_tpu_torch.ops import coulomb

    timer = timer or null_timer
    kpts = np.reshape(kpts, (-1, 3))
    nk = len(kpts)
    nao = aoR_k.shape[2]
    mesh = tuple(mesh)
    device = aoR_k.device
    auxcell = make_auxcell(cell, beta=beta, l_extra=l_extra)
    aux = collocate_aux(cell, auxcell, device, timer).to(torch.complex128)
    coords = torch.as_tensor(cell.uniform_grid(), dtype=torch.float64,
                             device=device)
    cache = {}

    def q_data(q):
        q_c, key = canonical_q(cell, q)
        if key not in cache:
            phase = torch.exp(-1j * (coords @ torch.as_tensor(
                q_c, dtype=torch.float64, device=device)))
            vq = torch.as_tensor(coulomb.get_coulG(cell, k=q_c, exxdiv=None,
                                                   kpts=kpts, omega=omega),
                                 dtype=torch.float64, device=device)
            Vq = torch.cat([ifft3(vq * fft3(aux[:, p0:p0 + 256].T, mesh), mesh)
                            for p0 in range(0, aux.shape[1], 256)])  # (naux, ng)
            j2c = weight * (aux.T @ Vq.T)
            j2c = 0.5 * (j2c + j2c.conj().T)
            w, U = torch.linalg.eigh(j2c)
            keep = w > w.max() * lindep
            wh = (U[:, keep] / torch.sqrt(w[keep])).conj().T       # (nkeep, naux)
            cache[key] = (wh, (Vq * phase.conj()).conj())
        return cache[key]

    cd = []
    with timer("j3c"):
        for k1 in range(nk):
            row = []
            for k2 in range(nk):
                wh, Vc = q_data(kpts[k2] - kpts[k1])
                j3c = _pair_gemm(Vc, aoR_k[k1].conj(), aoR_k[k2], weight)
                row.append((wh @ j3c).reshape(-1, nao, nao))
            cd.append(tuple(row))
    return KGDF(cd=tuple(cd), nk=nk)


def get_jk_kpts(kgdf: KGDF, dm_k):
    """J/K matrices at every k from the k-point fit:
    K^{k1} = (1/nk) sum_{k2,P} cd^{k1k2}_P D^{k2} cd^{k1k2 H}_P;
    J^{k1}_{mn} = sum_P conj(cd^{k1k1}_{P,nm}) rho_P with
    rho_P = (1/nk) sum_k2 sum_mn cd^{k2k2}_{P,mn} D^{k2}_{nm}.
    The conjugated outer factor keeps J invariant under the whitening's
    arbitrary per-column phases (reference ``gdf.get_jk_kpts``)."""
    nk = kgdf.nk
    rho = sum(torch.einsum("pmn,nm->p", kgdf.cd[k][k], dm_k[k].to(torch.complex128))
              for k in range(nk)) / nk
    vj, vk = [], []
    for k1 in range(nk):
        vj.append(torch.einsum("p,pnm->mn", rho, kgdf.cd[k1][k1].conj()))
        acc = 0.0
        for k2 in range(nk):
            c = kgdf.cd[k1][k2]
            t = c @ dm_k[k2].to(c.dtype)                          # (p, m, l)
            acc = acc + torch.einsum("pml,pkl->mk", t, c.conj()) / nk
        vk.append(acc)
    return torch.stack(vj), torch.stack(vk)

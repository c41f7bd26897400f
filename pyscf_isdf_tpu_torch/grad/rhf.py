"""Nuclear gradients (forces) by autograd through the energy functional.

The reference computes the forces with one ``jax.grad`` of the converged
energy functional: every position-dependent piece of the total energy (AO
collocation, the G-space S/T phases, the GTH local and nonlocal structure
factors, Ewald) is a program of the atom positions, so

    dE/dR = grad_R [ E(D0, R) - Tr(W0 S(R)) ]

at the SCF stationary point; the second term is the Pulay
(basis-response) part with W the energy-weighted density matrix, and D0,
W0 are held fixed (Hellmann-Feynman + Pulay is exact at convergence).

Here the same functional is a torch program and ``torch.autograd`` takes
its gradient. Three terms would keep far more in memory under autograd
than the forward needs, and each is its own ``autograd.Function``:

  * the AO values, :func:`~pyscf_isdf_tpu_torch.ops.ao_eval.eval_ao_positions`
    (the collocation kernel K1 forward on the GPU, the analytic AO
    derivatives backward); every aoR-borne term (local PP, Hartree, XC,
    exchange) adds to one cotangent dE/d aoR, pulled back once;
  * S and T on the converged G mesh (:func:`~pyscf_isdf_tpu_torch.ops.ft_ao.converged_st_mesh`),
    sums over G taken in chunks and recomputed chunk by chunk in the
    backward (:func:`chunked_sum`);
  * the exact exchange over occupied pair densities, taken block by block
    of occupied rows with its gradient formed in the same pass
    (:func:`pair_exchange`), so the (ngrids, nocc, nocc) pair densities
    never exist whole.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.device import require_device, to_host
from pyscf_isdf_tpu_torch.df.fftdf import fft3, ifft3
from pyscf_isdf_tpu_torch.ops import coulomb, pp as pp_ops
from pyscf_isdf_tpu_torch.ops.ao_eval import (PackedBasis, ao_gradient_fft,
                                              eval_ao_positions, shell_rcut)
from pyscf_isdf_tpu_torch.ops.ft_ao import converged_st_mesh
from pyscf_isdf_tpu_torch.ops.solid_harmonics import solid_harmonics
from pyscf_isdf_tpu_torch.ops.xc import XCSpec, _max
from pyscf_isdf_tpu_torch.scf.hf import rsh_coeffs
from pyscf_isdf_tpu_torch.utils.timing import null_timer

ST_CHUNK = 1 << 16      # G vectors per chunk of the S/T sums
EXCHANGE_BLOCK = 8      # occupied rows per block of pair densities


# ------------------------------------------------------------ chunked sums
class _ChunkedSum(torch.autograd.Function):
    """sum_c fn(c, *inputs) over chunks c < n, a tuple of tensors; the
    forward keeps no graph, the backward recomputes one chunk at a time
    under autograd."""

    @staticmethod
    def forward(ctx, fn, n, *inputs):
        ctx.fn, ctx.n = fn, n
        ctx.save_for_backward(*inputs)
        total = None
        for c in range(n):
            out = fn(c, *inputs)
            total = list(out) if total is None else [a + b for a, b in zip(total, out)]
        return tuple(total)

    @staticmethod
    def backward(ctx, *gouts):
        inputs = ctx.saved_tensors
        need = [i for i in range(len(inputs)) if ctx.needs_input_grad[2 + i]]
        grads = [None] * len(inputs)
        for c in range(ctx.n):
            with torch.enable_grad():
                xs = [x.detach().requires_grad_(i in need) for i, x in enumerate(inputs)]
                outs = ctx.fn(c, *xs)
                pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
                gs = torch.autograd.grad([o for o, _ in pairs], [xs[i] for i in need],
                                         [g for _, g in pairs], allow_unused=True)
            for i, g in zip(need, gs):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        return (None, None) + tuple(grads)


def chunked_sum(fn, n: int, *inputs):
    """sum_{c < n} fn(c, *inputs) (a tuple of tensors), differentiable in
    ``inputs`` with only one chunk's graph alive at a time."""
    return _ChunkedSum.apply(fn, n, *inputs)


# --------------------------------------------------------- exact exchange
class _PairExchange(torch.autograd.Function):
    """P = sum_ij sum_g rho_ij(g) v_ij(g), rho_ij = m_i m_j (real orbitals
    m on the grid), v_ij = ifft(kern fft(rho_ij)). Its gradients,
    dP/dm_i = 4 sum_j v_ij m_j and dP/dkern(G) = (1/N) sum_ij
    |fft(rho_ij)(G)|^2, are formed in the same pass over blocks of rows i."""

    @staticmethod
    def forward(ctx, moR, kern, mesh, block):
        mT = moR.T.contiguous()                                  # (no, ng)
        ctype = torch.complex128 if mT.dtype == torch.float64 else torch.complex64
        need_k = ctx.needs_input_grad[1]
        p = torch.zeros((), dtype=mT.dtype, device=mT.device)
        g_m = torch.zeros_like(mT)
        g_k = torch.zeros_like(kern) if need_k else None
        for i0 in range(0, mT.shape[0], block):
            rho = mT[i0:i0 + block, None, :] * mT[None, :, :]    # (b, no, ng)
            rG = fft3(rho.to(ctype), mesh)
            v = ifft3(kern * rG, mesh).real
            p = p + (rho * v).sum()
            g_m[i0:i0 + block] = 4.0 * torch.einsum("bjg,jg->bg", v, mT)
            if need_k:
                g_k = g_k + (rG.real ** 2 + rG.imag ** 2).sum((0, 1)) / mT.shape[1]
        ctx.save_for_backward(g_m, g_k)
        return p

    @staticmethod
    def backward(ctx, gp):
        g_m, g_k = ctx.saved_tensors
        return (gp * g_m.T, None if g_k is None else gp * g_k, None, None)


def pair_exchange(moR, kern, mesh, block: int = EXCHANGE_BLOCK):
    """sum_ij <rho_ij| ifft(kern fft(rho_ij))> over the occupied pair
    densities rho_ij = m_i m_j of real orbitals ``moR`` (ng, nocc): the
    exchange energy without its -weight/4 (closed shell) factor, linear in
    the kernel ``kern`` (ng,). Differentiable in both; the pair densities
    are formed ``block`` rows at a time."""
    return _PairExchange.apply(moR, kern, mesh, block)


# ----------------------------------------------------------- host tables
def _ao_atom_map(cell):
    out = np.empty(cell.nao, dtype=np.int64)
    ao_loc = cell.ao_loc
    for ish, sh in enumerate(cell.shells):
        out[ao_loc[ish]:ao_loc[ish + 1]] = sh.atom
    return out


def _ft_factors(cell, Gv, kpt=None):
    """Position-independent AO FT factors f_i(G): the analytic ft_ao with
    the center phase e^{-i(G+k).A_i} divided out, i.e. each AO's transform
    about the origin, (ng, nao) complex. ``Gv`` (ng, 3) is a tensor and may
    carry a gradient (the strain path traces it); shells of one l are
    evaluated together. Returns (factors, ao_atom)."""
    packed = PackedBasis.from_cell(cell)
    kw = dict(dtype=Gv.dtype, device=Gv.device)
    kG = Gv if kpt is None else Gv + torch.as_tensor(kpt, **kw)
    G2 = (kG * kG).sum(1)
    ng = kG.shape[0]
    cols = []
    for l in packed.ls:
        es = torch.as_tensor(packed.exps[l], **kw)                      # (ns, P)
        cs = torch.as_tensor(packed.coeffs[l], **kw)                    # (ns, P, K)
        rad = torch.einsum("gsp,spk->gsk", (math.pi / es) ** 1.5 * (2 * es) ** (-l)
                           * torch.exp(-G2[:, None, None] / (4 * es)), cs)
        ang = solid_harmonics(l, kG, torch)                             # (ng, M)
        blk = (-1j) ** l * (rad[..., None] * ang[:, None, None, :])
        cols.append(blk.reshape(ng, -1))
    inv = torch.as_tensor(packed.inverse_columns(), device=Gv.device)
    return torch.cat(cols, 1)[:, inv], _ao_atom_map(cell)


class _EwaldData:
    """Static (position-independent) Ewald setup, mirroring
    ops/coulomb.ewald so the traced energy matches the host value."""

    def __init__(self, cell, device):
        if cell.dimension != 3:
            raise NotImplementedError("autograd Ewald: 3D cells only")
        f64 = dict(dtype=torch.float64, device=device)
        self.charges = torch.as_tensor(cell.charges, **f64)
        ew_eta, ew_cut = coulomb.ewald_params(cell)
        self.eta = ew_eta
        self.L = torch.as_tensor(lattice.lattice_images(cell.a, ew_cut, 3), **f64)
        log_prec = np.log(cell.precision / (max(np.abs(cell.charges).sum(), 1.0)
                                            * 16 * np.pi**2))
        mesh = lattice.cutoff_to_mesh(cell.a, -2 * ew_eta**2 * log_prec)
        Gv = lattice.get_Gv(cell.a, mesh)
        absG2 = np.einsum("gi,gi->g", Gv, Gv)
        keep = absG2 > 1e-12
        self.Gv = torch.as_tensor(Gv[keep], **f64)
        self.coulG = torch.as_tensor(4 * np.pi / absG2[keep] / cell.vol, **f64)
        self.expG2 = torch.as_tensor(np.exp(-absG2[keep] / (4 * ew_eta**2)), **f64)
        self.self_e = (-0.5 * float(cell.charges @ cell.charges)
                       * 2 * ew_eta / np.sqrt(np.pi)
                       - 0.5 * float(cell.charges.sum()) ** 2 * np.pi
                       / (ew_eta**2 * cell.vol))

    def energy(self, positions):
        q = self.charges
        d = (positions[None, :, None, :] - positions[None, None, :, :]
             + self.L[:, None, None, :])
        r2 = (d * d).sum(-1)
        tiny = r2 < 1e-16
        r = torch.sqrt(torch.where(tiny, 1.0, r2))
        ovrl = 0.5 * (q[:, None] * q[None, :]
                      * torch.where(tiny, 0.0, torch.special.erfc(self.eta * r) / r)).sum()
        ZSI = (q[None, :] * torch.exp(-1j * (self.Gv @ positions.T))).sum(1)
        ewg = 0.5 * ((ZSI.real ** 2 + ZSI.imag ** 2) * self.expG2 * self.coulG).sum()
        return ovrl + ewg + self.self_e


def _vnl_tables(cell, Gv):
    """Per-atom nonlocal projector tables on the vectors ``Gv`` (a tensor:
    the mesh's G, k+G at a k-point, traced on the strain path): a list of
    (atom_index, h (nl, nl), pYlm (nl, 2l+1, ng)), complex."""
    G2 = (Gv * Gv).sum(1)
    # |G| with an AD-safe cone point: the radial factors are smooth even
    # functions of |G|, so the true gradient at G=0 is zero
    G_rad = torch.where(G2 < 1e-30, 0.0, torch.sqrt(torch.where(G2 < 1e-30, 1.0, G2)))
    tables = []
    for ia in range(cell.natm):
        pp = cell.pseudos.get(cell.symbols[ia])
        if pp is None:
            continue
        for l, (rl, h) in enumerate(zip(pp.proj_rl, pp.proj_h)):
            nl = len(h)
            if nl == 0:
                continue
            ang = solid_harmonics(l, Gv, torch)
            radial = rl ** (l + 1.5) * np.pi**1.25 * torch.exp(-0.5 * (G_rad * rl) ** 2)
            pYlm = torch.stack([(ang * (radial * pp_ops._qli(G_rad * rl, l, i))[:, None]).T
                                for i in range(nl)])
            tables.append((ia, torch.as_tensor(np.asarray(h), dtype=torch.complex128,
                                               device=Gv.device),
                           pYlm.to(torch.complex128)))
    return tables


def _vnl_energy(tables, SI, aokG, dm, vol):
    """Tr(D vppnl) from the per-atom projector tables, the structure
    factors SI (natm, ng) and the scaled AO transforms aokG (ng, nao)."""
    e = 0.0
    dmc = dm.to(aokG.dtype)
    for ia, h, pYlm in tables:
        SPG = torch.einsum("g,img,gp->imp", SI[ia].conj(), pYlm, aokG)
        e = e + torch.einsum("imp,ij,jmq,qp->", SPG.conj(), h, SPG, dmc).real / vol
    return e


def _st_sums(cell, Gv_st, kpt, vol, real: bool):
    """positions -> (S, T) on the G vectors ``Gv_st`` (at k+G for a k-point
    ``kpt``): S = aoG^H aoG / vol, T with |k+G|^2/2, in chunks of
    :data:`ST_CHUNK` G vectors (real parts at Gamma)."""
    n = -(-Gv_st.shape[0] // ST_CHUNK)

    def chunk(c, positions):
        G = Gv_st[c * ST_CHUNK:(c + 1) * ST_CHUNK]
        kG = G if kpt is None else G + kpt
        f, ao_atom = _ft_factors(cell, G, kpt)
        ph = torch.exp(-1j * (kG @ positions.T))
        aoG = f * ph[:, torch.as_tensor(ao_atom, device=G.device)]
        S = (aoG.conj().T @ aoG) / vol
        T = ((aoG.conj() * (0.5 * (kG * kG).sum(1))[:, None]).T @ aoG) / vol
        return (S.real, T.real) if real else (S, T)

    return lambda positions: chunked_sum(chunk, n, positions)


def _tensor(a, device, dtype=torch.float64):
    return torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a), dtype=dtype,
                           device=device)


# ------------------------------------------------------ Gamma functional
class GammaTerms:
    """The position-traced pieces shared by the closed- and open-shell
    Gamma energy functionals of one system: AO values, S/T, the nuclear
    potential (local and nonlocal PP, or the bare nuclei), Hartree,
    exchange and Ewald (reference grad/rhf.py and grad/uhf.py)."""

    def __init__(self, system, xc=None, exxdiv="ewald", timer=None):
        cell = self.cell = system.cell
        self.timer = timer
        self.device = dev = system.aoR.device
        f64 = dict(dtype=torch.float64, device=dev)
        self.mesh = tuple(system.mesh)
        self.weight = system.weight
        self.vol = cell.vol
        self.coulG = system.coulG.to(**f64)
        self.Gv_mesh = torch.as_tensor(cell.get_Gv(cell.mesh), **f64)
        xcspec = XCSpec(xc) if xc is not None else None
        if xcspec is not None and xcspec.family == "hf":
            xcspec = None
        self.xcspec = xcspec
        hyb, alpha, omega = rsh_coeffs(xcspec)
        self.need_k = hyb > 0 or alpha > 0
        mad = system.madelung if exxdiv == "ewald" else 0.0
        self.exxdiv = exxdiv
        # RSH (LR formulation): hyb K_full + (alpha - hyb) K_LR(omega), each
        # part with its own probe-charge madelung; the pair energy is linear
        # in the kernel, so one combined kernel serves both
        self.kern = hyb * self.coulG
        self.mad_add = hyb * mad
        if omega != 0.0:
            coulG_lr = torch.as_tensor(coulomb.get_coulG(cell, exxdiv=None, omega=omega), **f64)
            self.kern = self.kern + (alpha - hyb) * coulG_lr
            mad_lr = coulomb.madelung_omega(cell, None, omega) if exxdiv == "ewald" else 0.0
            self.mad_add = hyb * mad + (alpha - hyb) * mad_lr

        self.packed = PackedBasis.from_cell(cell)
        rcut = max(shell_rcut(sh) for sh in cell.shells)
        self.images = torch.as_tensor(lattice.lattice_images(cell.a, rcut, cell.dimension), **f64)
        self.coords = torch.as_tensor(cell.uniform_grid(), **f64)
        Gv_st = torch.as_tensor(lattice.get_Gv(cell.a, converged_st_mesh(cell)), **f64)
        self.st = _st_sums(cell, Gv_st, None, self.vol, real=True)
        self.ao_atom = torch.as_tensor(_ao_atom_map(cell), device=dev)

        self.has_pp = bool(cell.pseudos)
        if self.has_pp:
            self.vlocG = torch.as_tensor(pp_ops.gth_vlocG(cell, cell.get_Gv(cell.mesh)), **f64)
            self.alpha0 = torch.as_tensor([float(np.sum(pp_ops.gth_alphas(cell)))],
                                          dtype=torch.complex128, device=dev)
            self.vnl_tables = _vnl_tables(cell, self.Gv_mesh)
            self.fG_mesh = _ft_factors(cell, self.Gv_mesh)[0]
        else:
            self.charges = torch.as_tensor(cell.charges, **f64)
        self.ewald = _EwaldData(cell, dev)

    def aoR(self, positions):
        return eval_ao_positions(self.packed, self.coords, self.images, positions,
                                 cell=self.cell, timer=self.timer)

    def nuclear(self, positions, rho_t, dm_t):
        """Tr(D V_nuc): the local PP (or bare nuclei) on the density and the
        nonlocal PP through the AO transforms."""
        ph_mesh = torch.exp(-1j * (self.Gv_mesh @ positions.T))     # (ng, natm)
        SI = ph_mesh.T
        if self.has_pp:
            vpplocG = -(SI * self.vlocG).sum(0)
            vpplocG = torch.cat([self.alpha0, vpplocG[1:]])
            vR = ifft3(vpplocG, self.mesh).real
            e = (rho_t * vR).sum()
            aokG = self.fG_mesh * ph_mesh[:, self.ao_atom] / math.sqrt(self.vol)
            return e + _vnl_energy(self.vnl_tables, SI, aokG, dm_t, self.vol)
        rhoG = -(self.charges.to(SI.dtype) @ SI)
        vneR = ifft3(rhoG * self.coulG, self.mesh).real
        return (rho_t * vneR).sum()

    def hartree(self, rho_t):
        vR = ifft3(self.coulG * fft3(rho_t.to(torch.complex128), self.mesh), self.mesh).real
        return 0.5 * self.weight * (rho_t * vR).sum()

    def ao_grad(self, aoR):
        return ao_gradient_fft(aoR, self.mesh, self.Gv_mesh)

    def exchange(self, moR, dm, S):
        """sum over one set of occupied orbitals (scaled by sqrt(occ)) of the
        pair exchange, with the probe-charge term mad Tr(D S D S)."""
        ex = self.weight * pair_exchange(moR, self.kern, self.mesh) \
            if moR.shape[1] else 0.0
        if self.exxdiv == "ewald":
            dms = dm @ S
            ex = ex + self.mad_add * (dms * dms.T).sum()
        return ex


def make_energy_fn(system, xc=None, exxdiv="ewald", timer=None):
    """Build E(positions; D, W, C_occ_weighted): the converged-density
    energy functional with every position dependence traced (``timer``:
    see :func:`rhf_gradient`)."""
    t = GammaTerms(system, xc, exxdiv, timer)
    xcspec = t.xcspec

    def energy(positions, dm, w_mat, mo_w):
        aoR = t.aoR(positions)
        S, T = t.st(positions)
        tt = aoR @ dm
        rho = (tt * aoR).sum(-1)
        e1 = (dm * T).sum() + t.nuclear(positions, rho, dm)
        e_coul = t.hartree(rho)

        e_xc = 0.0
        if xcspec is not None:
            if xcspec.family in ("gga", "mgga"):
                ao_grad = t.ao_grad(aoR)
                grad_rho = 2.0 * torch.einsum("gi,xgi->xg", tt, ao_grad)
                sigma = (grad_rho * grad_rho).sum(0)
                if xcspec.family == "mgga":
                    tg = torch.einsum("xgi,ij->xgj", ao_grad, dm)
                    tau = 0.5 * torch.einsum("xgj,xgj->g", tg, ao_grad)
                    exc = xcspec._exc(_max(rho, 1e-30), _max(sigma, 1e-30),
                                      _max(tau, 1e-30))
                else:
                    exc, _, _ = xcspec.exc_vxc(rho, sigma)
            else:
                exc, _, _ = xcspec.exc_vxc(rho)
            e_xc = t.weight * (rho * exc).sum()

        # exact exchange at fixed occupied MOs (D = mo_w mo_w^T)
        e_k = -0.25 * t.exchange(aoR @ mo_w, dm, S) if t.need_k else 0.0
        e_pulay = -(w_mat * S).sum()
        return e1 + e_coul + e_xc + e_k + t.ewald.energy(positions) + e_pulay

    return energy


def value_and_grad_at(e_fn, x0, args, pulay, timer=None):
    """(dE/dx at ``x0`` as numpy, E(x0) + ``pulay``) of ``e_fn(x, *args)``,
    x the atom positions or the strain. ``pulay`` is Tr(W S) at x0: the
    functional carries -Tr(W S(x)), a constant offset of the value, so the
    sum is the physical total energy. ``timer`` records 'forward' and
    'backward'."""
    timer = timer or null_timer
    x = x0.detach().clone().requires_grad_(True)
    with timer("forward"):
        val = e_fn(x, *args)
    with timer("backward"):
        grad, = torch.autograd.grad(val, x)
    return grad.cpu().numpy(), float(val.detach()) + pulay


def rhf_gradient(system, scf_res, xc=None, exxdiv="ewald", return_energy=False,
                 device=None, timer=None):
    """dE_tot/dR (natm, 3) for a converged Gamma closed-shell SCF.

    Forces are -gradient. The Pulay term uses the energy-weighted DM
    W = 2 sum_occ eps_m C_m C_m^T; integer occupations only. Runs on
    ``device`` (default: the GPU), where the system must live. ``timer``
    (a :class:`~pyscf_isdf_tpu_torch.utils.timing.StageTimer`) records
    'setup' (the static tables), 'forward' (the energy), 'backward' and,
    inside it, 'ao_vjp' (the AO-derivative pass).
    """
    dev = require_device(system.aoR, device)
    mo_e = to_host(scf_res["mo_energy"])
    mo_c = to_host(scf_res["mo_coeff"])
    nocc = system.nelec // 2
    dm = _tensor(to_host(scf_res["dm"]), dev)
    c_occ = mo_c[:, :nocc]
    w_mat = _tensor(2.0 * (c_occ * mo_e[:nocc]) @ c_occ.T, dev)
    mo_w = _tensor(c_occ * np.sqrt(2.0), dev)
    with (timer or null_timer)("setup"):
        e_fn = make_energy_fn(system, xc=xc, exxdiv=exxdiv, timer=timer)
    grad, e_tot = value_and_grad_at(e_fn, _tensor(system.cell.coords, dev),
                                    (dm, w_mat, mo_w), float((w_mat * system.S).sum()),
                                    timer)
    return (grad, e_tot) if return_energy else grad

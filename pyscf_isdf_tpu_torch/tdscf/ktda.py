"""k-point TDA and TDDFT (vertical q=0 excitations) for KRHF/KRKS states.

Matrix-free A.x over complex k-resolved amplitudes x[k, i, a] (reference
analog: pyscf/pbc/tdscf/krks.py). With Bloch orbitals the conjugation
pattern matters; for the Hermitian TDA operator

    (A x)[k,ia] = (e_a(k) - e_i(k)) x[k,ia]
      + fac * w sum_g Mo[k,g,i] conj(Mv[k,g,a]) V[rho_x](g)     (Coulomb)
      - hyb  * [ Uv_k^H (M_x o conj(W_q)) Uo_k ]^T_{ia} / nk     (exchange)
      + w sum_g Mo[k,g,i] conj(Mv[k,g,a]) f_xc(g) rho_x(g)       (XC, LDA)

with the q=0 transition density rho_x = (1/nk) sum_k diag(conj(Mo) x Mv),
the exchange through the k-ISDF factors (M_x = Uv_k' x^T Uo_k'^H at the
interpolation points), and the adiabatic LDA kernel f_xc (singlet f_aa +
f_ab, triplet f_aa - f_ab); the GGA kernel is the directional derivative
of the pair-projected Vxc (:func:`~pyscf_isdf_tpu_torch.tdscf.response.linear_jvp`).
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import to_host as _host
from pyscf_isdf_tpu_torch.df import fftdf
from pyscf_isdf_tpu_torch.ops.ao_eval import ao_gradient_fft_k
from pyscf_isdf_tpu_torch.ops.xc import XCSpec, _max
from pyscf_isdf_tpu_torch.tdscf.response import davidson, linear_jvp
from pyscf_isdf_tpu_torch.tdscf.rks import _fxc_lda


def make_ktda_matvec(system, kscf_res, xc=None, singlet=True, isdfk=None, nocc=None):
    """Return (matvec(x (nk, no, nv) complex), diag) for the k-point TDA."""
    apply_a, _, diag = make_ktddft_ops(system, kscf_res, xc=xc, singlet=singlet,
                                       isdfk=isdfk, nocc=nocc)
    return apply_a, diag


def _gga_response(xcspec, Mo, Mv, Mo_g, Mv_g, rho0, g0, w, singlet):
    """(drho, dgrho) -> the pair-projected GGA response (nk, no, nv): the
    directional derivative of the occ-vir Vxc elements in the density and
    its gradient (closed-shell factor 2 for the singlet; the alpha channel
    of the spin functional along (+, -) at (rho/2, rho/2) for the triplet),
    complex tangents by linearity over their real and imaginary parts."""

    def vxc_ov(rho, grho):
        sig = _max((grho * grho).sum(0), 1e-30)
        _, vrho, vsigma = xcspec.exc_vxc(_max(rho, 1e-30), sig)
        t1 = torch.einsum("kgi,g,kga->kia", Mo, vrho.to(Mo.dtype), Mv.conj())
        # 2 vsigma grad_rho . grad(phi_i conj(phi_a))
        gdot_o = torch.einsum("xg,kxgi->kgi", grho.to(Mo.dtype), Mo_g)
        gdot_v = torch.einsum("xg,kxga->kga", grho.to(Mo.dtype), Mv_g.conj())
        vs2 = (2.0 * vsigma).to(Mo.dtype)
        t2 = torch.einsum("kgi,g,kga->kia", gdot_o, vs2, Mv.conj())
        t3 = torch.einsum("kgi,g,kga->kia", Mo, vs2, gdot_v)
        return w * (t1 + t2 + t3)

    def vxc_ov_a(ra, rb, ga, gb):
        # dE/d grad(rho_a) = 2 v_saa grad(rho_a) + v_sab grad(rho_b)
        saa = _max((ga * ga).sum(0), 1e-30)
        sab = (ga * gb).sum(0)
        sbb = _max((gb * gb).sum(0), 1e-30)
        _, (va, _vb), (vsaa, vsab, _vsbb) = xcspec.exc_vxc_spin(
            _max(ra, 1e-30), _max(rb, 1e-30), saa, sab, sbb)
        gpot = (2.0 * vsaa[None, :] * ga + vsab[None, :] * gb).to(Mo.dtype)
        t1 = torch.einsum("kgi,g,kga->kia", Mo, va.to(Mo.dtype), Mv.conj())
        gdot_o = torch.einsum("xg,kxgi->kgi", gpot, Mo_g)
        gdot_v = torch.einsum("xg,kxga->kga", gpot, Mv_g.conj())
        t2 = torch.einsum("kgi,kga->kia", gdot_o, Mv.conj())
        t3 = torch.einsum("kgi,kga->kia", Mo, gdot_v)
        return w * (t1 + t2 + t3)

    if singlet:
        jv = linear_jvp(vxc_ov, rho0, g0)

        def response(drho, dgrho):
            return (jv(2.0 * drho.real, 2.0 * dgrho.real)
                    + 1j * jv(2.0 * drho.imag, 2.0 * dgrho.imag))
    else:
        half_r, half_g = 0.5 * rho0, 0.5 * g0
        jv = linear_jvp(vxc_ov_a, half_r, half_r, half_g, half_g)

        def response(drho, dgrho):
            re, im = drho.real, drho.imag
            gre, gim = dgrho.real, dgrho.imag
            return jv(re, -re, gre, -gre) + 1j * jv(im, -im, gim, -gim)
    return response


def make_ktddft_ops(system, kscf_res, xc=None, singlet=True, isdfk=None, nocc=None):
    """(apply_A, apply_B, diag) response actions for k-point TDDFT.

    A is the TDA block; B the de-excitation coupling (full Casida). Both
    act on complex amplitudes (nk, no, nv). With (A x)_{ia} = <a| dF[dD_x]
    |i> + delta-e, dD_x = sum x_jb psi_b psi_j^dag, the B action is the
    same Fock-response projection at the conjugate-component perturbation
    dD_y = sum y_jb psi_j psi_b^dag, so A and B share every precomputed
    object and differ in how the transition density and the IP density
    block are assembled from the amplitudes.
    """
    aoR_k = system.aoR_k
    dev, cdt = aoR_k.device, aoR_k.dtype
    nk = len(system.kpts)
    mo_e = [_host(e) for e in kscf_res["mo_energy"]]
    mo_c = [torch.as_tensor(_host(c), device=dev) for c in kscf_res["mo_coeff"]]
    if nocc is None:
        nocc = system.cell.nelectron // 2
    xcspec = XCSpec(xc) if xc is not None else None
    if xcspec is not None and xcspec.family == "hf":
        xcspec = None
    hyb = 1.0 if xcspec is None else xcspec.hyb
    fac = 2.0 if singlet else 0.0
    is_gga = xcspec is not None and xcspec.family == "gga"
    if xcspec is not None and xcspec.family not in ("lda", "gga"):
        raise NotImplementedError(f"k-TDA kernel of the {xcspec.family} family")
    if hyb > 0 and isdfk is None:
        raise ValueError("k-TDA with exact exchange needs a built ISDFK")

    Co = torch.stack([c[:, :nocc] for c in mo_c]).to(cdt)
    Cv = torch.stack([c[:, nocc:] for c in mo_c]).to(cdt)
    Mo = torch.einsum("kgm,kmi->kgi", aoR_k, Co)
    Mv = torch.einsum("kgm,kma->kga", aoR_k, Cv)
    coulG = system.coulG
    mesh, w = system.mesh, system.weight
    diag = np.stack([mo_e[k][nocc:][None, :] - mo_e[k][:nocc][:, None]
                     for k in range(nk)])
    diag_t = torch.as_tensor(diag, dtype=torch.float64, device=dev)

    fxc, gga, Mo_g, Mv_g = None, None, None, None
    if xcspec is not None:
        dm0 = torch.as_tensor(np.asarray([_host(d) for d in kscf_res["dm"]]), dtype=cdt,
                              device=dev)
        t0 = torch.einsum("kgi,kij->kgj", aoR_k, dm0)
        rho0 = torch.einsum("kgj,kgj->g", t0, aoR_k.conj()).real / nk
        if not is_gga:
            fs, ft = _fxc_lda(xcspec, rho0)
            fxc = (fs if singlet else ft).to(cdt)
        else:
            coords = torch.as_tensor(system.cell.uniform_grid(), dtype=torch.float64,
                                     device=dev)
            Gv = torch.as_tensor(system.cell.get_Gv(), dtype=torch.float64, device=dev)
            ao_grad_k = torch.stack([
                ao_gradient_fft_k(aoR_k[k], mesh, Gv,
                                  torch.as_tensor(system.kpts[k], dtype=torch.float64,
                                                  device=dev), coords)
                for k in range(nk)])                               # (nk, 3, ng, nao)
            Mo_g = torch.einsum("kxgm,kmi->kxgi", ao_grad_k, Co)
            Mv_g = torch.einsum("kxgm,kma->kxga", ao_grad_k, Cv)
            g0 = 2.0 / nk * torch.einsum("kgj,kxgj->xg", t0.conj(), ao_grad_k).real
            gga = _gga_response(xcspec, Mo, Mv, Mo_g, Mv_g, rho0, g0, w, singlet)

    if hyb > 0:
        Uo = torch.einsum("kpm,kmi->kpi", isdfk.Ug, Co)     # (nk, nip, no)
        Uv = torch.einsum("kpm,kma->kpa", isdfk.Ug, Cv)     # (nk, nip, nv)
        qmap, Wq = isdfk.qmap, isdfk.Wq

    def exchange(blocks):
        """hyb [Uv_k1^H (sum_k2 M_k2 o conj(W_q(k2,k1))) Uo_k1]^T / nk per k1
        (the products are linear in M: the k2 sum is taken on the
        interpolation points, then two GEMMs per k1)."""
        out = []
        for k1 in range(nk):
            acc = blocks[0] * Wq[qmap[0, k1]].conj()
            for k2 in range(1, nk):
                acc = acc + blocks[k2] * Wq[qmap[k2, k1]].conj()
            out.append((Uv[k1].conj().T @ acc @ Uo[k1]).T / nk)
        return hyb * torch.stack(out)

    def respond(rho, dgrho_fn, blocks_fn, out):
        if fac != 0.0:
            vR = fftdf.ifft3(coulG * fftdf.fft3(rho, mesh), mesh)
            out = out + fac * w * torch.einsum("kgi,g,kga->kia", Mo, vR, Mv.conj())
        if hyb > 0:
            out = out - exchange(blocks_fn())
        if fxc is not None:
            out = out + w * torch.einsum("kgi,g,kga->kia", Mo, fxc * rho, Mv.conj())
        if gga is not None:
            out = out + gga(rho, dgrho_fn())
        return out

    def apply_a(x):
        xk = torch.as_tensor(x, device=dev).to(cdt)
        # q=0 transition density rho_x(g) = (1/nk) sum conj(phi_j) phi_b x_jb
        rho = torch.einsum("kgi,kia,kga->g", Mo.conj(), xk, Mv) / nk
        return respond(
            rho,
            lambda: (torch.einsum("kxgi,kia,kga->xg", Mo_g.conj(), xk, Mv)
                     + torch.einsum("kgi,kia,kxga->xg", Mo.conj(), xk, Mv_g)) / nk,
            lambda: [Uv[k] @ xk[k].T @ Uo[k].conj().T for k in range(nk)],
            diag_t * xk)

    def apply_b(y):
        yk = torch.as_tensor(y, device=dev).to(cdt)
        # de-excitation perturbation dD_y = sum y_jb psi_j psi_b^dag
        rho = torch.einsum("kgj,kjb,kgb->g", Mo, yk, Mv.conj()) / nk
        return respond(
            rho,
            lambda: (torch.einsum("kxgj,kjb,kgb->xg", Mo_g, yk, Mv.conj())
                     + torch.einsum("kgj,kjb,kxgb->xg", Mo, yk, Mv_g.conj())) / nk,
            lambda: [Uo[k] @ yk[k] @ Uv[k].conj().T for k in range(nk)],
            torch.zeros_like(yk))

    return apply_a, apply_b, diag


def ktddft_kernel(system, kscf_res, xc=None, nstates=3, singlet=True, isdfk=None,
                  nocc=None):
    """Full k-point TDDFT (Casida/RPA) excitation energies at q=0.

    Solves the non-Hermitian RPA problem
        [[A, B], [-conj(B), -conj(A)]] [x, y] = w [x, y]
    with A and B materialized column by column through the matrix-free
    response actions. Returns the lowest ``nstates`` positive excitation
    energies (Hartree).
    """
    apply_a, apply_b, diag = make_ktddft_ops(system, kscf_res, xc=xc, singlet=singlet,
                                             isdfk=isdfk, nocc=nocc)
    shape = diag.shape
    n = int(np.prod(shape))
    A = np.zeros((n, n), dtype=np.complex128)
    B = np.zeros((n, n), dtype=np.complex128)
    for j in range(n):
        e = np.zeros(n, dtype=np.complex128)
        e[j] = 1.0
        A[:, j] = _host(apply_a(e.reshape(shape))).reshape(-1)
        B[:, j] = _host(apply_b(e.reshape(shape))).reshape(-1)
    M = np.block([[A, B], [-np.conj(B), -np.conj(A)]])
    w = np.linalg.eigvals(M)
    w = np.sort(w.real[(np.abs(w.imag) < 1e-8) & (w.real > 1e-10)])
    return w[:nstates]


def ktda_davidson(system, kscf_res, xc=None, nstates=3, singlet=True, isdfk=None,
                  tol=1e-7):
    """Iterative k-point TDA excitation energies, in the realified space
    (real and imaginary parts stacked): complex states appear with doubled
    multiplicity, the eigenvalues are unaffected."""
    matvec, diag = make_ktda_matvec(system, kscf_res, xc=xc, singlet=singlet,
                                    isdfk=isdfk)

    def mv_real(z):
        out = matvec(z[0] + 1j * z[1])
        return torch.stack([out.real, out.imag])

    return davidson(mv_real, np.stack([diag, diag]), nstates=nstates, tol=tol)

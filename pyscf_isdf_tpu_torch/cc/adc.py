"""ADC(2) ionization potentials and electron affinities, spin-orbital (torch).

Reference capability: pyscf/pbc/adc/ (kadc_rhf_ip.py, kadc_rhf_ea.py,
spatial-orbital non-Dyson ADC for periodic systems) and pyscf/adc. The
compact spin-orbital non-Dyson strict-ADC(2) secular matrix is built dense
on the device of the integrals (oracle grade, as cc/fci.py and cc/cisd.py;
the production ionized states are EOM-CCSD's, cc/eom.py):

  IP sector, (N-1)-state energies E (IP_n = -E_n), basis {i} + {(k,l,a)}:
      A_hh  = eps_i d_ij + 1/4 sum_{kab} [ t_ik^ab <jk||ab>*
                                          + t_jk^ab* <ik||ab> ]
      A_h,2h1p = 1/sqrt(2) <ia||kl>       (unrestricted (k,l,a); the
                                          sqrt(2) is fixed by the fold
                                          identity)
      A_2h1p   = (eps_k + eps_l - eps_a) d
  EA sector mirrors with h <-> p.

Structural identities pin it: the fold U (E - D)^-1 U^dagger equals the
second-order dynamic self-energy 1/2 sum <ia||kl><ja||kl>* /
(E + eps_a - eps_k - eps_l); with the two-electron integrals zeroed,
IP_n = -eps_i and EA_n = eps_a exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from pyscf_isdf_tpu_torch.device import require_device


def _t2_amps(e_occ, e_vir, V_oovv):
    d = (e_occ[:, None, None, None] + e_occ[None, :, None, None]
         - e_vir[None, None, :, None] - e_vir[None, None, None, :])
    return V_oovv / d


def _inputs(e_occ, e_vir, V):
    V = torch.as_tensor(V)
    return (torch.as_tensor(e_occ, device=V.device).to(torch.float64),
            torch.as_tensor(e_vir, device=V.device).to(torch.float64), V)


def _secular(diag1, stat, U, D, dtype):
    n1, n2 = len(diag1), D.numel()
    A = torch.zeros((n1 + n2, n1 + n2), dtype=dtype, device=U.device)
    A[:n1, :n1] = torch.diag(diag1).to(dtype) + stat
    A[:n1, n1:] = U
    A[n1:, :n1] = U.conj().T
    A[n1:, n1:] = torch.diag(D).to(dtype)
    return A


def ip_adc2_matrix(e_occ, e_vir, V):
    """Dense IP-ADC(2) matrix in the E convention (IP = -eigenvalue).

    Args:
        e_occ/e_vir: spin-orbital energies.
        V: antisymmetrized <pq||rs> over all spin orbitals.
    Returns A, hermitian of dim no + no*no*nv, on the device of ``V``.
    """
    e_occ, e_vir, V = _inputs(e_occ, e_vir, V)
    no, nv = len(e_occ), len(e_vir)
    o, v = slice(0, no), slice(no, no + nv)
    V_oovv = V[o, o, v, v]
    t2 = _t2_amps(e_occ, e_vir, V_oovv)
    stat = 0.25 * (torch.einsum("ikab,jkab->ij", t2, V_oovv.conj())
                   + torch.einsum("jkab,ikab->ij", t2.conj(), V_oovv))
    # coupling <ia||kl> = V[i, a, k, l] over unrestricted (k, l, a)
    U = V[o, v, o, o].permute(0, 2, 3, 1).reshape(no, -1) / np.sqrt(2.0)
    D = (e_occ[:, None, None] + e_occ[None, :, None]
         - e_vir[None, None, :]).reshape(-1)
    return _secular(e_occ, stat, U, D, V.dtype)


def ea_adc2_matrix(e_occ, e_vir, V):
    """Dense EA-ADC(2) matrix (attachment energies are its eigenvalues)."""
    e_occ, e_vir, V = _inputs(e_occ, e_vir, V)
    no, nv = len(e_occ), len(e_vir)
    o, v = slice(0, no), slice(no, no + nv)
    V_oovv = V[o, o, v, v]
    t2 = _t2_amps(e_occ, e_vir, V_oovv)
    stat = -0.25 * (torch.einsum("ijac,ijbc->ab", t2, V_oovv.conj())
                    + torch.einsum("ijbc,ijac->ab", t2.conj(), V_oovv))
    # coupling <ai||bc>-type: U_{a,(ibc)} = <ai||bc>/sqrt(2)
    U = V[v, o, v, v].reshape(nv, -1) / np.sqrt(2.0)
    D = (e_vir[None, :, None] + e_vir[None, None, :]
         - e_occ[:, None, None]).reshape(-1)
    return _secular(e_vir, stat, U, D, V.dtype)


def ip_adc2(e_occ, e_vir, V, nroots: int = 3):
    """Lowest ionization potentials (positive, Hartree; numpy)."""
    w = torch.linalg.eigvalsh(ip_adc2_matrix(e_occ, e_vir, V)).cpu().numpy()
    # (N-1) energies near the occupied manifold: IPs are -E ascending
    ips = np.sort(-w)
    ips = ips[ips > 0.0] if (ips > 0.0).any() else ips
    return ips[:nroots]


def ea_adc2(e_occ, e_vir, V, nroots: int = 3):
    """Lowest electron-attachment energies (Hartree, negative = bound;
    numpy)."""
    w = torch.linalg.eigvalsh(ea_adc2_matrix(e_occ, e_vir, V)).cpu().numpy()
    return np.sort(w)[:nroots]


def adc2_from_scf(system, res, nroots: int = 3, device=None):
    """(IPs, EAs) from a converged Gamma closed-shell SCF, on ``device``
    (default: the GPU), where ``system`` must live."""
    from pyscf_isdf_tpu_torch.cc import gccsd

    dev = require_device(system.aoR, device)
    mo_c = torch.as_tensor(res["mo_coeff"], device=dev)
    _, V = gccsd.spinorb_from_spatial(mo_c.T @ system.hcore @ mo_c,
                                      gccsd._mo_eri_gamma(system, mo_c))
    e = torch.as_tensor(res["mo_energy"], device=dev).to(torch.float64)
    if not bool((torch.diff(e) >= -1e-12).all()):
        # reordering e_so alone would decouple energies from V (the
        # integrals stay in the interleaved orbital order)
        raise ValueError("adc2_from_scf needs ascending mo_energy "
                         "(reorder mo_coeff/mo_energy together first)")
    e_so = e.repeat_interleave(2)    # interleaved, V's orbital order
    nocc_so = system.nelec
    eo, ev = e_so[:nocc_so], e_so[nocc_so:]
    return (ip_adc2(eo, ev, V, nroots), ea_adc2(eo, ev, V, nroots))

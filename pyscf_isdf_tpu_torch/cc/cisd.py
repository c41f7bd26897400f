"""CISD (configuration interaction, singles and doubles) at Gamma (torch).

Reference capability: pyscf/pbc/ci/cisd.py (a Gamma-point wrapper around
the molecular CISD solver, pyscf/ci/cisd.py). The reference's k-point CIS
(pyscf/pbc/ci/kcis_rhf.py) is the matrix-free k-TDA with xc=None
(tdscf/ktda.py): TDA on a Hartree-Fock reference is CIS.

Implementation: the determinant-space Hamiltonian of the FCI oracle
(cc/fci.py), restricted to the determinants within double excitations of
the HF reference: variational, size-inconsistent CISD, exact in the
truncated space. Oracle grade (dense); the production correlation path is
CCSD (cc/gccsd.py).
"""
from __future__ import annotations

from itertools import combinations

import torch

from pyscf_isdf_tpu_torch.cc.fci import build_hamiltonian
from pyscf_isdf_tpu_torch.device import require_device


def cisd_determinants(nso: int, nelec: int):
    """All determinants within rank-2 excitations of the Aufbau det."""
    ref = set(range(nelec))
    return [d for d in combinations(range(nso), nelec)
            if nelec - len(ref & set(d)) <= 2]


def cisd_ground_state(h1so, eri_so, nelec: int, nroots: int = 1):
    """Lowest CISD eigenvalue(s) (numpy) and the determinant count; the
    inputs of fci_ground_state, on the device of ``eri_so``."""
    nso = torch.as_tensor(h1so).shape[0]
    dets = cisd_determinants(nso, nelec)
    H = build_hamiltonian(h1so, eri_so, dets)
    w = torch.linalg.eigvalsh(H)
    return w[:nroots].cpu().numpy(), len(dets)


def cisd(system, res, nroots: int = 1, device=None):
    """Gamma-point CISD on a converged closed-shell SCF, on ``device``
    (default: the GPU), where ``system`` must live.

    Returns (e_corr, e_tot) like cc.ccsd; the variational bound
    E_HF >= E_CISD >= E_FCI is the structural test.
    """
    from pyscf_isdf_tpu_torch.cc import gccsd

    dev = require_device(system.aoR, device)
    mo_c = torch.as_tensor(res["mo_coeff"], device=dev)
    h1mo = mo_c.T @ system.hcore @ mo_c
    h1so, eri_so = gccsd.spinorb_from_spatial(h1mo,
                                              gccsd._mo_eri_gamma(system, mo_c))
    (e_el,), _ = cisd_ground_state(h1so, eri_so, system.nelec, nroots=nroots)
    e_tot = float(e_el) + system.e_nuc
    return e_tot - res["e_tot"], e_tot

"""Coupled cluster and its oracles (torch): spin-orbital CCSD(T) and UCCSD
at Gamma, the three k-point CCSD tiers (composite, blocked spin-orbital,
closed-shell spatial) with KUCCSD, EOM-CCSD, ADC(2), the CCSD response
density, and the FCI and CISD oracles. Reference capability: pyscf/cc,
pyscf/pbc/cc, pyscf/pbc/ci, pyscf/pbc/adc, as the JAX package carries them
over (``pyscf_isdf_tpu/cc/``).
"""
from pyscf_isdf_tpu_torch.cc.gccsd import ccsd, ccsd_t, kernel  # noqa: F401
from pyscf_isdf_tpu_torch.cc.kccsd import kccsd  # noqa: F401
from pyscf_isdf_tpu_torch.cc.kccsd_blocked import kccsd_blocked  # noqa: F401
from pyscf_isdf_tpu_torch.cc.krccsd import krccsd  # noqa: F401
from pyscf_isdf_tpu_torch.cc.fci import fci_ground_state  # noqa: F401
from pyscf_isdf_tpu_torch.cc.cisd import cisd, cisd_ground_state  # noqa: F401
from pyscf_isdf_tpu_torch.cc.adc import adc2_from_scf, ip_adc2, ea_adc2  # noqa: F401
from pyscf_isdf_tpu_torch.cc.eom import (eom_ccsd, eom_from_scf,  # noqa: F401
                                         eom_ee_energies, eom_ee_iterative)
from pyscf_isdf_tpu_torch.cc.density import ccsd_rdm1, fci_rdm1  # noqa: F401

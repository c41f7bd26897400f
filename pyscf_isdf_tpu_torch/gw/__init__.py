"""GW quasiparticle methods (G0W0, evGW, contour deformation) and RPA
correlation energies, Gamma and k-point, closed and open shell (torch).

Reference capability: pyscf/pbc/gw/ (krgw_ac.py, krgw_cd.py, kugw_ac.py)
and pyscf/gw/ (gw_ac, gw_exact, rpa), as the JAX package carries them
over (``pyscf_isdf_tpu/gw/``). The self-energy on the imaginary axis is
taken over frequency chunks on the device (gw/rgw.py); the Pade
continuation and the QP solves stay on the host in float64.
"""
from pyscf_isdf_tpu_torch.gw.rgw import (
    GWResult,
    gw_ac_gamma,
    rpa_ecorr_gamma,
)
from pyscf_isdf_tpu_torch.gw.rgw import evgw_gamma
from pyscf_isdf_tpu_torch.gw.gw_exact import gw_exact_gamma, drpa_diagonalize
from pyscf_isdf_tpu_torch.gw.krgw import (KGWResult, kgw_ac, rpa_ecorr_kpts,
                                          dielectric_constant)
from pyscf_isdf_tpu_torch.gw.ugw import UGWResult, ugw_ac_gamma, kugw_ac

__all__ = [
    "GWResult", "gw_ac_gamma", "rpa_ecorr_gamma", "evgw_gamma",
    "gw_exact_gamma", "drpa_diagonalize", "KGWResult", "kgw_ac", "rpa_ecorr_kpts",
    "dielectric_constant", "UGWResult", "ugw_ac_gamma", "kugw_ac",
]

from pyscf_isdf_tpu_torch.scf.hf import SCFSystem, build_scf_system, scf_kernel  # noqa: F401
from pyscf_isdf_tpu_torch.scf.khf import (  # noqa: F401
    KSCFSystem, build_kscf_system, kscf_kernel,
)
from pyscf_isdf_tpu_torch.scf.kuhf import kuhf_kernel  # noqa: F401
from pyscf_isdf_tpu_torch.scf.uhf import uhf_kernel  # noqa: F401
from pyscf_isdf_tpu_torch.scf.khf_ksymm import kscf_ibz_kernel  # noqa: F401
from pyscf_isdf_tpu_torch.scf.rohf import rohf_kernel  # noqa: F401
from pyscf_isdf_tpu_torch.scf.krohf import krohf_kernel  # noqa: F401
from pyscf_isdf_tpu_torch.scf.kghf import kghf_kernel  # noqa: F401
from pyscf_isdf_tpu_torch.scf.bands import get_bands  # noqa: F401
from pyscf_isdf_tpu_torch.scf.cdft import cdft_kernel  # noqa: F401

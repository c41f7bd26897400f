from pyscf_isdf_tpu_torch.mp.mp2 import mp2_energy  # noqa: F401
from pyscf_isdf_tpu_torch.mp.thc import thc_mp2_energy  # noqa: F401
from pyscf_isdf_tpu_torch.mp.kmp2_stagger import kmp2_stagger_energy  # noqa: F401

from pyscf_isdf_tpu_torch.mp.mp2 import mp2_energy  # noqa: F401
from pyscf_isdf_tpu_torch.mp.thc import thc_mp2_energy  # noqa: F401

from pyscf_isdf_tpu_torch.utils.elements import ELEMENTS, charge_of  # noqa: F401
from pyscf_isdf_tpu_torch.utils.misc import fingerprint  # noqa: F401

from pyscf_isdf_tpu_torch.utils.elements import ELEMENTS, charge_of  # noqa: F401

from pyscf_isdf_tpu_torch.models.systems import (  # noqa: F401
    diamond_primitive,
    diamond_supercell,
)

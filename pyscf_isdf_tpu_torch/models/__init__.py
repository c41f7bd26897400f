from pyscf_isdf_tpu_torch.models.systems import (  # noqa: F401
    diamond_cubic,
    diamond_primitive,
    diamond_supercell,
    graphene,
)

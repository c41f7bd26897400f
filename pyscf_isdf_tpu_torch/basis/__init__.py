from pyscf_isdf_tpu_torch.basis.gth import (  # noqa: F401
    Shell,
    PseudoPotential,
    load_basis,
    load_pseudo,
    normalize_shell,
)

"""The grid-split multi-rank layer on ``torch.distributed`` (one process a
rank): rank plumbing, the distributed FFT, the split ISDF builds and SCF
steps, and the frequency-split GW self-energy."""
from pyscf_isdf_tpu_torch.parallel.mesh import (  # noqa: F401
    RankGroup, grid_mesh, init_group, launch, slab_bounds, slab_rows,
)

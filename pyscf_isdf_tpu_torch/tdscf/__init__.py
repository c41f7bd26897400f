from pyscf_isdf_tpu_torch.tdscf.rks import (  # noqa: F401
    tda_kernel, tddft_kernel, tda_oscillator_strengths,
    tda_oscillator_strengths_velocity)

from pyscf_isdf_tpu_torch.scf.hf import SCFSystem, build_scf_system, scf_kernel  # noqa: F401

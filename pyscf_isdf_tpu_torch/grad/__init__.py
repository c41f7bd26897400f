from pyscf_isdf_tpu_torch.grad.rhf import rhf_gradient  # noqa: F401
from pyscf_isdf_tpu_torch.grad.uhf import uhf_gradient  # noqa: F401
from pyscf_isdf_tpu_torch.grad.khf import krhf_gradient  # noqa: F401
from pyscf_isdf_tpu_torch.grad.kuhf import kuhf_gradient  # noqa: F401
from pyscf_isdf_tpu_torch.grad.stress import stress_tensor  # noqa: F401
from pyscf_isdf_tpu_torch.grad.kstress import kstress_tensor  # noqa: F401
from pyscf_isdf_tpu_torch.grad.optimize import optimize  # noqa: F401

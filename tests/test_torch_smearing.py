"""Port smeared occupations == JAX reference and its goldens.

The occupation functions against the reference's goldens
(tests/test_smearing.py: pyscf/pbc/scf/test/test_addons.py:53-67, a
synthetic two-k spectrum) and against the reference functions on the same
spectrum (1e-12). The smeared SCF runs are in tests/test_torch_uhf.py, on
its cells.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_thread  # noqa: E402,F401

from pyscf_isdf_tpu.scf import occupations as ref_occ  # noqa: E402

from pyscf_isdf_tpu_torch.scf import occupations  # noqa: E402

GOLDEN = {"fermi": 6.1656394960533021 / 2, "gauss": 0.94924016074521311 / 2}


@pytest.mark.parametrize("method", ["fermi", "gauss"])
def test_smearing_occ_rhf(method):
    mo_e_k = [np.arange(4) * 0.2 + np.cos(i + 0.5) * 0.1 for i in range(2)]
    occ, entropy, mu = occupations.smearing_occ_rhf(mo_e_k, nelec_tot=8, sigma=0.1,
                                                    method=method)
    assert abs(sum(o.sum() for o in occ) - 8.0) < 1e-8
    assert abs(entropy - GOLDEN[method]) < 1e-7
    occ0, entropy0, mu0 = ref_occ.smearing_occ_rhf(mo_e_k, nelec_tot=8, sigma=0.1,
                                                   method=method)
    assert abs(entropy - entropy0) < 1e-12 and abs(mu - mu0) < 1e-12
    for o, o0 in zip(occ, occ0):
        assert np.abs(o - o0).max() < 1e-12

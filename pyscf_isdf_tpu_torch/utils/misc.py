"""Small host-side utilities."""
import numpy as np


def fingerprint(a) -> float:
    """Deterministic scalar fingerprint of an array: the reference's
    ``lib.fp`` (pyscf/lib/misc.py:1150), so golden fingerprint values from
    the reference test suite can be asserted directly."""
    a = np.asarray(a)
    return np.dot(np.cos(np.arange(a.size)), a.ravel())

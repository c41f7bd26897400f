"""Seconds of the all-electron analytic build of the Si primitive cell
(sto-3g, the cell of tests/test_aegdf.py:82): the core Hamiltonian and the
whitened fit tensor of ``df/aegdf.py``, with the host McMurchie-Davidson
integrals (``ops/md_int``: vne, int2c, int3c, overlap) timed apart from
the rest (the long-range G-sphere's Fourier transforms, its GEMMs and the
eigh, on the device).

    python3 tools/ae_fit_time.py [--device cpu|cuda] [--omega 0.4]

The device defaults to the card; pass ``--device cpu`` to run on the host.
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.device import resolve_device  # noqa: E402
from pyscf_isdf_tpu_torch.df import aegdf  # noqa: E402
from pyscf_isdf_tpu_torch.ops import md_int  # noqa: E402

HOST_INTEGRALS = ("vne", "int2c", "int3c", "overlap")


def time_host_integrals(seconds):
    """Wrap ``md_int``'s integrals (called through the module by
    ``df/aegdf.py``) so that each call adds its seconds to ``seconds``."""
    for name in HOST_INTEGRALS:
        fn = getattr(md_int, name)

        def timed(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                seconds[_name] = seconds.get(_name, 0.0) + time.perf_counter() - t0

        setattr(md_int, name, timed)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--omega", type=float, default=0.4)
    args = ap.parse_args()
    device = resolve_device(args.device)
    a = 10.26
    lat = 0.5 * a * (np.ones((3, 3)) - np.eye(3))
    cell = build_cell(lat, [["Si", (0.0, 0.0, 0.0)], ["Si", (a / 4, a / 4, a / 4)]],
                      "sto-3g", mesh=(8, 8, 8))
    host = {}
    time_host_integrals(host)
    t0 = time.perf_counter()
    aegdf.ae_hcore(cell, args.omega, device=device)
    t1 = time.perf_counter()
    fit = aegdf.build_ae_gdf(cell, omega=args.omega, device=device)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    t2 = time.perf_counter()
    hcore_host = host.get("vne", 0.0)
    fit_host = sum(host.get(k, 0.0) for k in ("int2c", "int3c", "overlap"))
    print(f"Si sto-3g nao={cell.nao} on {device}: ae_hcore {t1 - t0:.2f} s "
          f"(host vne {hcore_host:.2f} s), build_ae_gdf {t2 - t1:.2f} s (host "
          + ", ".join(f"{k} {host.get(k, 0.0):.2f}" for k in ("int2c", "int3c", "overlap"))
          + f" s; the rest {t2 - t1 - fit_host:.2f} s); host integrals "
          f"{hcore_host + fit_host:.2f} s in all; naux kept {fit.naux}; "
          f"{os.cpu_count()} CPUs")


if __name__ == "__main__":
    main()

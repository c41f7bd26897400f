"""How far the card's and the CPU's UKS states of the H3 chain part, and
what that does to the UGW-CD deepest level (``chip_smoke.py`` 14f's cell).

    python3 tools/uhf_state_spread.py
    python3 tools/uhf_state_spread.py --cpu-threads N

Builds the H3 radical chain (doublet, gth-szv, 12^3, LDA) on the card and
on the CPU, converges ``uhf_kernel`` on each at conv_tol 1e-10, 1e-12 and
1e-14, and prints each pair's iteration counts, energies and largest
density difference. On each state it runs ``ugw_cd_gamma(orbs=[0])`` on
each device, with the QP solve's conv_tol at 1e-6 (the default) and
1e-10, and prints both spins' QP energies: the spread between states
against the spread between devices on one state. With ``--cpu-threads
N`` it runs the CPU alone under N torch threads, at conv_tol 1e-10 and
1e-12, and prints the counts, energies and both spins' QP energies.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from pyscf_isdf_tpu_torch import build_cell  # noqa: E402
from pyscf_isdf_tpu_torch.gw import gw_cd  # noqa: E402
from pyscf_isdf_tpu_torch.scf import build_scf_system, uhf_kernel  # noqa: E402

L = 8.0


def h3():
    return build_cell(np.eye(3) * L, [["H", (L / 2 - 1.5, L / 2, L / 2)],
                                      ["H", (L / 2, L / 2, L / 2)],
                                      ["H", (L / 2 + 1.5, L / 2, L / 2)]],
                      "gth-szv", pseudo="gth-pade", mesh=[12] * 3, spin=1)


def cpu_only(threads):
    torch.set_num_threads(threads)
    system = build_scf_system(h3(), device="cpu")
    for tol in (1e-10, 1e-12):
        res = uhf_kernel(system, xc="lda,vwn", conv_tol=tol)
        out = gw_cd.ugw_cd_gamma(system, res, xc="lda,vwn", orbs=[0], device="cpu")
        print(f"{threads} threads, conv_tol {tol}: {res['niter']} iterations, E "
              f"{res['e_tot']!r}; QP alpha {out.qp_energy[0][0]!r}, beta "
              f"{out.qp_energy[1][0]!r}", flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--cpu-threads":
        return cpu_only(int(sys.argv[2]))
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    systems = {d: build_scf_system(h3(), device=d) for d in ("cuda", "cpu")}
    for tol in (1e-10, 1e-12, 1e-14):
        res = {d: uhf_kernel(systems[d], xc="lda,vwn", conv_tol=tol, max_cycle=200)
               for d in systems}
        ddm = max(float((res["cuda"]["dm"][s].cpu() - res["cpu"]["dm"][s]).abs().max())
                  for s in range(2))
        print(f"conv_tol {tol}: iterations card {res['cuda']['niter']}, cpu "
              f"{res['cpu']['niter']}; E {res['cuda']['e_tot']!r} / {res['cpu']['e_tot']!r}; "
              f"max|D card - D cpu| {ddm:.3e}", flush=True)
        for qp_tol in (1e-6, 1e-10):
            for state in systems:
                for run in systems:
                    out = gw_cd.ugw_cd_gamma(systems[run], cs.on_dev(torch, res[state], run),
                                             xc="lda,vwn", orbs=[0], conv_tol=qp_tol,
                                             device=run)
                    print(f"  QP conv_tol {qp_tol}, {state}'s state on {run}: alpha "
                          f"{out.qp_energy[0][0]!r}, beta {out.qp_energy[1][0]!r}, "
                          f"converged {out.converged}", flush=True)


if __name__ == "__main__":
    main()

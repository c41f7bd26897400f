"""Rank bodies of tests/test_torch_parallel.py.

This module imports torch and the port only, so the ranks that
``parallel.mesh.launch`` starts never import JAX. Each body takes the
rank's group and a dict of numpy inputs prepared by the test module, runs
the port's sharded functions on the rank's slab, and returns numpy arrays.
"""
import sys

import torch
# kernel_sharded's DTensor: launch's forkserver imports this module, so the
# ranks start with it loaded
import torch.distributed.tensor  # noqa: F401


def _np(t):
    return t.detach().cpu().numpy()


def gamma_case(grp, case):
    """Distributed Poisson, the builds of ``case["methods"]`` and the LDA
    and Hartree-Fock (Madelung term) steps through the first build."""
    from pyscf_isdf_tpu_torch.ops.cuda_ao import make_ao_evaluator
    from pyscf_isdf_tpu_torch.parallel import distributed_fft as dfft
    from pyscf_isdf_tpu_torch.parallel.isdf_sharded import build_isdf_sharded
    from pyscf_isdf_tpu_torch.parallel.mesh import slab_rows
    from pyscf_isdf_tpu_torch.parallel.scf_step import make_scf_step

    cell, dev = case["cell"], grp.device
    mesh3 = tuple(cell.mesh)
    rows = slab_rows(mesh3, grp.rank, grp.world)
    aoR_l = make_ao_evaluator(cell, coords=cell.uniform_grid()[rows],
                              device=dev)()
    coulG = torch.as_tensor(case["coulG"], device=dev)
    coulG_t_l = dfft.coulG_transposed_layout(coulG, mesh3)[rows]
    rho_l = torch.as_tensor(case["rho"][rows], device=dev)
    out = {"aoR": _np(aoR_l),
           "vR": _np(dfft.poisson_slab(rho_l, coulG_t_l, mesh3, grp))}
    w = cell.grid_weight
    builds = {}
    for method in case["methods"]:
        builds[method] = isdf = build_isdf_sharded(
            grp, aoR_l, coulG, mesh3, w, case["n_ip"], method=method,
            blk=case["blk"])
        out[method] = {"aoRg": _np(isdf.aoRg), "W": _np(isdf.W),
                       "ip_idx": _np(isdf.ip_idx)}
    isdf = builds[case["methods"][0]]
    t = {k: torch.as_tensor(case[k], device=dev)
         for k in ("dm", "hcore", "X", "S")}
    for name, xc, mad in (("step", "lda,vwn", 0.0),
                          ("step_hf", None, case["madelung"])):
        step = make_scf_step(grp, mesh3, w, cell.nelectron // 2, xc=xc,
                             exxdiv_madelung=mad)
        dm_new, e_elec = step(t["dm"], aoR_l, coulG_t_l, isdf, t["hcore"],
                              t["X"], t["S"])
        out[name] = {"dm": _np(dm_new), "e_elec": float(e_elec)}
    out["bytes"] = dict(grp.bytes)
    return out


def k_case(grp, case):
    """The k-point build and the LDA and hybrid k steps."""
    from pyscf_isdf_tpu_torch.ops.ao_eval import eval_ao_kpts
    from pyscf_isdf_tpu_torch.parallel import distributed_fft as dfft
    from pyscf_isdf_tpu_torch.parallel.isdf_k_sharded import (
        build_isdf_k_sharded, make_kscf_step)
    from pyscf_isdf_tpu_torch.parallel.mesh import slab_rows

    cell, kpts, dev = case["cell"], case["kpts"], grp.device
    mesh3 = tuple(cell.mesh)
    rows = slab_rows(mesh3, grp.rank, grp.world)
    aoRk_l = eval_ao_kpts(cell, kpts, coords=cell.uniform_grid()[rows],
                          device=dev)
    coulG_t_l = dfft.coulG_transposed_layout(
        torch.as_tensor(case["coulG"], device=dev), mesh3)[rows]
    nk = len(kpts)
    t = {k: torch.as_tensor(case[k], device=dev) for k in ("hcore", "X", "S")}
    out = {}
    for name, xc, n_ip, mad in (("lda", "lda,vwn", case["n_ip_lda"], 0.0),
                                ("hf", None, case["n_ip_hf"], case["madelung"])):
        isdfk = build_isdf_k_sharded(grp, cell, aoRk_l, kpts, n_ip=n_ip)
        step = make_kscf_step(grp, mesh3, case["weight"], nk,
                              case["nelec_tot"] // 2, xc=xc,
                              exxdiv_madelung=mad)
        dm_k = torch.as_tensor(case["dm_" + name], device=dev)
        dm_new, e_elec = step(dm_k, aoRk_l, coulG_t_l, isdfk, t["hcore"],
                              t["X"], t["S"])
        out[name] = {"Ug": _np(isdfk.Ug), "Wq": _np(isdfk.Wq),
                     "ip_idx": _np(isdfk.ip_idx), "dm": _np(dm_new),
                     "e_elec": float(e_elec)}
    return out


def gw_case(grp, case):
    from pyscf_isdf_tpu_torch.parallel.gw_sharded import sigma_iw_sharded

    Lmo = torch.as_tensor(case["Lmo"], device=grp.device)
    return _np(sigma_iw_sharded(Lmo, case["mo_energy"], case["nocc"],
                                case["freqs"], case["wts"], case["omega_grid"],
                                case["ef"], grp))


def cc_case(grp, case):
    from pyscf_isdf_tpu_torch.cc import gccsd

    out = gccsd.kernel_sharded(case["f"], case["eri"], case["nocc"],
                               conv_tol=1e-11)
    return {"e_corr": out["e_corr"], "converged": out["converged"],
            "t2_local": _np(out["t2"].to_local()),
            "t2_full": _np(out["t2"].full_tensor()),
            "block_shapes": {k: tuple(b.to_local().shape)
                             for k, b in out["blocks"].items()}}


CASES = {"gamma": gamma_case, "k": k_case, "gw": gw_case, "cc": cc_case}


def run_all(grp, inputs):
    """Every case named in ``inputs`` on this rank, with the rank's world,
    and whether JAX was imported in this process (key ``"jax"``)."""
    out = {name: CASES[name](grp, case) for name, case in inputs.items()}
    out["jax"] = "jax" in sys.modules
    return out

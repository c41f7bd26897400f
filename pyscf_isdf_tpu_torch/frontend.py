"""pyscf-style object front end (torch).

Thin object sugar over the functional kernels so reference users keep their
workflow (``mf = RKS(cell); mf.xc = 'pbe'; mf.kernel()``), including the
``with_df``-style ISDF swap through ``density_fit('isdf')``. The functional
API (``scf.build_scf_system`` / ``scf_kernel``) stays the primary
interface.

Every class takes ``device=`` (default: the GPU, which raises without
CUDA; pass ``device="cpu"`` for the CPU); its system is built there and
every kernel runs there.
"""
from __future__ import annotations

import numpy as np

from pyscf_isdf_tpu_torch.cell import Cell
from pyscf_isdf_tpu_torch.device import resolve_device
from pyscf_isdf_tpu_torch.scf import hf as _hf
from pyscf_isdf_tpu_torch.scf import khf as _khf
from pyscf_isdf_tpu_torch.scf import rohf as _rohf
from pyscf_isdf_tpu_torch.scf import uhf as _uhf
from pyscf_isdf_tpu_torch.scf.bands import get_bands as _get_bands


class _MeanField:
    """Shared driver state for the Gamma-point mean-field classes."""

    xc: str | None = None

    def __init__(self, cell: Cell, xc=None, exxdiv="ewald", device=None):
        self.cell = cell
        self.xc = xc
        self.exxdiv = exxdiv
        self.device = resolve_device(device)
        self.conv_tol = 1e-9
        self.max_cycle = 60
        self.df = "fftdf"
        self.isdf_c = 8.0
        self.isdf_precision = None
        self.ae_omega = 0.4
        self.sigma = 0.0
        self.smearing_method = "fermi"
        self.xc_grids = "uniform"   # 'becke' = atomic-grid XC quadrature
        self.verbose = False
        self._system = None
        self._res = None

    def smearing(self, sigma, method="fermi"):
        """Finite-temperature occupations (the reference's addons.py:216
        applies to every SCF class, the Gamma point included)."""
        self.sigma = sigma
        self.smearing_method = method
        return self

    @property
    def system(self):
        if self._system is None:
            self._system = _hf.build_scf_system(
                self.cell, device=self.device, ae=(self.df == "aegdf"),
                ae_omega=self.ae_omega)
        return self._system

    def density_fit(self, kind: str = "isdf", c: float = 8.0,
                    precision: str | None = None, omega: float = 0.4):
        """Switch the exchange engine (the reference's with_df swap).

        ``kind='aegdf'`` selects the analytic all-electron engine
        (df/aegdf.py; the reference's GDF/RSDF regime,
        pyscf/pbc/scf/hf.py:810-821): S and hcore switch to the mesh-free
        analytic builds and J/K come from the whitened fit tensors;
        ``omega`` is its short/long-range split (the result does not depend
        on it). ``precision='dd'`` (the JAX package's double-float solve for
        an f32-only TPU) is not ported: the port solves in float64.
        """
        if precision is not None:
            raise NotImplementedError(
                f"isdf precision {precision!r}: the port solves in float64")
        if kind == "aegdf" and self._system is not None and not self._system.ae:
            self._system = None     # rebuild with analytic S/hcore
        self.df = kind
        self.isdf_c = c
        self.isdf_precision = precision
        self.ae_omega = omega
        return self

    def _kernel(self):
        raise NotImplementedError

    def kernel(self):
        self._res = self._kernel()
        return self._res["e_tot"]

    run = kernel
    scf = kernel

    def kernel_jit(self, df=None, isdf_c=None):
        """Deployment-mode SCF: the graph drivers (scf/jit_diis.py), one
        captured cycle replayed per iteration on the card (restricted
        Gamma and k classes; LDA/GGA/meta-GGA/hybrid/RSH).

        Fills e_tot, dm, converged and niter; orbital quantities need the
        host-loop :meth:`kernel`."""
        from pyscf_isdf_tpu_torch.scf import jit_diis as _jd

        runner = (_jd.run_kscf_jit_diis if isinstance(self, _KMeanField)
                  else _jd.run_scf_jit_diis)
        e_tot, dm, niter, conv = runner(
            self.system, xc=self.xc, exxdiv=self.exxdiv,
            df=df if df is not None else self.df,
            isdf_c=isdf_c if isdf_c is not None else self.isdf_c,
            max_cycle=self.max_cycle, conv_tol=self.conv_tol)
        self._res = {"e_tot": e_tot, "dm": dm, "converged": conv,
                     "niter": niter}
        return e_tot

    def __getattr__(self, name):
        res = self.__dict__.get("_res")
        if res is not None and name in res:
            return res[name]
        raise AttributeError(name)

    def get_bands(self, kpts_band):
        return _get_bands(self.system, self._res, kpts_band, xc=self.xc,
                          device=self.device)


class RHF(_MeanField):
    def __init__(self, cell, exxdiv="ewald", device=None):
        super().__init__(cell, xc=None, exxdiv=exxdiv, device=device)

    def _kernel(self):
        return _hf.scf_kernel(self.system, xc=None, exxdiv=self.exxdiv,
                              conv_tol=self.conv_tol, max_cycle=self.max_cycle,
                              df=self.df, isdf_c=self.isdf_c,
                              isdf_precision=self.isdf_precision,
                              sigma=self.sigma,
                              smearing_method=self.smearing_method,
                              verbose=self.verbose)


class RKS(_MeanField):
    def __init__(self, cell, xc="lda,vwn", exxdiv="ewald", device=None):
        super().__init__(cell, xc=xc, exxdiv=exxdiv, device=device)

    def _kernel(self):
        return _hf.scf_kernel(self.system, xc=self.xc, exxdiv=self.exxdiv,
                              conv_tol=self.conv_tol, max_cycle=self.max_cycle,
                              df=self.df, isdf_c=self.isdf_c,
                              isdf_precision=self.isdf_precision,
                              sigma=self.sigma,
                              smearing_method=self.smearing_method,
                              xc_grids=self.xc_grids,
                              verbose=self.verbose)


class UHF(_MeanField):
    def __init__(self, cell, exxdiv="ewald", device=None):
        super().__init__(cell, xc=None, exxdiv=exxdiv, device=device)

    def _kernel(self):
        return _uhf.uhf_kernel(self.system, xc=None, exxdiv=self.exxdiv,
                               conv_tol=self.conv_tol,
                               max_cycle=self.max_cycle,
                               df=self.df, isdf_c=self.isdf_c,
                               isdf_precision=self.isdf_precision,
                               verbose=self.verbose)


class UKS(_MeanField):
    def __init__(self, cell, xc="lda,vwn", exxdiv="ewald", device=None):
        super().__init__(cell, xc=xc, exxdiv=exxdiv, device=device)

    def _kernel(self):
        return _uhf.uhf_kernel(self.system, xc=self.xc, exxdiv=self.exxdiv,
                               conv_tol=self.conv_tol,
                               max_cycle=self.max_cycle,
                               df=self.df, isdf_c=self.isdf_c,
                               isdf_precision=self.isdf_precision,
                               xc_grids=self.xc_grids,
                               verbose=self.verbose)


class ROHF(_MeanField):
    def __init__(self, cell, exxdiv="ewald", device=None):
        super().__init__(cell, xc=None, exxdiv=exxdiv, device=device)

    def _kernel(self):
        return _rohf.rohf_kernel(self.system, xc=None, exxdiv=self.exxdiv,
                                 conv_tol=self.conv_tol,
                                 max_cycle=self.max_cycle,
                                 verbose=self.verbose, device=self.device)


class _KMeanField(_MeanField):
    def __init__(self, cell, kpts, xc=None, exxdiv="ewald", symmetry=False,
                 device=None):
        super().__init__(cell, xc=xc, exxdiv=exxdiv, device=device)
        self.kpts = np.reshape(np.asarray(kpts, dtype=np.float64), (-1, 3))
        self.symmetry = symmetry

    def _kernel_ibz(self):
        """IBZ-reduced SCF (space-group and time-reversal symmetry)."""
        from pyscf_isdf_tpu_torch.scf.khf_ksymm import kscf_ibz_kernel

        return kscf_ibz_kernel(self.system, xc=self.xc, exxdiv=self.exxdiv,
                               conv_tol=self.conv_tol,
                               max_cycle=self.max_cycle,
                               df=self.df, isdf_c=self.isdf_c,
                               isdf_precision=self.isdf_precision,
                               sigma=self.sigma,
                               smearing_method=self.smearing_method,
                               verbose=self.verbose, device=self.device)

    @property
    def system(self):
        if self._system is None:
            self._system = _khf.build_kscf_system(
                self.cell, self.kpts, device=self.device,
                ae=(self.df == "aegdf"), ae_omega=self.ae_omega)
        return self._system


class KRHF(_KMeanField):
    def __init__(self, cell, kpts, exxdiv="ewald", symmetry=False, device=None):
        super().__init__(cell, kpts, xc=None, exxdiv=exxdiv,
                         symmetry=symmetry, device=device)

    def _kernel(self):
        if self.symmetry:
            return self._kernel_ibz()
        return _khf.kscf_kernel(self.system, xc=None, exxdiv=self.exxdiv,
                                conv_tol=self.conv_tol,
                                max_cycle=self.max_cycle, sigma=self.sigma,
                                smearing_method=self.smearing_method,
                                df=self.df, isdf_c=self.isdf_c,
                                isdf_precision=self.isdf_precision,
                                verbose=self.verbose, device=self.device)


class KRKS(_KMeanField):
    def __init__(self, cell, kpts, xc="lda,vwn", exxdiv="ewald",
                 symmetry=False, device=None):
        super().__init__(cell, kpts, xc=xc, exxdiv=exxdiv, symmetry=symmetry,
                         device=device)

    def _kernel(self):
        if self.symmetry:
            return self._kernel_ibz()
        return _khf.kscf_kernel(self.system, xc=self.xc, exxdiv=self.exxdiv,
                                conv_tol=self.conv_tol,
                                max_cycle=self.max_cycle, sigma=self.sigma,
                                smearing_method=self.smearing_method,
                                df=self.df, isdf_c=self.isdf_c,
                                isdf_precision=self.isdf_precision,
                                xc_grids=self.xc_grids,
                                verbose=self.verbose, device=self.device)


class KUHF(_KMeanField):
    def __init__(self, cell, kpts, exxdiv="ewald", device=None):
        super().__init__(cell, kpts, xc=None, exxdiv=exxdiv, device=device)

    def _kernel(self):
        from pyscf_isdf_tpu_torch.scf.kuhf import kuhf_kernel

        return kuhf_kernel(self.system, xc=None, exxdiv=self.exxdiv,
                           conv_tol=self.conv_tol, max_cycle=self.max_cycle,
                           df=self.df, isdf_c=self.isdf_c,
                           isdf_precision=self.isdf_precision,
                           verbose=self.verbose, device=self.device)


class KUKS(_KMeanField):
    def __init__(self, cell, kpts, xc="lda,vwn", exxdiv="ewald", device=None):
        super().__init__(cell, kpts, xc=xc, exxdiv=exxdiv, device=device)

    def _kernel(self):
        from pyscf_isdf_tpu_torch.scf.kuhf import kuhf_kernel

        return kuhf_kernel(self.system, xc=self.xc, exxdiv=self.exxdiv,
                           conv_tol=self.conv_tol, max_cycle=self.max_cycle,
                           df=self.df, isdf_c=self.isdf_c,
                           isdf_precision=self.isdf_precision,
                           xc_grids=self.xc_grids,
                           verbose=self.verbose, device=self.device)


class KRKSpU(_KMeanField):
    """KRKS with a Hubbard U correction (reference pbc/dft/krkspu.py).

    ``hubbard``: list of (atom_index_or_symbol, l, U_hartree).
    """

    def __init__(self, cell, kpts, xc="lda,vwn", exxdiv="ewald", hubbard=(),
                 device=None):
        super().__init__(cell, kpts, xc=xc, exxdiv=exxdiv, device=device)
        self.hubbard = list(hubbard)

    def _kernel(self):
        return _khf.kscf_kernel(self.system, xc=self.xc, exxdiv=self.exxdiv,
                                conv_tol=self.conv_tol,
                                max_cycle=self.max_cycle, sigma=self.sigma,
                                smearing_method=self.smearing_method,
                                df=self.df, isdf_c=self.isdf_c,
                                isdf_precision=self.isdf_precision,
                                hubbard=self.hubbard,
                                xc_grids=self.xc_grids,
                                verbose=self.verbose, device=self.device)


class KROHF(_KMeanField):
    def __init__(self, cell, kpts, exxdiv="ewald", device=None):
        super().__init__(cell, kpts, xc=None, exxdiv=exxdiv, device=device)

    def _kernel(self):
        from pyscf_isdf_tpu_torch.scf.krohf import krohf_kernel

        return krohf_kernel(self.system, xc=None, exxdiv=self.exxdiv,
                            conv_tol=self.conv_tol,
                            max_cycle=self.max_cycle,
                            df=self.df, isdf_c=self.isdf_c,
                            isdf_precision=self.isdf_precision,
                            verbose=self.verbose, device=self.device)


class KGHF(_KMeanField):
    """k-point generalized (2-component spinor) HF, reference
    pyscf/pbc/scf/kghf.py. ``density_fit('isdf')`` factorizes the
    spinor-block exchange through the same per-q ISDF W as KRHF (the
    contraction is complex-linear in the density, so the non-Hermitian
    spin-off-diagonal blocks are served as the Hermitian ones are)."""

    def __init__(self, cell, kpts, exxdiv="ewald", device=None):
        super().__init__(cell, kpts, xc=None, exxdiv=exxdiv, device=device)

    def _kernel(self):
        from pyscf_isdf_tpu_torch.scf.kghf import kghf_kernel

        return kghf_kernel(self.system, exxdiv=self.exxdiv,
                           conv_tol=self.conv_tol,
                           max_cycle=self.max_cycle,
                           df=self.df, isdf_c=self.isdf_c,
                           verbose=self.verbose, device=self.device)


def GW(mf, nw: int = 100, orbs=None, linearized: bool = False,
       fc: bool = False, method: str = "ac"):
    """G0W0 quasiparticle energies on a converged (K)RHF/(K)RKS/UHF/UKS
    object, the reference's gw.GW(mf) / krgw_ac.KRGWAC(mf) / ugw_ac.

    ``method``: 'ac' (imaginary axis and Pade, the frontier-state path) or
    'cd' (contour deformation, reference gw_cd.py/krgw_cd.py, reliable for
    deep core levels).

    Returns a GWResult (Gamma), KGWResult (k-point, optional ``fc``
    head/wing finite-size correction) or UGWResult (spin-polarized) with
    ``.qp_energy``."""
    from pyscf_isdf_tpu_torch.gw import (gw_ac_gamma, kgw_ac, kugw_ac,
                                         ugw_ac_gamma)

    dev = mf.device
    if method == "cd":
        if isinstance(mf, (KUHF, KUKS)):
            raise NotImplementedError(
                "k-point spin-polarized GW-CD: use Gamma ugw_cd or "
                "method='ac' (kugw_ac)")
        if isinstance(mf, (UHF, UKS)):
            from pyscf_isdf_tpu_torch.gw.gw_cd import ugw_cd_gamma

            return ugw_cd_gamma(mf.system, mf._res, xc=mf.xc, nw=nw,
                                orbs=orbs, device=dev)
        if isinstance(mf, _KMeanField):
            from pyscf_isdf_tpu_torch.gw.gw_cd import kgw_cd

            return kgw_cd(mf.system, mf._res, xc=mf.xc, nw=nw, orbs=orbs,
                          device=dev)
        from pyscf_isdf_tpu_torch.gw.gw_cd import gw_cd_gamma

        return gw_cd_gamma(mf.system, mf._res, xc=mf.xc, nw=nw, orbs=orbs,
                           device=dev)
    if method != "ac":
        raise ValueError(f"unknown GW method {method!r}: 'ac' or 'cd'")

    # the spin classes first: KUHF/KUKS are _KMeanField subclasses and
    # must reach the spin engines
    if isinstance(mf, (KUHF, KUKS)):
        if fc or linearized:
            raise NotImplementedError(
                "kugw_ac supports neither fc nor linearized")
        return kugw_ac(mf.system, mf._res, xc=mf.xc, nw=nw, orbs=orbs,
                       device=dev)
    if isinstance(mf, _KMeanField):
        return kgw_ac(mf.system, mf._res, xc=mf.xc, nw=nw, orbs=orbs,
                      linearized=linearized, fc=fc, device=dev)
    if isinstance(mf, (UHF, UKS)):
        return ugw_ac_gamma(mf.system, mf._res, xc=mf.xc, nw=nw, orbs=orbs,
                            device=dev)
    return gw_ac_gamma(mf.system, mf._res, xc=mf.xc, nw=nw, orbs=orbs,
                       linearized=linearized, device=dev)


def RPA(mf, nw: int = 100):
    """Direct-RPA correlation energy on a converged mean field (reference
    pyscf/gw/rpa.py). Returns (e_corr, e_tot), per unit cell for k-point
    objects."""
    from pyscf_isdf_tpu_torch.gw import rpa_ecorr_gamma, rpa_ecorr_kpts
    from pyscf_isdf_tpu_torch.gw.ugw import kurpa_ecorr, urpa_ecorr_gamma

    dev = mf.device
    if isinstance(mf, (KUHF, KUKS)):
        ec = kurpa_ecorr(mf.system, mf._res, nw=nw, device=dev)
    elif isinstance(mf, (UHF, UKS)):
        ec = urpa_ecorr_gamma(mf.system, mf._res, nw=nw, device=dev)
    elif isinstance(mf, _KMeanField):
        ec = rpa_ecorr_kpts(mf.system, mf._res, nw=nw, device=dev)
    else:
        ec = rpa_ecorr_gamma(mf.system, mf._res, nw=nw, device=dev)
    return ec, mf._res["e_tot"] + ec


def MP2(mf: _MeanField):
    """Gamma-point MP2 on a converged RHF object; returns (e_corr, e_tot)."""
    from pyscf_isdf_tpu_torch.mp import mp2_energy

    e_corr = mp2_energy(mf.system, mf._res, device=mf.device)
    return e_corr, mf._res["e_tot"] + e_corr


def KMP2(mf: _KMeanField):
    """k-point MP2 on a converged KRHF object; returns (e_corr, e_tot)."""
    from pyscf_isdf_tpu_torch.mp.kmp2 import kmp2_energy

    e_corr = kmp2_energy(mf.system, mf._res, device=mf.device)
    return e_corr, mf._res["e_tot"] + e_corr


def CCSD(mf: _MeanField, with_t: bool = False, conv_tol: float = 1e-9):
    """Gamma-point CCSD (optionally +(T)) on a converged mean field; returns
    (e_corr, e_tot), the reference's cc.CCSD(mf). A UHF/UKS reference
    (tuple mo_coeff) goes to the spin-unrestricted UCCSD (reference
    cc.UCCSD, pyscf/cc/uccsd.py)."""
    if isinstance(mf._res["mo_coeff"], tuple):
        from pyscf_isdf_tpu_torch.cc.gccsd import uccsd as _ccsd
    else:
        from pyscf_isdf_tpu_torch.cc.gccsd import ccsd as _ccsd

    out = _ccsd(mf.system, mf._res, with_t=with_t, conv_tol=conv_tol,
                device=mf.device)
    if not out["converged"]:
        raise RuntimeError("CCSD did not converge")
    e_corr = out["e_corr"] + out.get("e_t", 0.0)
    return e_corr, mf._res["e_tot"] + e_corr


def KCCSD(mf: _KMeanField, with_t: bool = False, conv_tol: float = 1e-9,
          tier: str = "auto"):
    """k-point CCSD per unit cell on a converged k mean field; returns
    (e_corr, e_tot), the reference's pbc.cc.KCCSD(mf).

    tier: 'spatial' (closed-shell blocked, cc/krccsd.py), 'blocked'
    (spin-orbital momentum-blocked), 'composite' (the dense oracle), or
    'auto': spatial when the reference is closed-shell with the same
    occupation at every k (and (T) is not asked for), else composite. A
    KUHF/KUKS reference (tuple mo_coeff) goes to KUCCSD (reference
    pbc.cc.kccsd_uhf) whatever the tier.
    """
    dev = mf.device
    if isinstance(mf._res["mo_coeff"], tuple):
        if with_t:
            # (T) rides the composite dense tier, the cost class of the
            # restricted KCCSD(T)
            from pyscf_isdf_tpu_torch.cc.kccsd import kuccsd

            out = kuccsd(mf.system, mf._res, with_t=True, conv_tol=conv_tol,
                         device=dev)
            if not out["converged"]:
                raise RuntimeError("KUCCSD did not converge")
            return (out["e_corr"] + out["e_t"],
                    mf._res["e_tot"] + out["e_corr"] + out["e_t"])
        from pyscf_isdf_tpu_torch.cc.kccsd_blocked import kuccsd_blocked

        out = kuccsd_blocked(mf.system, mf._res, conv_tol=conv_tol, device=dev)
        if not out["converged"]:
            raise RuntimeError("KUCCSD did not converge")
        return out["e_corr"], mf._res["e_tot"] + out["e_corr"]
    if tier == "auto":
        occ = mf._res.get("mo_occ")
        occ = None if occ is None else np.asarray(occ)
        uniform = (occ is not None and occ.ndim == 2
                   and bool(np.all((occ > 0.5).sum(1) == (occ > 0.5).sum(1)[0])))
        tier = "spatial" if (uniform and not with_t) else "composite"
    if tier == "spatial":
        from pyscf_isdf_tpu_torch.cc.krccsd import krccsd

        out = krccsd(mf.system, mf._res, conv_tol=conv_tol, device=dev)
    elif tier == "blocked":
        from pyscf_isdf_tpu_torch.cc.kccsd_blocked import kccsd_blocked

        out = kccsd_blocked(mf.system, mf._res, conv_tol=conv_tol, device=dev)
    else:
        from pyscf_isdf_tpu_torch.cc.kccsd import kccsd

        out = kccsd(mf.system, mf._res, with_t=with_t, conv_tol=conv_tol,
                    device=dev)
    if not out["converged"]:
        raise RuntimeError("KCCSD did not converge")
    e_corr = out["e_corr"] + out.get("e_t", 0.0)
    return e_corr, mf._res["e_tot"] + e_corr


def EOMCCSD(mf: _MeanField, sector: str = "ee", nroots: int = 6,
            conv_tol: float = 1e-10):
    """EOM-CCSD excitation energies, IPs or EAs (sector 'ee'|'ip'|'ea') on a
    converged Gamma mean field (the determinant-space path of cc/eom.py,
    for small systems). Run the mean field with exxdiv=None so the
    amplitude and determinant Hamiltonians share one partition (the ewald
    probe shift moves the occupied levels)."""
    from pyscf_isdf_tpu_torch.cc.eom import eom_from_scf
    from pyscf_isdf_tpu_torch.cc.gccsd import ccsd

    out = ccsd(mf.system, mf._res, conv_tol=conv_tol, device=mf.device)
    if not out["converged"]:
        raise RuntimeError("CCSD did not converge")
    return eom_from_scf(mf.system, mf._res, out, sector=sector, nroots=nroots,
                        device=mf.device)


def KEOMCCSD(mf: _KMeanField, sector: str = "ee", nroots: int = 4,
             conv_tol: float = 1e-10, target=None,
             return_weights: bool = False):
    """EOM-KCCSD on a converged k-point mean field (reference
    pbc/cc/eom_kccsd_rhf.py EOMIP/EOMEA/EOMEE).

    Solves the supercell problem on the composite momentum-blocked
    spin-orbital integrals (cc/kccsd.py): EE through the Jacobian of the
    CCSD residual, IP/EA through its continuum-orbital subblock
    (cc/eom.py), at polynomial cost. The values are energy differences
    (excitation energies, E(N-1)-E(N) and E(N+1)-E(N)), so the supercell
    normalization drops out. ``target`` turns on shift-invert targeting of
    interior roots (ip/ea); ``return_weights`` adds the pole strengths and
    the orbital-resolved 1h/1p amplitudes. Run the mean field with
    exxdiv=None so the amplitude and sigma Hamiltonians share one
    partition.
    """
    from pyscf_isdf_tpu_torch.cc.eom import (eom_ee_energies,
                                             eom_ip_ea_energies)
    from pyscf_isdf_tpu_torch.cc.kccsd import build_composite_eris, kccsd

    out = kccsd(mf.system, mf._res, conv_tol=conv_tol, device=mf.device)
    if not out["converged"]:
        raise RuntimeError("KCCSD did not converge")
    f_so, eri_so, no_so = build_composite_eris(mf.system, mf._res,
                                               device=mf.device)
    if sector == "ee":
        return eom_ee_energies(f_so, eri_so, out["t1"], out["t2"], no_so,
                               nroots=nroots)
    if sector not in ("ip", "ea"):
        raise ValueError(f"sector {sector!r}: one of 'ee'|'ip'|'ea'")
    return eom_ip_ea_energies(f_so, eri_so, out["t1"], out["t2"], no_so,
                              sector=sector, nroots=nroots, target=target,
                              return_weights=return_weights)


def KMP2_stagger(mf: _KMeanField, flag_submesh: bool = False):
    """Staggered-mesh k-point MP2 (reference pyscf/pbc/mp/kmp2_stagger.py)
    on a converged KRHF object; returns (e_corr, e_tot)."""
    from pyscf_isdf_tpu_torch.mp.kmp2_stagger import kmp2_stagger_energy

    e_corr = kmp2_stagger_energy(mf.system, mf._res, flag_submesh=flag_submesh,
                                 xc=mf.xc, device=mf.device)
    return e_corr, mf._res["e_tot"] + e_corr


def _isdfk_for_exchange(mf):
    """k-ISDF factors for the exact-exchange response, when the ground state
    has exchange (HF, or a hybrid functional)."""
    from pyscf_isdf_tpu_torch.ops.xc import XCSpec

    hyb = 1.0 if mf.xc is None else XCSpec(mf.xc).hyb
    if hyb <= 0:
        return None
    from pyscf_isdf_tpu_torch.df import isdf_k

    return isdf_k.build_isdf_k(mf.cell, mf.system.aoR_k, mf.system.kpts,
                               c=mf.isdf_c)


def _dedup_realified(e, tol=1e-7):
    """Collapse the realification partners: each group of roots equal
    within ``tol`` came from pairs (one complex root, two real roots), so a
    group of size g holds ceil(g/2) physical states (odd g: a pair cut by
    the nstates truncation)."""
    e = np.sort(np.asarray(e))
    out = []
    i = 0
    while i < len(e):
        j = i + 1
        while j < len(e) and e[j] - e[i] <= tol * max(1.0, abs(e[i])):
            j += 1
        g = j - i
        out.extend(e[i:i + (g + 1) // 2])
        i = j
    return np.asarray(out)


def TDA(mf, nstates=5, singlet=True):
    """Excitation energies (Hartree): dense TDA for Gamma mean fields,
    Davidson k-TDA (ISDF exchange response) for k-point ones, the
    reference's mf.TDA()."""
    if isinstance(mf, _KMeanField):
        from pyscf_isdf_tpu_torch.tdscf.ktda import ktda_davidson

        e, _ = ktda_davidson(mf.system, mf._res, xc=mf.xc,
                             nstates=2 * nstates, singlet=singlet,
                             isdfk=_isdfk_for_exchange(mf))
        # the realified Davidson returns every root twice (a complex
        # eigenpair is a real 2x2 block): halve each near-degenerate group
        # so that physical degeneracies keep their multiplicity
        return _dedup_realified(np.asarray(e))[:nstates]
    from pyscf_isdf_tpu_torch.tdscf import tda_kernel

    e, _ = tda_kernel(mf.system, mf._res, xc=mf.xc, nstates=nstates,
                      singlet=singlet)
    return np.asarray(e)


def TDDFT(mf, nstates=5, singlet=True):
    """Full linear-response (Casida/RPA) excitation energies: dense at
    Gamma, the paired-response solver at k (the reference's mf.TDDFT())."""
    if isinstance(mf, _KMeanField):
        from pyscf_isdf_tpu_torch.tdscf.ktda import ktddft_kernel

        return np.asarray(ktddft_kernel(mf.system, mf._res, xc=mf.xc,
                                        nstates=nstates, singlet=singlet,
                                        isdfk=_isdfk_for_exchange(mf)))
    from pyscf_isdf_tpu_torch.tdscf import tddft_kernel

    return np.asarray(tddft_kernel(mf.system, mf._res, xc=mf.xc,
                                   nstates=nstates, singlet=singlet))


def Gradients(mf: _MeanField):
    """Nuclear gradients dE/dR (natm, 3) of a converged mean field by
    autograd (grad/), the reference's mf.nuc_grad_method(): restricted and
    unrestricted, Gamma and k-point."""
    kw = dict(xc=mf.xc, exxdiv=mf.exxdiv, device=mf.device)
    if isinstance(mf, (UHF, UKS)):
        from pyscf_isdf_tpu_torch.grad.uhf import uhf_gradient

        return uhf_gradient(mf.system, mf._res, **kw)
    if isinstance(mf, ROHF):
        from pyscf_isdf_tpu_torch.grad.uhf import rohf_gradient

        return rohf_gradient(mf.system, mf._res, **kw)
    if isinstance(mf, (KUHF, KUKS)):
        from pyscf_isdf_tpu_torch.grad.kuhf import kuhf_gradient

        return kuhf_gradient(mf.system, mf._res, **kw)
    if isinstance(mf, (KRHF, KRKS)):
        from pyscf_isdf_tpu_torch.grad.khf import krhf_gradient

        return krhf_gradient(mf.system, mf._res, **kw)
    if isinstance(mf, _KMeanField):
        raise NotImplementedError("gradients: only KRHF/KRKS/KUHF/KUKS at k")
    from pyscf_isdf_tpu_torch.grad import rhf_gradient

    return rhf_gradient(mf.system, mf._res, **kw)


def Stress(mf: _MeanField):
    """Stress tensor sigma = (1/vol) dE/d eps (3x3, Ha/Bohr^3) by strain
    autograd; the reference has no counterpart. Gamma (grad/stress.py) and
    k-point (grad/kstress.py)."""
    kw = dict(xc=mf.xc, exxdiv=mf.exxdiv, device=mf.device)
    if isinstance(mf, (KRHF, KRKS)):
        from pyscf_isdf_tpu_torch.grad.kstress import kstress_tensor

        return kstress_tensor(mf.system, mf._res, **kw)
    if isinstance(mf, _KMeanField):
        raise NotImplementedError("stress: only KRHF/KRKS at k")
    if isinstance(mf, ROHF):
        from pyscf_isdf_tpu_torch.grad.stress import rostress_tensor

        return rostress_tensor(mf.system, mf._res, **kw)
    if isinstance(mf, (UHF, UKS)):
        from pyscf_isdf_tpu_torch.grad.stress import ustress_tensor

        return ustress_tensor(mf.system, mf._res, **kw)
    from pyscf_isdf_tpu_torch.grad.stress import stress_tensor

    return stress_tensor(mf.system, mf._res, **kw)

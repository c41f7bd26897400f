"""Coulomb kernel on the G mesh, the Ewald sum and the Madelung constant.

Host-side float64 builders for per-geometry constants:

  * :func:`get_coulG` — 4 pi / |k+G|^2 with wrap-around of high-frequency
    k+G, the G=0 conventions, the Ewald probe-charge ('ewald'),
    spherical-cutoff ('vcut_sph') and Wigner-Seitz ('vcut_ws')
    exchange-divergence corrections (reference semantics:
    pyscf/pbc/tools/pbc.py:230-480), and the truncated kernels of
    isolated (dimension 0), wire (1) and slab (2) cells,
  * :func:`ewald` — real+reciprocal Ewald sum for the nuclear repulsion
    (reference: pyscf/pbc/gto/cell.py:648-800), the slab and wire sums,
    and the bare Coulomb sum of an isolated cell,
  * :func:`madelung` — probe-charge Madelung constant, = -2 x ewald energy
    of a unit point charge in the (k-mesh-scaled) cell
    (reference: pyscf/pbc/tools/pbc.py:483-512),
  * :func:`madelung_omega` — the same under the long-range erf(w r)/r
    kernel (range-separated exchange).
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.special import erf, erfc

from pyscf_isdf_tpu_torch import lattice
from pyscf_isdf_tpu_torch.cell import _estimate_rcut


def get_coulG(cell, k=None, exxdiv=None, mesh=None, Gv=None, kpts=None,
              omega=None) -> np.ndarray:
    """Coulomb kernel 4 pi/|k+G|^2 for all G on the mesh (float64, host).

    Args:
        k: momentum transfer (3,): zero or None for J builds, k_j - k_i
            for exchange.
        exxdiv: None | 'ewald' | 'vcut_sph' | 'vcut_ws' — G=0 divergence
            treatment for exchange matrix elements.
        kpts: the full k-point set; 'ewald' scales the probe-charge shift
            by its size Nk, 'vcut_sph' truncates at the radius Rc of the
            sphere of Nk cells' volume (the SCF k-mesh, also when ``k``
            is a band k-point's transfer), and 'vcut_ws' truncates at the
            Wigner-Seitz cell of the Nk-scaled cell
            (:func:`precompute_exx`).
        omega: range separation: > 0 the long-range erf(w r)/r kernel,
            < 0 the short-range erfc(|w| r)/r kernel.

    At a k-point, k+G beyond the FFT box is folded back into it along the
    periodic axes, so Gamma and k-point calculations agree. Cells of
    dimension 0, 1 and 2 take the truncated kernels: a sphere of radius
    half the shortest cell height (isolated), a cylinder around the first
    axis (wire, :func:`_coulG_cyl1d`) and a slab of half the third
    axis's height (Sundararaman-Arias).
    """
    k = np.zeros(3) if k is None else np.asarray(k, dtype=np.float64)
    kpts = k.reshape(1, 3) if kpts is None else np.reshape(kpts, (-1, 3))
    at_k = np.abs(k).sum() > 1e-9
    mesh = mesh or cell.mesh
    if Gv is None:
        Gv = cell.get_Gv(mesh)

    kG = Gv + k if at_k else Gv
    equal2boundary = None
    if at_k:
        kG = kG.copy()
        equal2boundary = np.zeros(Gv.shape[0], dtype=bool)
        b = cell.reciprocal_vectors()
        box_edge = (np.asarray(mesh) // 2 + 0.5)[:, None] * b
        reduced = np.linalg.solve(box_edge.T, kG.T).T.round(9)
        on_edge = reduced.astype(int)
        for i in range(cell.dimension):
            equal2boundary |= reduced[:, i] == 1
            equal2boundary |= reduced[:, i] == -1
            kG[on_edge[:, i] == 1] -= 2 * box_edge[i]
            kG[on_edge[:, i] == -1] += 2 * box_edge[i]

    absG2 = np.einsum("gi,gi->g", kG, kG)
    G0_idx = absG2 == 0

    def probe_shift(coulG):
        if exxdiv == "ewald" and G0_idx.any():
            coulG[G0_idx] += len(kpts) * cell.vol * madelung(cell, kpts)

    if exxdiv == "vcut_sph":
        Rc = (3 * len(kpts) * cell.vol / (4 * np.pi)) ** (1.0 / 3)
        with np.errstate(divide="ignore", invalid="ignore"):
            coulG = 4 * np.pi / absG2 * (1.0 - np.cos(np.sqrt(absG2) * Rc))
        coulG[G0_idx] = 4 * np.pi * 0.5 * Rc**2
    elif exxdiv == "vcut_ws":
        ws = precompute_exx(cell, kpts)
        alpha = ws["alpha"]
        with np.errstate(divide="ignore", invalid="ignore"):
            coulG = 4 * np.pi / absG2 * (1.0 - np.exp(-absG2 / (4 * alpha**2)))
        coulG[G0_idx] = np.pi / alpha**2
        # index k+G into the precomputed q-grid kernel
        gxyz = np.rint(kG @ ws["kcell_a"].T / (2 * np.pi)).astype(int)
        wmesh = ws["mesh"]
        gxyz = (gxyz + wmesh) % wmesh
        qidx = (gxyz[:, 0] * wmesh[1] + gxyz[:, 1]) * wmesh[2] + gxyz[:, 2]
        in_range = (np.abs(kG) <= np.abs(ws["q"]).max(axis=0)).all(axis=1)
        coulG[in_range] += ws["vq"][qidx[in_range]]
    elif cell.dimension == 0:
        # isolated system: spherically truncated Coulomb on the FFT mesh,
        # exact when the density fits in a sphere of radius Rc = half the
        # shortest cell height
        Rc = np.pi / np.linalg.norm(cell.reciprocal_vectors(), axis=1).max()
        with np.errstate(divide="ignore", invalid="ignore"):
            coulG = 4 * np.pi / absG2 * (1.0 - np.cos(np.sqrt(absG2) * Rc))
        coulG[G0_idx] = 2 * np.pi * Rc**2
    elif cell.dimension == 1:
        # cylindrically truncated Coulomb for a wire periodic along a1
        # (Rozzi et al. PRB 73, 205119 (2006))
        coulG = _coulG_cyl1d(cell, kG)
        probe_shift(coulG)
    elif cell.dimension == 2:
        # truncated Coulomb for a slab: Sundararaman-Arias PRB 87 (2013)
        Ld2 = np.pi / np.linalg.norm(cell.reciprocal_vectors()[2])
        wfac = 1.0 - np.cos(kG[:, 2] * Ld2) \
            * np.exp(-np.linalg.norm(kG[:, :2], axis=1) * Ld2)
        with np.errstate(divide="ignore", invalid="ignore"):
            coulG = wfac * 4 * np.pi / absG2
        coulG[G0_idx] = -2 * np.pi * Ld2**2
        probe_shift(coulG)
    else:
        with np.errstate(divide="ignore"):
            coulG = 4 * np.pi / absG2
        coulG[G0_idx] = 0
        probe_shift(coulG)
    if equal2boundary is not None:
        coulG[equal2boundary] = 0
    if omega:
        if omega > 0:
            coulG *= np.exp(-0.25 / omega**2 * absG2)
        else:
            coulG *= 1 - np.exp(-0.25 / omega**2 * absG2)
            # the short-range kernel is finite at G=0:
            # lim 4pi/G^2 (1 - e^{-G^2/4w^2}) = pi/w^2, so short-range
            # exchange needs no probe-charge correction
            if exxdiv is None and cell.dimension == 3:
                coulG[absG2 < 1e-12] = np.pi / omega**2
    return coulG


def _cyl_radius(cell) -> float:
    """Cylinder radius of the wire kernel: half the transverse extent
    (Rozzi convention; exact when the density fits the cylinder)."""
    return float(np.sqrt(cell.vol / np.linalg.norm(cell.a[0])) / 2)


def _coulG_cyl1d(cell, kG) -> np.ndarray:
    """Fourier coefficients of the cylindrically truncated Coulomb kernel
    (periodic along a1 = x), Rozzi PRB 73, 205119 (2006):

      Gx != 0:  (4 pi/G^2) [1 + Gp Rc J1(Gp Rc) K0(|Gx| Rc)
                              - |Gx| Rc J0(Gp Rc) K1(|Gx| Rc)]
      Gx == 0, Gp != 0:  -4 pi int_0^Rc r J0(Gp r) ln(r) dr  (quadrature)
      G == 0:           -pi Rc^2 (2 ln Rc - 1)
    """
    from scipy.special import j0, j1, k0, k1

    Rc = _cyl_radius(cell)
    Gx = np.abs(kG[:, 0])
    Gp = np.linalg.norm(kG[:, 1:], axis=1)
    G2 = np.einsum("gi,gi->g", kG, kG)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = (1.0 + Gp * Rc * j1(Gp * Rc) * k0(Gx * Rc)
             - Gx * Rc * j0(Gp * Rc) * k1(Gx * Rc))
        coulG = 4 * np.pi / np.where(G2 < 1e-12, np.inf, G2) * w
    line = (Gx < 1e-12) & (Gp > 1e-12)
    if line.any():
        x, wq = np.polynomial.legendre.leggauss(256)
        r = 0.5 * Rc * (x + 1.0)
        wr = 0.5 * Rc * wq
        coulG[line] = -4 * np.pi * ((wr * r * np.log(r))
                                    @ j0(np.outer(r, Gp[line])))
    coulG[G2 < 1e-12] = -np.pi * Rc**2 * (2 * np.log(Rc) - 1.0)
    return coulG


def precompute_exx(cell, kpts):
    """Wigner-Seitz truncated exchange kernel of ``exxdiv='vcut_ws'``: the
    minimum-image erf potential of the Nk-scaled cell sampled on a fine
    grid and Fourier transformed to vq (reference:
    pyscf/pbc/tools/pbc.py:422-480, PRB 87, 165122)."""
    Nk = monkhorst_pack_size(cell, np.reshape(kpts, (-1, 3)))
    ka = cell.a * Nk[:, None]
    Lc = 1.0 / np.linalg.norm(np.linalg.inv(ka), axis=0)
    alpha = 5.0 / (Lc.min() / 2.0)
    mesh = np.array([4 * int(L * alpha * 3.0) for L in Lc])
    rs = lattice.uniform_grid(ka, mesh, wrap_around=False)
    corners = lattice.cartesian_prod([0, 1], [0, 1], [0, 1]) @ ka
    r = np.min([np.linalg.norm(rs - c, axis=1) for c in corners], axis=0)
    vR = erf(alpha * r) / (r + 1e-200)
    vR[r < 1e-9] = 2 * alpha / np.sqrt(np.pi)
    vG = (abs(np.linalg.det(ka)) / len(rs)) * np.fft.fftn(vR.reshape(mesh)).ravel()
    if abs(vG.imag).max() > 1e-6:
        raise RuntimeError("vcut_ws: unconventional lattice")
    return {"alpha": alpha, "kcell_a": ka, "mesh": mesh,
            "q": lattice.get_Gv(ka, mesh), "vq": vG.real.copy()}


def ewald_params(cell, precision=None):
    """Gaussian-charge width eta and real-space cutoff for the Ewald sum."""
    precision = precision or cell.precision
    if cell.dimension == 2:
        ew_cut = cell.a[2, 2] / 2
        log_precision = np.log(precision / (max(np.abs(cell.charges).sum(), 1.0)
                                            * 16 * np.pi**2))
        return (-log_precision) ** 0.5 / ew_cut, ew_cut
    ew_eta = 1.0 / cell.vol ** (1.0 / 6)
    if cell.dimension == 1:
        # the G-space term smears charges against the truncated kernel, so
        # the Ewald identity holds to O(exp(-(eta Rc)^2)) only: keep the
        # Gaussians well inside the cylinder
        ew_eta = max(ew_eta, 6.0 / _cyl_radius(cell))
    return ew_eta, _estimate_rcut(ew_eta**2, 0, 1.0, precision)


def ewald(cell, ew_eta=None, ew_cut=None) -> float:
    """Nuclear repulsion: the Ewald sum (3-D, slab, wire) or the bare
    Coulomb sum (isolated cell)."""
    if cell.natm == 0:
        return 0.0
    chargs = cell.charges
    coords = cell.coords
    if cell.dimension == 0:
        rij = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
        np.fill_diagonal(rij, np.inf)
        return float(0.5 * np.einsum("i,j,ij->", chargs, chargs, 1.0 / rij))
    if ew_eta is None or ew_cut is None:
        ew_eta, ew_cut = ewald_params(cell)

    Lall = lattice.lattice_images(cell.a, ew_cut, cell.dimension)
    rLij = coords[:, None, :] - coords[None, :, :] + Lall[:, None, None, :]
    r = np.sqrt(np.einsum("Lijx,Lijx->Lij", rLij, rLij))
    r[r < 1e-16] = 1e200
    ewovrl = 0.5 * np.einsum("i,j,Lij->", chargs, chargs, erfc(ew_eta * r) / r)

    ewself = -0.5 * np.dot(chargs, chargs) * 2 * ew_eta / np.sqrt(np.pi)
    if cell.dimension == 3:
        ewself += -0.5 * np.sum(chargs) ** 2 * np.pi / (ew_eta**2 * cell.vol)

    log_precision = np.log(cell.precision / (max(np.abs(chargs).sum(), 1.0) * 16 * np.pi**2))
    ke_cutoff = -2 * ew_eta**2 * log_precision
    mesh = lattice.cutoff_to_mesh(cell.a, ke_cutoff)
    Gv = lattice.get_Gv(cell.a, mesh)
    absG2_raw = np.einsum("gi,gi->g", Gv, Gv)
    absG2 = np.where(absG2_raw == 0, 1e200, absG2_raw)

    if cell.dimension == 3:
        # 1/2 sum_{G!=0} |ZS(G)|^2 4pi/G^2 e^{-G^2/4eta^2} / vol
        coulG = 4 * np.pi / absG2 / cell.vol
        ZSI = np.einsum("i,ij->j", chargs, lattice.get_SI(cell.a, coords, Gv=Gv))
        ZexpG2 = ZSI * np.exp(-absG2 / (4 * ew_eta**2))
        ewg = 0.5 * np.einsum("i,i,i", ZSI.conj(), ZexpG2, coulG).real
    elif cell.dimension == 2:
        ewg = _ewald_slab_reciprocal(cell, chargs, coords, ew_eta, Gv, absG2)
    else:
        # Gaussian-smeared charges against the cylindrical kernel on the G
        # mesh (finite at G=0: the sum includes it, with no background)
        ZSI = np.einsum("i,ij->j", chargs, lattice.get_SI(cell.a, coords, Gv=Gv))
        ZexpG2 = ZSI * np.exp(-absG2_raw / (4 * ew_eta**2))
        ewg = 0.5 * np.einsum("i,i,i", ZSI.conj(), ZexpG2,
                              _coulG_cyl1d(cell, Gv)).real / cell.vol
    return float(ewovrl + ewself + ewg)


def _ewald_slab_reciprocal(cell, chargs, coords, ew_eta, Gv, absG2):
    """In-plane reciprocal Ewald sum of a slab (Sundararaman-Arias PRB 87
    (2013)); ``absG2`` has G=0 set to 1e200."""
    def fn(eta, Gnorm, z):
        Gnorm_z = Gnorm * z
        large = Gnorm_z > 20.0
        x = Gnorm / 2.0 / eta + eta * z
        with np.errstate(over="ignore"):
            erfcx = erfc(x)
            return np.where(large,
                            np.exp(np.where(large, Gnorm_z - x**2, 0.0)) * erfcx,
                            np.exp(np.where(large, 0.0, Gnorm_z)) * erfcx)

    def gn(eta, Gnorm, z):
        return np.pi / Gnorm * (fn(eta, Gnorm, z) + fn(eta, Gnorm, -z))

    def gn0(eta, z):
        return -2 * np.pi * (z * erf(eta * z)
                             + np.exp(-((eta * z) ** 2)) / eta / np.sqrt(np.pi))

    b = lattice.reciprocal_vectors(cell.a)
    inv_area = np.linalg.norm(np.cross(b[0], b[1])) / (2 * np.pi) ** 2
    Gp = Gv[np.logical_and(Gv[:, 2] == 0, absG2 < 1e199)]
    absG = np.sqrt(np.einsum("gi,gi->g", Gp, Gp))
    rij = coords[:, None, :] - coords[None, :, :]
    Gdotr = np.einsum("ijx,gx->ijg", rij, Gp)
    ewg = np.einsum("i,j,ijg,ijg->", chargs, chargs, np.cos(Gdotr),
                    gn(ew_eta, absG, rij[:, :, 2:3]))
    ewg += np.einsum("i,j,ij->", chargs, chargs, gn0(ew_eta, rij[:, :, 2]))
    return ewg * inv_area * 0.5


def madelung(cell, kpts=None) -> float:
    """Probe-charge Madelung constant for the exchange G=0 correction: the
    cell scaled by the Monkhorst-Pack size of ``kpts`` (the cell itself at
    Gamma)."""
    if kpts is None:
        Nk = np.ones(3, dtype=int)
    else:
        Nk = monkhorst_pack_size(cell, np.reshape(kpts, (-1, 3)))
    scaled = dataclasses.replace(cell.madelung_cell(), a=cell.a * Nk[:, None])
    return -2.0 * ewald(scaled)


def madelung_omega(cell, kpts, omega: float) -> float:
    """Probe-charge Madelung constant under the long-range erf(w r)/r
    kernel: the self-interaction of one probe charge in the Nk-scaled
    supercell (reference semantics: pyscf/pbc/tools/pbc.py:492-512),

        M_w = 2 w / sqrt(pi) - (1/vol) sum_{G != 0} 4 pi/G^2 e^{-G^2/4w^2},

    on the mesh of the precision-driven cutoff of the reference formula.
    """
    omega = abs(float(omega))
    if kpts is None:
        Nk = np.ones(3, dtype=int)
    else:
        Nk = monkhorst_pack_size(cell, np.reshape(kpts, (-1, 3)))
    a = cell.a * Nk[:, None]
    Ecut = 10.0
    for _ in range(2):
        Ecut = np.log(16 * np.pi**2 / (2 * omega**2 * np.sqrt(2 * Ecut))
                      / cell.precision + 1.0) * 2 * omega**2
    Gv = lattice.get_Gv(a, lattice.cutoff_to_mesh(a, Ecut))
    absG2 = np.einsum("gi,gi->g", Gv, Gv)
    with np.errstate(divide="ignore", invalid="ignore"):
        wcoul = 4 * np.pi / absG2 * np.exp(-0.25 / omega**2 * absG2)
    wcoul[absG2 < 1e-12] = 0.0
    return 2 * omega / np.sqrt(np.pi) - wcoul.sum() / abs(np.linalg.det(a))


def monkhorst_pack_size(cell, kpts, tol=1e-5):
    """Points of the k-mesh along each reciprocal axis."""
    if kpts.shape[0] == 1:
        return np.ones(3, dtype=int)
    tol = max(10 ** (-int(-np.log10(1 / kpts.shape[0])) - 2), tol)
    skpts = kpts @ np.linalg.inv(cell.reciprocal_vectors())
    return np.array(
        [np.count_nonzero(abs(sk[1:] - sk[:-1]) > tol) + 1 for sk in np.sort(skpts.T)]
    )

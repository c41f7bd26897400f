"""Occupation numbers across k-points: integer filling and
finite-temperature (Fermi-Dirac / Gaussian) smearing.

Smearing follows the reference (pyscf/scf/addons.py:60-211 via the PBC
wrapper pyscf/pbc/scf/addons.py:88-216): the chemical potential is set by
charge neutrality over the k-stacked spectrum, and the electronic entropy
is

    fermi:    S = -sum_i [f ln f + (1-f) ln(1-f)]
    gaussian: S = sum_i exp(-((e_i-mu)/sigma)^2) / (2 sqrt(pi))

per spin channel (x2 closed-shell, /nk with k-points). These run on the
host in numpy, on one copy of the eigenvalues a cycle: the bisection is
200 steps over a few hundred levels, which on the device would be 200
dependent launches each waiting on the host for its branch.
"""
from __future__ import annotations

import numpy as np
from scipy.special import erfc


def fermi_occ(mu, mo_energy, sigma):
    """Fermi-Dirac occupations 1 / (exp((e - mu) / sigma) + 1), 0 beyond
    (e - mu) / sigma = 40."""
    occ = np.zeros_like(mo_energy)
    de = (mo_energy - mu) / sigma
    occ[de < 40] = 1.0 / (np.exp(de[de < 40]) + 1.0)
    return occ


def gaussian_occ(mu, mo_energy, sigma):
    """Gaussian-smeared occupations erfc((e - mu) / sigma) / 2."""
    return 0.5 * erfc((mo_energy - mu) / sigma)


def find_mu(f_occ, mo_es, nocc, sigma):
    """Chemical potential with sum(f_occ(mu)) == nocc, by 200 bisection
    steps on [min e - 50 sigma, max e + 50 sigma]."""
    lo = mo_es.min() - 50 * sigma
    hi = mo_es.max() + 50 * sigma
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f_occ(mid, mo_es, sigma).sum() < nocc:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def entropy_of(method, mo_es, occ, mu, sigma):
    """Electronic entropy of one spin channel's occupations ``occ`` (in
    [0, 1]); ``method`` 'fermi', anything else Gaussian."""
    if method == "fermi":
        f = occ[(occ > 0) & (occ < 1)]
        return float(-(f * np.log(f) + (1 - f) * np.log(1 - f)).sum())
    return float(np.exp(-(((mo_es - mu) / sigma) ** 2)).sum()
                 / (2 * np.sqrt(np.pi)))


def smearing_occ_rhf(mo_e_k, nelec_tot, sigma, method="fermi"):
    """Closed-shell k-sampled smeared occupations.

    Args:
        mo_e_k: per-k (nmo,) numpy MO energies (one entry at Gamma).
        nelec_tot: total electrons in the k-sampled supercell.
        sigma: smearing width (Ha).
        method: 'fermi', anything else Gaussian (the reference's test
            spells it 'gauss').

    Returns (per-k occupations in [0, 2], entropy, mu); the entropy is
    already /nk and x2 (closed shell), the reference's reported value.
    """
    f_occ = fermi_occ if method == "fermi" else gaussian_occ
    nk = len(mo_e_k)
    mo_es = np.hstack(mo_e_k)
    nocc = (nelec_tot + 1) // 2
    mu = find_mu(f_occ, mo_es, nocc, sigma)
    occs = f_occ(mu, mo_es, sigma)
    entropy = entropy_of(method, mo_es, occs, mu, sigma) / nk * 2
    occs = occs * 2
    sizes = np.cumsum([0] + [len(e) for e in mo_e_k])
    return ([occs[sizes[i]:sizes[i + 1]] for i in range(nk)], entropy,
            float(mu))


def exact_count_occ(mo_e_k, n_fill, scale=1.0):
    """Integer occupations filling EXACTLY n_fill orbitals globally.

    Reference semantics: pyscf/pbc/scf/khf.py:178-214 get_occ sorts the
    k-stacked spectrum and occupies the lowest slots; a threshold test
    ``e <= fermi + eps`` overfills when the level at the Fermi energy is
    degenerate, so this fills by a global stable argsort instead.

    Args:
        mo_e_k: per-k (nmo_k,) energy arrays (sizes may differ).
        n_fill: number of orbitals to occupy across all k.
        scale: occupation per filled orbital (2.0 closed-shell).

    Returns a list of per-k numpy occupation arrays.
    """
    es = [np.asarray(e) for e in mo_e_k]
    flat = np.hstack(es)
    occ_flat = np.zeros(flat.size)
    occ_flat[np.argsort(flat, kind="stable")[:n_fill]] = scale
    out, i0 = [], 0
    for e in es:
        out.append(occ_flat[i0:i0 + e.size])
        i0 += e.size
    return out


def smearing_occ_ibz(mo_e_k, weights, nelec_tot, sigma, method="fermi"):
    """Closed-shell smeared occupations over a WEIGHTED (IBZ) spectrum.

    The chemical potential solves the weighted charge-neutrality
    condition sum_k w_k * 2 f((e_k - mu)/sigma) == nelec_tot, where
    ``weights`` are the IBZ multiplicities (sum_k w_k == nk of the full
    BZ) — the symmetry-reduced form of smearing_occ_rhf (reference
    pyscf/pbc/scf/addons.py smearing over kpts.weights_ibz).

    Returns (occ list of (nmo,) in [0,2], entropy, mu) with entropy in
    the same per-unit-cell x2 convention as smearing_occ_rhf.
    """
    f_occ = fermi_occ if method == "fermi" else gaussian_occ
    w = np.asarray(weights, dtype=np.float64)
    nk = float(w.sum())
    es = [np.asarray(e, np.float64) for e in mo_e_k]
    mo_es = np.hstack(es)
    w_all = np.hstack([np.full(e.size, wk) for e, wk in zip(es, w)])
    target = nelec_tot / 2.0

    lo = mo_es.min() - 50 * sigma
    hi = mo_es.max() + 50 * sigma
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if (w_all * f_occ(mid, mo_es, sigma)).sum() < target:
            lo = mid
        else:
            hi = mid
    mu = 0.5 * (lo + hi)
    occs = f_occ(mu, mo_es, sigma)
    if method == "fermi":
        f = np.clip(occs, 1e-300, 1 - 1e-16)
        s_orb = -(f * np.log(f) + (1 - f) * np.log1p(-f))
        s_orb[(occs <= 0) | (occs >= 1)] = 0.0
    else:
        s_orb = np.exp(-(((mo_es - mu) / sigma) ** 2)) / (2 * np.sqrt(np.pi))
    entropy = float((w_all * s_orb).sum()) / nk * 2
    occs = occs * 2
    sizes = np.cumsum([0] + [e.size for e in es])
    return ([occs[sizes[i]:sizes[i + 1]] for i in range(len(es))], entropy,
            float(mu))

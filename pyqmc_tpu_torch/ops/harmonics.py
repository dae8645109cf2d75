"""Real solid harmonics as cartesian polynomial tables (numpy only).

Carried over from pyqmc_tpu/ops/harmonics.py, which cannot be imported here
because importing anything under `pyqmc_tpu` imports jax. The tables map
cartesian monomials x^i y^j z^k (i+j+k = l) to sphere-normalised real solid
harmonics:

    Y_lm_solid(r) = sum_cart C_l[cart, m] * x^i y^j z^k.

Conventions match pyscf so that MO coefficients interoperate: cartesian
components in lexicographic order (lx from l down, then ly); m ordered
-l..l, except l = 1, which is ordered (x, y, z). Generation follows the
real-solid-harmonic recursions of Helgaker, Jorgensen & Olsen, Molecular
Electronic-Structure Theory, eqs. 6.4.70-73.
"""

import math
from functools import lru_cache

import numpy as np

LMAX = 6


def cart_components(l):
    """[(lx, ly, lz)] in pyscf order."""
    out = []
    for lx in range(l, -1, -1):
        for ly in range(l - lx, -1, -1):
            out.append((lx, ly, l - lx - ly))
    return out


def ncart(l):
    return (l + 1) * (l + 2) // 2


def _padd(a, b, fb=1.0):
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + fb * v
    return {k: v for k, v in out.items() if v != 0.0}


def _pscale(a, f):
    return {k: f * v for k, v in a.items()}


def _pmul_mono(a, mono):
    di, dj, dk = mono
    return {(i + di, j + dj, k + dk): v for (i, j, k), v in a.items()}


def _pmul_r2(a):
    out = {}
    for m in ((2, 0, 0), (0, 2, 0), (0, 0, 2)):
        out = _padd(out, _pmul_mono(a, m))
    return out


@lru_cache(maxsize=None)
def _solid_harmonics_polys(lmax=LMAX):
    """S[l][m+l] = polynomial dict for the Racah real solid harmonic."""
    S = [[{(0, 0, 0): 1.0}]]
    for l in range(lmax):
        prev = S[l]
        cur = [None] * (2 * (l + 1) + 1)
        f = math.sqrt((2.0 if l == 0 else 1.0) * (2 * l + 1) / (2 * l + 2))
        s_ll = prev[2 * l]  # m = +l
        s_lml = prev[0]  # m = -l
        top = _pmul_mono(s_ll, (1, 0, 0))
        bot = _pmul_mono(s_ll, (0, 1, 0))
        if l > 0:
            top = _padd(top, _pmul_mono(s_lml, (0, 1, 0)), -1.0)
            bot = _padd(bot, _pmul_mono(s_lml, (1, 0, 0)), 1.0)
        cur[2 * (l + 1)] = _pscale(top, f)
        cur[0] = _pscale(bot, f)
        for m in range(-l, l + 1):
            num = _pscale(_pmul_mono(prev[m + l], (0, 0, 1)), 2 * l + 1)
            if l >= 1 and abs(m) <= l - 1:
                num = _padd(num, _pmul_r2(S[l - 1][m + l - 1]),
                            -math.sqrt((l + m) * (l - m)))
            den = math.sqrt((l + 1 + m) * (l + 1 - m))
            cur[m + l + 1] = _pscale(num, 1.0 / den)
        S.append(cur)
    return S


@lru_cache(maxsize=None)
def cart2sph_matrix(l):
    """(ncart_l, 2l+1) matrix: raw monomials -> sphere-normalised solid Y.

    Column order: m = -l..l, except l = 1 -> (x, y, z).
    """
    polys = _solid_harmonics_polys()[l]
    norm = math.sqrt((2 * l + 1) / (4.0 * math.pi))
    comps = cart_components(l)
    index = {c: i for i, c in enumerate(comps)}
    order = [2, 0, 1] if l == 1 else list(range(2 * l + 1))
    C = np.zeros((len(comps), 2 * l + 1))
    for col, mi in enumerate(order):
        for mono, coeff in polys[mi].items():
            C[index[mono], col] = norm * coeff
    return C


def gaussian_radial_norm(l, alpha):
    """N with integral (N r^l e^{-a r^2})^2 r^2 dr = 1 (sphere-normalised Y)."""
    alpha = np.asarray(alpha, dtype=np.float64)
    return np.sqrt(2.0 * (2.0 * alpha) ** (l + 1.5) / math.gamma(l + 1.5))


def normalize_contraction(l, alphas, coeffs):
    """pyscf-style shell normalisation: coefficients times the primitive
    radial norm, rescaled so the contracted radial function has unit norm."""
    alphas = np.asarray(alphas, dtype=np.float64)
    c = np.asarray(coeffs, dtype=np.float64) * gaussian_radial_norm(l, alphas)
    ss = (math.gamma(l + 1.5) / 2.0
          * np.sum(c[:, None] * c[None, :] / (alphas[:, None] + alphas[None, :]) ** (l + 1.5)))
    return c / np.sqrt(ss)

"""Molecular GTO integrals via McMurchie-Davidson recursion (host-side numpy).

A copy of pyqmc_tpu/system/integrals.py (numpy and scipy). The AO order is
the shell table of system/mole.py, which fixes the meaning of every row of
`mo_coeff`.

The reference delegates all of this to PySCF/libcint (pyqmc/pyscftools.py).
This framework is standalone: SCF setup is a one-time host computation, so
plain vectorized numpy is the right tool (the sampling hot path never touches
this module). Supports overlap, kinetic, nuclear attraction and ERIs over
contracted spherical GTOs; adequate for the small molecules used in tests and
benchmarks.
"""

from __future__ import annotations

import numpy as np
from scipy.special import gammainc, gammaln

from ..ops.harmonics import cart2sph_matrix, cart_components, ncart


def boys(n_max: int, x: np.ndarray) -> np.ndarray:
    """Boys functions F_0..F_n at x (any shape); returns (n_max+1, *x.shape)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty((n_max + 1,) + x.shape)
    small = x < 1e-12
    xs = np.where(small, 1.0, x)
    for n in range(n_max + 1):
        a = n + 0.5
        val = 0.5 * np.exp(gammaln(a)) * gammainc(a, xs) / xs**a
        out[n] = np.where(small, 1.0 / (2 * n + 1) - x / (2 * n + 3), val)
    return out


_EINSUM_PATHS = {}


def _einsum_cached(expr, *ops):
    """np.einsum with the contraction path cached by (expr, shapes) —
    einsum_path recomputation was ~16% of ERI construction (it runs the
    greedy optimizer on every call)."""
    key = (expr,) + tuple(op.shape for op in ops)
    path = _EINSUM_PATHS.get(key)
    if path is None:
        path, _ = np.einsum_path(expr, *ops, optimize="greedy")
        _EINSUM_PATHS[key] = path
    return np.einsum(expr, *ops, optimize=path)


def _hermite_E(la, lb, PA, PB, p):
    """Hermite expansion coefficients E[i, j, t] for one dimension.

    PA, PB: arrays (npair,) of P-A, P-B along this axis; p: (npair,) total
    exponent. Returns array (la+1, lb+1, la+lb+1, npair).
    """
    npair = PA.shape[0]
    E = np.zeros((la + 1, lb + 1, la + lb + 2, npair))
    E[0, 0, 0] = 1.0
    inv2p = 0.5 / p
    for i in range(1, la + 1):
        E[i, 0, 0] = PA * E[i - 1, 0, 0] + E[i - 1, 0, 1]
        for t in range(1, i + 1):
            E[i, 0, t] = (
                inv2p * E[i - 1, 0, t - 1]
                + PA * E[i - 1, 0, t]
                + (t + 1) * E[i - 1, 0, t + 1]
            )
    for j in range(1, lb + 1):
        for i in range(la + 1):
            E[i, j, 0] = PB * E[i, j - 1, 0] + E[i, j - 1, 1]
            for t in range(1, i + j + 1):
                E[i, j, t] = (
                    inv2p * E[i, j - 1, t - 1]
                    + PB * E[i, j - 1, t]
                    + (t + 1) * E[i, j - 1, t + 1]
                )
    return E[:, :, : la + lb + 1]


def _hermite_R(tmax, umax, vmax, p, PC):
    """Hermite Coulomb integrals R[t, u, v] (npair,) arrays.

    R^0_{tuv}(p, PC) built from Boys functions by downward recursion,
    filled iteratively as dense (t, u, v, npair) tables per auxiliary
    order n (the previous memoized Python recursion cost ~1.3k dict-churn
    calls per invocation and dominated ERI construction for big seas).
    Recurrences (t-axis used whenever t > 0, then u, then v):
      R^n_{t,u,v} = X R^{n+1}_{t-1,u,v} + (t-1) R^{n+1}_{t-2,u,v}
      R^n_{0,u,v} = Y R^{n+1}_{0,u-1,v} + (u-1) R^{n+1}_{0,u-2,v}
      R^n_{0,0,v} = Z R^{n+1}_{0,0,v-1} + (v-1) R^{n+1}_{0,0,v-2}
      R^n_{0,0,0} = (-2p)^n F_n
    """
    nmax = tmax + umax + vmax
    x = p * np.sum(PC * PC, axis=-1)
    F = boys(nmax, x)  # (nmax+1, npair)
    npair = x.shape[0]
    X, Y, Z = PC[:, 0], PC[:, 1], PC[:, 2]
    m2p = -2.0 * p
    prev = None
    for n in range(nmax, -1, -1):
        Rn = np.zeros((tmax + 1, umax + 1, vmax + 1, npair))
        Rn[0, 0, 0] = (m2p**n) * F[n]
        if prev is not None:
            for v in range(1, vmax + 1):
                Rn[0, 0, v] = Z * prev[0, 0, v - 1]
                if v > 1:
                    Rn[0, 0, v] += (v - 1) * prev[0, 0, v - 2]
            for u in range(1, umax + 1):
                Rn[0, u, :] = Y * prev[0, u - 1, :]
                if u > 1:
                    Rn[0, u, :] += (u - 1) * prev[0, u - 2, :]
            for t in range(1, tmax + 1):
                Rn[t] = X * prev[t - 1]
                if t > 1:
                    Rn[t] += (t - 1) * prev[t - 2]
        prev = Rn
    return prev


class _ShellPair:
    """Primitive-pair data for one shell pair, vectorized over prim pairs."""

    def __init__(self, sh_a, sh_b, coord_a, coord_b):
        a = sh_a.exps[:, None]
        b = sh_b.exps[None, :]
        ca = sh_a.coeffs[:, None]
        cb = sh_b.coeffs[None, :]
        self.la, self.lb = sh_a.l, sh_b.l
        p = (a + b).ravel()
        mu = (a * b / (a + b)).ravel()
        AB = coord_a - coord_b
        self.p = p
        self.cc = (ca * cb).ravel() * np.exp(-mu * np.dot(AB, AB))
        P = (a[..., None] * coord_a + b[..., None] * coord_b) / (a + b)[..., None]
        self.P = P.reshape(-1, 3)
        PA = self.P - coord_a
        PB = self.P - coord_b
        lt = self.la + self.lb
        self.E = [
            _hermite_E(self.la, self.lb, PA[:, d], PB[:, d], p) for d in range(3)
        ]
        self.comps_a = cart_components(self.la)
        self.comps_b = cart_components(self.lb)

    def hermite_density(self):
        """Theta[cartA, cartB, t, u, v, npair] = Ex*Ey*Ez."""
        la, lb = self.la, self.lb
        nt = la + lb + 1
        na, nb = len(self.comps_a), len(self.comps_b)
        npair = self.p.shape[0]
        out = np.zeros((na, nb, nt, nt, nt, npair))
        for ia, (ax, ay, az) in enumerate(self.comps_a):
            for ib, (bx, by, bz) in enumerate(self.comps_b):
                Ex = self.E[0][ax, bx]  # (nt_total, npair)
                Ey = self.E[1][ay, by]
                Ez = self.E[2][az, bz]
                block = (
                    Ex[: ax + bx + 1][:, None, None, :]
                    * Ey[: ay + by + 1][None, :, None, :]
                    * Ez[: az + bz + 1][None, None, :, :]
                )
                out[ia, ib, : ax + bx + 1, : ay + by + 1, : az + bz + 1] = block
        return out


def _sph_transform(mat_cart, la, lb):
    """(..., ncartA, ncartB) -> (..., 2la+1, 2lb+1)."""
    Ca = cart2sph_matrix(la)
    Cb = cart2sph_matrix(lb)
    return np.einsum("...ab,ai,bj->...ij", mat_cart, Ca, Cb)


def _pairs(mol):
    coords = mol.atom_coords
    for i, si in enumerate(mol.shells):
        for j, sj in enumerate(mol.shells):
            if j < i:
                continue
            yield i, j, si, sj, _ShellPair(si, sj, coords[si.atom], coords[sj.atom])


def overlap_kinetic(mol):
    """Returns (S, T) over spherical AOs."""
    nao = mol.nao
    S = np.zeros((nao, nao))
    T = np.zeros((nao, nao))
    coords = mol.atom_coords
    for i, j, si, sj, sp in _pairs(mol):
        la, lb = si.l, sj.l
        pref = (np.pi / sp.p) ** 1.5 * sp.cc  # (npair,)
        comps_a, comps_b = sp.comps_a, sp.comps_b
        b_exps = np.broadcast_to(
            sj.exps[None, :], (len(si.exps), len(sj.exps))
        ).ravel()

        s_cart = np.zeros((len(comps_a), len(comps_b)))
        t_cart = np.zeros_like(s_cart)

        # 1D overlap helper: S1(i, j, d) with j possibly out of table range
        def S1(i_, j_, d):
            if i_ < 0 or j_ < 0:
                return 0.0
            E = sp.E[d]
            if j_ >= E.shape[1]:
                # extend table on demand for kinetic's j+2 shifts
                return S1_ext(i_, j_, d)
            return E[i_, j_, 0]

        ext_cache = {}

        def S1_ext(i_, j_, d):
            key = (d, j_)
            if key not in ext_cache:
                PA = sp.P[:, d] - coords[si.atom][d]
                PB = sp.P[:, d] - coords[sj.atom][d]
                ext_cache[key] = _hermite_E(la, j_, PA, PB, sp.p)
            return ext_cache[key][i_, j_, 0]

        for ia, ca in enumerate(comps_a):
            for ib, cb in enumerate(comps_b):
                sx = [S1(ca[d], cb[d], d) for d in range(3)]
                s_cart[ia, ib] = np.sum(pref * sx[0] * sx[1] * sx[2])
                # kinetic: per-dimension T1
                tsum = 0.0
                for d in range(3):
                    jd = cb[d]
                    t1 = -0.5 * (
                        jd * (jd - 1) * S1(ca[d], jd - 2, d)
                        - 2.0 * b_exps * (2 * jd + 1) * S1(ca[d], jd, d)
                        + 4.0 * b_exps**2 * S1(ca[d], jd + 2, d)
                    )
                    rest = [S1(ca[dd], cb[dd], dd) for dd in range(3) if dd != d]
                    tsum = tsum + np.sum(pref * t1 * rest[0] * rest[1])
                t_cart[ia, ib] = tsum

        s_sph = _sph_transform(s_cart, la, lb)
        t_sph = _sph_transform(t_cart, la, lb)
        oa, ob = si.ao_offset, sj.ao_offset
        na, nb = 2 * la + 1, 2 * lb + 1
        S[oa : oa + na, ob : ob + nb] = s_sph
        T[oa : oa + na, ob : ob + nb] = t_sph
        if i != j:
            S[ob : ob + nb, oa : oa + na] = s_sph.T
            T[ob : ob + nb, oa : oa + na] = t_sph.T
    return S, T


def nuclear(mol, charges=None, centers=None):
    """Nuclear-attraction matrix -sum_C Z_C / |r - C| over spherical AOs."""
    nao = mol.nao
    V = np.zeros((nao, nao))
    if charges is None:
        charges = mol.atom_charges
        centers = mol.atom_coords
    for i, j, si, sj, sp in _pairs(mol):
        la, lb = si.l, sj.l
        lt = la + lb
        theta = sp.hermite_density()  # (na, nb, nt, nt, nt, npair)
        v_cart = np.zeros(theta.shape[:2])
        for Z, C in zip(charges, centers):
            PC = sp.P - np.asarray(C)[None, :]
            R = _hermite_R(lt, lt, lt, sp.p, PC)  # (nt, nt, nt, npair)
            contrib = np.einsum(
                "abtuvp,tuvp,p->ab", theta, R, sp.cc * (2 * np.pi / sp.p)
            )
            v_cart -= Z * contrib
        v_sph = _sph_transform(v_cart, la, lb)
        oa, ob = si.ao_offset, sj.ao_offset
        na, nb = 2 * la + 1, 2 * lb + 1
        V[oa : oa + na, ob : ob + nb] = v_sph
        if i != j:
            V[ob : ob + nb, oa : oa + na] = v_sph.T
    return V


def eri(mol):
    """Full (nao, nao, nao, nao) spherical ERI tensor (chemist's (ij|kl)).

    Ket shell pairs are grouped by (lc, ld) and processed as ONE batched
    Hermite-R + einsum per bra pair, with the primitive-pair axis carrying
    the whole group (per-pair contraction recovered by a reduceat segment
    sum). This replaces the former per-(bra, ket) Python loop — O(npairs^2)
    iterations whose fixed numpy overhead dominated large even-tempered
    seas (the ECP generator's 3d-metal all-electron SCFs, ~150 AOs).
    """
    nao = mol.nao
    out = np.zeros((nao, nao, nao, nao))
    pairs = list(_pairs(mol))
    dens = [sp.hermite_density() for *_unused, sp in pairs]

    # group ket pairs by (lc, ld); concatenate their primitive-pair data
    groups = {}
    for idx, (k, l, sk, sl, spcd) in enumerate(pairs):
        g = groups.setdefault((sk.l, sl.l), {
            "idx": [], "T": [], "q": [], "cc": [], "P": [], "meta": [],
            "bounds": [0],
        })
        g["idx"].append(idx)
        g["T"].append(dens[idx])
        g["q"].append(spcd.p)
        g["cc"].append(spcd.cc)
        g["P"].append(spcd.P)
        g["meta"].append((k, l, sk, sl))
        g["bounds"].append(g["bounds"][-1] + spcd.p.shape[0])
    for g in groups.values():
        g["idx"] = np.asarray(g["idx"])
        g["T"] = np.concatenate(g["T"], axis=-1)
        g["q"] = np.concatenate(g["q"])
        g["cc"] = np.concatenate(g["cc"])
        g["P"] = np.concatenate(g["P"], axis=0)
        g["bounds"] = np.asarray(g["bounds"])

    for idx_ab, (i, j, si, sj, spab) in enumerate(pairs):
        la, lb = si.l, sj.l
        ltab = la + lb
        Tab = dens[idx_ab]
        for (lc, ld), g in groups.items():
            # triangular skip: only ket pairs with idx >= idx_ab (suffix of
            # the concatenated arrays, since members are in index order)
            pos = int(np.searchsorted(g["idx"], idx_ab))
            nmem = len(g["idx"]) - pos
            if nmem == 0:
                continue
            qs = int(g["bounds"][pos])
            Tcd = g["T"][..., qs:]
            qv = g["q"][qs:]
            ltcd = lc + ld
            p = spab.p[:, None]  # (npab, 1)
            q = qv[None, :]  # (1, Q)
            alpha = p * q / (p + q)
            pref = (
                2.0 * np.pi**2.5
                / (p * q * np.sqrt(p + q))
                * spab.cc[:, None]
                * g["cc"][qs:][None, :]
            )  # (npab, Q)
            PQ = spab.P[:, None, :] - g["P"][qs:][None, :, :]
            npab, Q = pref.shape
            nt = ltab + ltcd + 1
            R = _hermite_R(
                nt - 1, nt - 1, nt - 1, alpha.ravel(), PQ.reshape(-1, 3)
            ).reshape(nt, nt, nt, npab, Q)
            # signs (-1)^{tau+nu+phi} for the ket hermite indices
            sign = np.fromfunction(
                lambda t, u, v: (-1.0) ** (t + u + v), (ltcd + 1,) * 3
            )
            # contract, keeping the ket-pair axis Q for the segment sum
            vQ = _einsum_cached(
                "abtuvp,cdxyzQ,xyz,txuyvzpQ,pQ->abcdQ",
                Tab,
                Tcd,
                sign,
                _shifted_R(R, ltab, ltcd),
                pref,
            )
            starts = (g["bounds"][pos:-1] - qs).astype(np.intp)
            v_per = np.add.reduceat(vQ, starts, axis=-1)  # (a,b,c,d,nmem)
            v_sph = _einsum_cached(
                "abcdm,ai,bj,ck,dl->ijklm",
                v_per,
                cart2sph_matrix(la),
                cart2sph_matrix(lb),
                cart2sph_matrix(lc),
                cart2sph_matrix(ld),
            )
            for m in range(nmem):
                k, l, sk, sl = g["meta"][pos + m]
                _scatter_eri(out, v_sph[..., m], si, sj, sk, sl, i, j, k, l)
    return out


def _shifted_R(R, ltab, ltcd):
    """R6[t, T, u, U, v, V, p, q] = R[t+T, u+U, v+V, p, q].

    One advanced-indexing gather (the former 6-deep Python loop was ~20%
    of ERI construction for large seas)."""
    s = np.arange(ltab + 1)[:, None] + np.arange(ltcd + 1)[None, :]  # (a, c)
    return R[
        s[:, :, None, None, None, None],
        s[None, None, :, :, None, None],
        s[None, None, None, None, :, :],
    ]


def _scatter_eri(out, v, si, sj, sk, sl, i, j, k, l):
    oa, ob, oc, od = si.ao_offset, sj.ao_offset, sk.ao_offset, sl.ao_offset
    na, nb, nc, nd = (2 * s.l + 1 for s in (si, sj, sk, sl))
    sa = slice(oa, oa + na)
    sb = slice(ob, ob + nb)
    sc = slice(oc, oc + nc)
    sd = slice(od, od + nd)
    out[sa, sb, sc, sd] = v
    out[sb, sa, sc, sd] = v.transpose(1, 0, 2, 3)
    out[sa, sb, sd, sc] = v.transpose(0, 1, 3, 2)
    out[sb, sa, sd, sc] = v.transpose(1, 0, 3, 2)
    out[sc, sd, sa, sb] = v.transpose(2, 3, 0, 1)
    out[sd, sc, sa, sb] = v.transpose(3, 2, 0, 1)
    out[sc, sd, sb, sa] = v.transpose(2, 3, 1, 0)
    out[sd, sc, sb, sa] = v.transpose(3, 2, 1, 0)

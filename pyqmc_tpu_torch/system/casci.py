"""Minimal CASCI (full CI in an active space) on top of the built-in SCF
(a copy of pyqmc_tpu/system/casci.py, numpy only).

Replaces the slice of pyscf the reference uses to obtain multi-determinant
trial wavefunctions (pyqmc/pyscftools.py:194-298 interprets pyscf CASCI/HCI
CI vectors). Exact diagonalization in the determinant basis; intended for
small active spaces (dimension <= a few thousand).

Returns determinant data directly consumable by models.slater:
(DeterminantExpansion, det_coeff, mo_coeff per spin).
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

from . import integrals
from ..models.slater import DeterminantExpansion


def _mo_integrals(mf, ncore, ncas):
    """Active-space (h1eff, eri_cas, ecore) in the CAS MO basis."""
    mol = mf.mol
    C = np.asarray(mf.mo_coeff[0])  # restricted orbitals assumed
    S, T = integrals.overlap_kinetic(mol)
    V = integrals.nuclear(mol)
    H1 = T + V
    if getattr(mol, "ecp", None):
        from .ecp_integrals import ecp_matrix

        H1 = H1 + ecp_matrix(mol)
    ERI = integrals.eri(mol)
    Ccore = C[:, :ncore]
    Ccas = C[:, ncore : ncore + ncas]
    dcore = 2.0 * Ccore @ Ccore.T
    jcore = np.einsum("ijkl,kl->ij", ERI, dcore)
    kcore = np.einsum("ikjl,kl->ij", ERI, dcore)
    fcore = H1 + jcore - 0.5 * kcore
    ecore = float(np.sum(dcore * (H1 + 0.5 * jcore - 0.25 * kcore)))
    h1 = Ccas.T @ fcore @ Ccas
    eri_cas = np.einsum(
        "ijkl,ip,jq,kr,ls->pqrs", ERI, Ccas, Ccas, Ccas, Ccas, optimize=True
    )
    return h1, eri_cas, ecore + mf.mol.nuclear_repulsion()


def _strings(ncas, nelec):
    return [frozenset(c) for c in itertools.combinations(range(ncas), nelec)]


def _excitation(s1, s2):
    """(sign, (i, a)) for single excitation s1 -> s2, or None."""
    diff1 = sorted(s1 - s2)
    diff2 = sorted(s2 - s1)
    if len(diff1) != 1:
        return None
    i, a = diff1[0], diff2[0]
    # sign: count occupied orbitals between i and a in s1
    lo, hi = (i, a) if i < a else (a, i)
    nbet = len([o for o in s1 if lo < o < hi])
    return (-1.0) ** nbet, (i, a)


def _build_h(h1, eri, strs_a, strs_b):
    """Dense CI Hamiltonian (slow, exact; fine for small CAS)."""
    na, nb = len(strs_a), len(strs_b)
    dim = na * nb

    # precompute single-excitation tables per spin
    def singles(strs):
        table = {}
        for I, s in enumerate(strs):
            for J, t in enumerate(strs):
                if I == J:
                    continue
                ex = _excitation(s, t)
                if ex is not None:
                    table[(I, J)] = ex
        return table

    sa = singles(strs_a)
    sb = singles(strs_b)
    H = np.zeros((dim, dim))

    def h1e_diag(s):
        return sum(h1[o, o] for o in s)

    for Ia, a_occ in enumerate(strs_a):
        for Ib, b_occ in enumerate(strs_b):
            I = Ia * nb + Ib
            # diagonal
            e = h1e_diag(a_occ) + h1e_diag(b_occ)
            occ = list(a_occ) + list(b_occ)
            for x, o1 in enumerate(a_occ):
                for o2 in a_occ:
                    e += 0.5 * (eri[o1, o1, o2, o2] - eri[o1, o2, o2, o1])
                for o2 in b_occ:
                    e += eri[o1, o1, o2, o2]
            for o1 in b_occ:
                for o2 in b_occ:
                    e += 0.5 * (eri[o1, o1, o2, o2] - eri[o1, o2, o2, o1])
            H[I, I] = e
            # alpha singles / doubles with beta fixed
            for (Ja, Jb_), (sgn, (i, a)) in (
                ((k[1], None), v) for k, v in sa.items() if k[0] == Ia
            ):
                J = Ja * nb + Ib
                val = h1[i, a]
                for o in a_occ:
                    if o != i:
                        val += eri[i, a, o, o] - eri[i, o, o, a]
                for o in b_occ:
                    val += eri[i, a, o, o]
                H[I, J] += sgn * val
            # beta singles
            for (Jb, _), (sgn, (i, a)) in (
                ((k[1], None), v) for k, v in sb.items() if k[0] == Ib
            ):
                J = Ia * nb + Jb
                val = h1[i, a]
                for o in b_occ:
                    if o != i:
                        val += eri[i, a, o, o] - eri[i, o, o, a]
                for o in a_occ:
                    val += eri[i, a, o, o]
                H[I, J] += sgn * val
            # alpha-alpha doubles
            for Ja, a2 in enumerate(strs_a):
                d1 = sorted(a_occ - a2)
                d2 = sorted(a2 - a_occ)
                if len(d1) == 2:
                    i, j = d1
                    a, b = d2
                    sgn = _double_sign(a_occ, (i, j), (a, b))
                    H[I, Ja * nb + Ib] += sgn * (
                        eri[i, a, j, b] - eri[i, b, j, a]
                    )
            # beta-beta doubles
            for Jb, b2 in enumerate(strs_b):
                d1 = sorted(b_occ - b2)
                d2 = sorted(b2 - b_occ)
                if len(d1) == 2:
                    i, j = d1
                    a, b = d2
                    sgn = _double_sign(b_occ, (i, j), (a, b))
                    H[I, Ia * nb + Jb] += sgn * (
                        eri[i, a, j, b] - eri[i, b, j, a]
                    )
            # alpha-beta doubles
            for (ka, Ja), (sgna, (i, a)) in (
                (k, v) for k, v in sa.items() if k[0] == Ia
            ):
                for (kb, Jb), (sgnb, (j, b)) in (
                    (k, v) for k, v in sb.items() if k[0] == Ib
                ):
                    H[I, Ja * nb + Jb] += sgna * sgnb * eri[i, a, j, b]
    return H


def _double_sign(s_from, ij, ab):
    """Sign of a same-spin double excitation via two sequential singles."""
    i, j = ij
    a, b = ab
    s = set(s_from)
    ex1 = _excitation(frozenset(s), frozenset(s - {i} | {a}))
    if ex1 is None:
        return 0.0
    sgn1 = ex1[0]
    s = s - {i} | {a}
    ex2 = _excitation(frozenset(s), frozenset(s - {j} | {b}))
    if ex2 is None:
        return 0.0
    return sgn1 * ex2[0]


def run_casci(mf, ncas, nelecas: Tuple[int, int], nroots=1, tol=1e-6):
    """Exact CASCI. Returns (energies, list of (expansion, det_coeff)).

    Determinant orbital indices are in the CAS MO space offset by ncore, so
    they can be used directly with mo_coeff[:, :ncore+ncas].
    """
    nup_tot, ndn_tot = mf.mol.nelec
    ncore = nup_tot - nelecas[0]
    assert ndn_tot - nelecas[1] == ncore, "unequal core not supported"
    h1, eri, ecore = _mo_integrals(mf, ncore, ncas)
    strs_a = _strings(ncas, nelecas[0])
    strs_b = _strings(ncas, nelecas[1])
    H = _build_h(h1, eri, strs_a, strs_b)
    w, v = np.linalg.eigh(H)
    energies = w[:nroots] + ecore
    results = []
    core = list(range(ncore))
    for root in range(nroots):
        ci = v[:, root].reshape(len(strs_a), len(strs_b))
        sel = np.argwhere(np.abs(ci) > tol)
        # unique spin strings used
        ua = sorted(set(int(s[0]) for s in sel))
        ub = sorted(set(int(s[1]) for s in sel))
        amap = {s: k for k, s in enumerate(ua)}
        bmap = {s: k for k, s in enumerate(ub)}
        occ_up = np.array(
            [core + [ncore + o for o in sorted(strs_a[s])] for s in ua]
        )
        occ_dn = np.array(
            [core + [ncore + o for o in sorted(strs_b[s])] for s in ub]
        )
        map_up = np.array([amap[int(s[0])] for s in sel])
        map_dn = np.array([bmap[int(s[1])] for s in sel])
        coeff = np.array([ci[s[0], s[1]] for s in sel])
        exp = DeterminantExpansion(
            occ_up=occ_up, occ_dn=occ_dn, map_up=map_up, map_dn=map_dn
        )
        results.append((exp, coeff))
    return energies, results


# ---------------------------------------------------------------------------
# Selected CI (heat-bath / HCI style)
# ---------------------------------------------------------------------------

def _sc_element(h1, eri, det1, det2):
    """Slater-Condon matrix element between determinants (sa, sb) given as
    frozensets of spatial-orbital indices per spin."""
    sa1, sb1 = det1
    sa2, sb2 = det2
    da = len(sa1 - sa2)
    db = len(sb1 - sb2)
    if da + db > 2:
        return 0.0
    if da == 0 and db == 0:
        e = sum(h1[o, o] for o in sa1) + sum(h1[o, o] for o in sb1)
        for o1 in sa1:
            for o2 in sa1:
                e += 0.5 * (eri[o1, o1, o2, o2] - eri[o1, o2, o2, o1])
            for o2 in sb1:
                e += eri[o1, o1, o2, o2]
        for o1 in sb1:
            for o2 in sb1:
                e += 0.5 * (eri[o1, o1, o2, o2] - eri[o1, o2, o2, o1])
        return e
    if da == 1 and db == 0:
        ex = _excitation(sa1, sa2)
        if ex is None:
            return 0.0
        sgn, (i, a) = ex
        val = h1[i, a]
        for o in sa1:
            if o != i:
                val += eri[i, a, o, o] - eri[i, o, o, a]
        for o in sb1:
            val += eri[i, a, o, o]
        return sgn * val
    if da == 0 and db == 1:
        ex = _excitation(sb1, sb2)
        if ex is None:
            return 0.0
        sgn, (i, a) = ex
        val = h1[i, a]
        for o in sb1:
            if o != i:
                val += eri[i, a, o, o] - eri[i, o, o, a]
        for o in sa1:
            val += eri[i, a, o, o]
        return sgn * val
    if da == 2 and db == 0:
        d1 = sorted(sa1 - sa2)
        d2 = sorted(sa2 - sa1)
        i, j = d1
        a, b = d2
        sgn = _double_sign(sa1, (i, j), (a, b))
        return sgn * (eri[i, a, j, b] - eri[i, b, j, a])
    if da == 0 and db == 2:
        d1 = sorted(sb1 - sb2)
        d2 = sorted(sb2 - sb1)
        i, j = d1
        a, b = d2
        sgn = _double_sign(sb1, (i, j), (a, b))
        return sgn * (eri[i, a, j, b] - eri[i, b, j, a])
    # da == 1 and db == 1
    exa = _excitation(sa1, sa2)
    exb = _excitation(sb1, sb2)
    if exa is None or exb is None:
        return 0.0
    sgna, (i, a) = exa
    sgnb, (j, b) = exb
    return sgna * sgnb * eri[i, a, j, b]


def _connected(det, ncas):
    """All single+double excitations of det = (sa, sb)."""
    sa, sb = det
    virt_a = [o for o in range(ncas) if o not in sa]
    virt_b = [o for o in range(ncas) if o not in sb]
    out = set()
    singles_a = []
    for i in sa:
        for a in virt_a:
            s2 = frozenset(sa - {i} | {a})
            singles_a.append(s2)
            out.add((s2, sb))
    singles_b = []
    for i in sb:
        for a in virt_b:
            s2 = frozenset(sb - {i} | {a})
            singles_b.append(s2)
            out.add((sa, s2))
    import itertools as _it

    for (i, j) in _it.combinations(sorted(sa), 2):
        for (a, b) in _it.combinations(virt_a, 2):
            out.add((frozenset(sa - {i, j} | {a, b}), sb))
    for (i, j) in _it.combinations(sorted(sb), 2):
        for (a, b) in _it.combinations(virt_b, 2):
            out.add((sa, frozenset(sb - {i, j} | {a, b})))
    for s2a in singles_a:
        for s2b in singles_b:
            out.add((s2a, s2b))
    return out


def run_hci(mf, ncas, nelecas, eps1=1e-3, nroots=1, max_rounds=12, tol=1e-9):
    """Heat-bath style selected CI (HCI variational stage,
    pyscftools.deters_from_hci parity without pyscf).

    Iteratively adds determinants d with |H_dI c_I| > eps1 for any selected
    I, rediagonalizing until the set is stable. eps1 -> 0 recovers CASCI.
    Returns (energies, [(DeterminantExpansion, det_coeff) per root]).
    """
    nup_tot, ndn_tot = mf.mol.nelec
    ncore = nup_tot - nelecas[0]
    h1, eri, ecore = _mo_integrals(mf, ncore, ncas)
    hf = (frozenset(range(nelecas[0])), frozenset(range(nelecas[1])))
    selected = [hf]
    coeffs = np.array([1.0])
    for _round in range(max_rounds):
        sel_set = set(selected)
        new = set()
        for I, det in enumerate(selected):
            cI = coeffs[I]
            if abs(cI) < 1e-12:
                continue
            for cand in _connected(det, ncas):
                if cand in sel_set or cand in new:
                    continue
                if abs(_sc_element(h1, eri, cand, det) * cI) > eps1:
                    new.add(cand)
        if not new:
            break
        selected = selected + sorted(
            new, key=lambda d: (sorted(d[0]), sorted(d[1]))
        )
        n = len(selected)
        H = np.zeros((n, n))
        for I in range(n):
            for J in range(I, n):
                H[I, J] = H[J, I] = _sc_element(h1, eri, selected[I], selected[J])
        w, v = np.linalg.eigh(H)
        coeffs = v[:, 0]
    n = len(selected)
    H = np.zeros((n, n))
    for I in range(n):
        for J in range(I, n):
            H[I, J] = H[J, I] = _sc_element(h1, eri, selected[I], selected[J])
    w, v = np.linalg.eigh(H)
    energies = w[:nroots] + ecore
    core = list(range(ncore))
    results = []
    for root in range(min(nroots, n)):
        ci = v[:, root]
        keep = np.abs(ci) > tol
        dets = [selected[i] for i in np.nonzero(keep)[0]]
        cs = ci[keep]
        ua = sorted({d[0] for d in dets}, key=sorted)
        ub = sorted({d[1] for d in dets}, key=sorted)
        amap = {s: k for k, s in enumerate(ua)}
        bmap = {s: k for k, s in enumerate(ub)}
        occ_up = np.array([core + [ncore + o for o in sorted(s)] for s in ua])
        occ_dn = np.array([core + [ncore + o for o in sorted(s)] for s in ub])
        map_up = np.array([amap[d[0]] for d in dets])
        map_dn = np.array([bmap[d[1]] for d in dets])
        results.append(
            (
                DeterminantExpansion(
                    occ_up=occ_up, occ_dn=occ_dn, map_up=map_up, map_dn=map_dn
                ),
                cs,
            )
        )
    return energies, results

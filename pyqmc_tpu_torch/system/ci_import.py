"""External selected-CI determinant import (a copy of
pyqmc_tpu/system/ci_import.py, numpy only).

Converts determinant lists produced outside this framework — pyscf
CASCI/HCI (`mc._strs`) / SCI objects, or plain (coeff, bitstring) tuples
from any selected-CI code — into a `DeterminantExpansion` + coefficient
array usable by `models.slater.Slater`. Covers the role of
pyqmc/pyscftools.py:200-298 (interpret_ci, deters_from_hci/sci,
determinant_tools.binary_to_occ/reformat) without requiring pyscf: the
object-facing entry point duck-types on attributes, so anything exposing
`ci`/`ncas`/`nelecas` (+ `_strs` for HCI) works.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..models.slater import DeterminantExpansion


def binary_to_occ(s: str, ncore: int = 0) -> List[int]:
    """Bitstring (left = highest orbital, as printed by bin()) -> occupied
    orbital list, with ncore doubly-occupied core orbitals prepended
    (determinant_tools.binary_to_occ, determinant_tools.py:8-20)."""
    occupation = [int(i) for i in s]
    occupied = [ncore + i for i, d in enumerate(reversed(occupation)) if d == 1]
    return list(range(ncore)) + occupied


def expansion_from_determinants(
    determinants: Sequence[Tuple[float, Tuple[Sequence[int], Sequence[int]]]],
) -> Tuple[DeterminantExpansion, np.ndarray]:
    """(weight, (occ_up, occ_dn)) list -> (DeterminantExpansion, det_coeff).

    Deduplicates the per-spin occupation strings the way the reference's
    create_packed_objects does (determinant_tools.py:39-91): the expansion
    refers to unique spin determinants through map_up/map_dn.
    """
    if not determinants:
        raise ValueError("empty determinant list")
    uniq = [{}, {}]  # occ tuple -> unique index, per spin
    maps = [[], []]
    coeffs = []
    for wt, occs in determinants:
        coeffs.append(wt)
        for spin in range(2):
            key = tuple(int(o) for o in occs[spin])
            if key not in uniq[spin]:
                uniq[spin][key] = len(uniq[spin])
            maps[spin].append(uniq[spin][key])
    nups = {len(k) for k in uniq[0]}
    ndns = {len(k) for k in uniq[1]}
    if len(nups) != 1 or len(ndns) != 1:
        raise ValueError(
            f"inconsistent electron counts across determinants: "
            f"up {sorted(nups)}, dn {sorted(ndns)}"
        )
    occ_up = np.array(sorted(uniq[0], key=uniq[0].get), dtype=np.int64)
    occ_dn = np.array(sorted(uniq[1], key=uniq[1].get), dtype=np.int64)
    exp = DeterminantExpansion(
        occ_up=occ_up.reshape(len(uniq[0]), -1),
        occ_dn=occ_dn.reshape(len(uniq[1]), -1),
        map_up=np.asarray(maps[0], dtype=np.int64),
        map_dn=np.asarray(maps[1], dtype=np.int64),
    )
    return exp, np.asarray(coeffs)


def determinants_from_bitstrings(
    deters: Sequence[Tuple[float, str, str]], ncore: int = 0, tol: float = 0.0
):
    """(coeff, up_bits, dn_bits) tuples -> determinant list (coeff,
    (occ_up, occ_dn)) with core orbitals prepended; drops |c| <= tol."""
    out = []
    for c, s_up, s_dn in deters:
        if abs(c) <= tol:
            continue
        out.append((c, (binary_to_occ(s_up, ncore), binary_to_occ(s_dn, ncore))))
    return out


def _deters_from_hci(mc, tol: float):
    """pyscf hci.SCI-style object: `_strs` packs up|dn 64-bit words
    (pyscftools.deters_from_hci, pyscftools.py:275-287)."""
    ci = np.asarray(mc.ci)
    strs = np.asarray(mc._strs)
    big = np.abs(ci) > tol
    nwords = strs.shape[1] // 2

    def join(words):
        # leading word unpadded, later words zero-padded to their 64 bits
        bits = [bin(int(words[0]))[2:]]
        bits += [bin(int(p))[2:].zfill(64) for p in words[1:]]
        return "".join(bits)

    deters = []
    for c, s in zip(ci[big], strs[big]):
        deters.append((float(c), join(s[:nwords]), join(s[nwords:])))
    return deters


def _pyscf_strings(ncas: int, nelec: int):
    """Occupied-orbital tuples in pyscf cistring order (colexicographic:
    ascending integer value of the bitmask), which is how dense CI arrays
    from pyscf CASCI/FCI are addressed."""
    import itertools

    return sorted(
        itertools.combinations(range(ncas), nelec),
        key=lambda t: tuple(reversed(t)),
    )


def _deters_from_ci_array(mc, tol: float):
    """Dense CI array (CASCI/FCI): enumerate spin strings directly."""
    ncas = int(mc.ncas)
    nelecas = mc.nelecas
    ci = np.asarray(mc.ci)
    strs_a = _pyscf_strings(ncas, int(nelecas[0]))
    strs_b = _pyscf_strings(ncas, int(nelecas[1]))
    ci = ci.reshape(len(strs_a), len(strs_b))
    deters = []
    for ia, sa in enumerate(strs_a):
        for ib, sb in enumerate(strs_b):
            c = ci[ia, ib]
            if abs(c) > tol:
                bits_a = "".join(
                    "1" if o in sa else "0" for o in reversed(range(ncas))
                )
                bits_b = "".join(
                    "1" if o in sb else "0" for o in reversed(range(ncas))
                )
                deters.append((float(c), bits_a, bits_b))
    return deters


def interpret_ci(mc, tol: float = 1e-9):
    """Multi-configuration object -> (DeterminantExpansion, det_coeff).

    Accepts pyscf CASCI/FCI objects (dense `ci`), pyscf HCI objects
    (`_strs` + sparse `ci`), or SCI objects exposing `large_ci`; duck-typed
    so externally produced look-alikes import too (pyscftools.interpret_ci,
    pyscftools.py:252-272).
    """
    ncore = int(getattr(mc, "ncore", 0) or 0)
    if hasattr(mc, "_strs"):
        deters = _deters_from_hci(mc, tol)
    elif hasattr(mc, "large_ci"):  # pyscf fci.SCI protocol
        raw = mc.large_ci(mc.ci, mc.norb, mc.nelec, tol=-1)
        deters = [
            (float(c), sa.replace("0b", ""), sb.replace("0b", ""))
            for c, sa, sb in raw
            if abs(c) > tol
        ]
    else:
        deters = _deters_from_ci_array(mc, tol)
    determinants = determinants_from_bitstrings(deters, ncore=ncore, tol=tol)
    return expansion_from_determinants(determinants)

"""Fit contracted valence bases for ECP atoms from scratch (counterpart of
pyqmc_tpu/system/basis_fit.py; host numpy, float64, on the port's
system/mole.py and system/scf.py).

Run the pseudo-atom UHF in a large even-tempered primitive sea, contract
each occupied radial level of each l channel with the atom's own HF radial
function (ANO-style rank-1 contraction per level, so e.g. Ti gets separate
3s and 4s contractions), free the outermost level's most diffuse
significant primitive as an uncontracted second zeta, and add the supplied
uncontracted polarization functions. These are the offline generators of
the `tpu1dz` basis tables the port carries (system/tpu1_library.py).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _pseudo_atom_scf(symbol: str, ecp, basis, spin: int):
    from .mole import Molecule
    from .scf import run_scf

    mol = Molecule(f"{symbol} 0 0 0", basis={symbol: basis}, ecp=ecp, spin=spin)
    best = None
    for kws in ({}, {"level_shift": 0.5}):
        try:
            mf = run_scf(mol, **kws)
        except Exception:
            continue
        if np.isfinite(mf.e_tot) and (best is None or mf.e_tot < best.e_tot - 1e-9):
            best = mf
    if best is None:
        raise RuntimeError(f"pseudo-atom SCF failed for {symbol}")
    return mol, best


def _occupied_radials(mol, mf, l: int) -> List[np.ndarray]:
    """Occupied radial contractions for channel l, innermost level first.

    For a valence ECP atom each occupied l level contributes one radial
    function; degenerate m partners (l>0) share it. Groups occupied
    alpha MOs that are >99% in the l block by eigenvalue and reads the
    radial coefficients (relative to unit-normalized primitives, i.e. raw
    pyscf-format coefficients) off the largest-norm m column.
    """
    shells = [sh for sh in mol.shells if sh.l == l]
    if any(len(sh.exps) != 1 for sh in shells):
        raise ValueError("sea basis must be uncontracted")
    nocc = mol.nelec[0]
    C = np.asarray(mf.mo_coeff[0])[:, :nocc]
    eps = np.asarray(mf.mo_energy[0])[:nocc]
    rows_by_m = [
        np.array([sh.ao_offset + m for sh in shells]) for m in range(2 * l + 1)
    ]
    levels: List[Tuple[float, np.ndarray]] = []  # (eps, coeffs)
    for col in np.argsort(eps):
        block_w = sum(float(np.sum(C[rows, col] ** 2)) for rows in rows_by_m)
        w = block_w / float(np.sum(C[:, col] ** 2))
        if w < 0.99:
            continue
        if any(abs(eps[col] - e0) < 1e-6 for e0, _ in levels):
            continue  # degenerate m partner of an already-collected level
        rows = max(rows_by_m, key=lambda r: float(np.sum(C[r, col] ** 2)))
        levels.append((float(eps[col]), np.asarray(C[rows, col], dtype=np.float64)))
    if not levels:
        raise RuntimeError(f"no pure l={l} occupied MO found")
    return [c for _, c in levels]


def even_tempered_sea(
    l_list: Sequence[int], alpha0: float = 0.045, beta: float = 2.0, n: int = 16
) -> list:
    """Uncontracted even-tempered primitive sea in raw pyscf format."""
    return [[l, [alpha0 * beta**k, 1.0]] for l in l_list for k in range(n)]


def fit_atomic_valence_basis(
    symbol: str,
    ecp="ccecp",
    spin: int | None = None,
    occ_l: Sequence[int] = (0, 1),
    free_exps: Dict[int, Sequence[float]] | None = None,
    sea_kwargs: dict | None = None,
    prune_below: float = 3e-4,
    split_valence: bool = True,
) -> Tuple[list, dict]:
    """Build a DZ-quality contracted basis for an ECP pseudo-atom.

    Returns (raw pyscf-format basis list, info dict). The basis is one
    HF-radial contraction per occupied level of each occupied l, an
    uncontracted second zeta per l (the outermost level's most diffuse
    primitive with a significant coefficient) when `split_valence`, plus
    the supplied uncontracted `free_exps` functions (e.g. {2: [1.2]}).
    Primitives whose contraction coefficient is below `prune_below`
    (relative) are dropped to keep the GTO tables small; the info dict
    reports the contracted-basis UHF energy against the sea energy so the
    truncation cost is visible.
    """
    if spin is None:
        from .ecp_generate import GROUND_SPIN
        from .elements import atomic_number

        spin = GROUND_SPIN.get(atomic_number(symbol), 0)
    sea_kwargs = dict(sea_kwargs or {})
    sea = even_tempered_sea(list(occ_l), **sea_kwargs)
    mol, mf = _pseudo_atom_scf(symbol, ecp, sea, spin)
    out = []
    for l in occ_l:
        exps = np.array([sh.exps[0] for sh in mol.shells if sh.l == l])
        radials = _occupied_radials(mol, mf, l)
        for coeffs in radials:
            keep = np.abs(coeffs) >= prune_below * np.abs(coeffs).max()
            out.append(
                [l] + [[float(e), float(c)] for e, c in zip(exps[keep], coeffs[keep])]
            )
        if split_valence:
            outer = radials[-1]
            sig = np.abs(outer) >= 0.25 * np.abs(outer).max()
            zeta2 = float(exps[sig].min())
            out.append([l, [zeta2, 1.0]])
    for l, fexps in sorted((free_exps or {}).items()):
        for e in fexps:
            out.append([l, [float(e), 1.0]])
    # truncation/contraction diagnostic: pseudo-atom UHF in the final basis
    _, mf_c = _pseudo_atom_scf(symbol, ecp, out, spin)
    info = {
        "sea_e_tot": float(mf.e_tot),
        "contracted_e_tot": float(mf_c.e_tot),
        "basis_error": float(mf_c.e_tot - mf.e_tot),
        "spin": spin,
    }
    return out, info

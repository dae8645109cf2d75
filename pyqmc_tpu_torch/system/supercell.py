"""Supercell construction (counterpart of pyqmc_tpu/system/supercell.py:17-50;
numpy only).

A supercell is defined by an integer matrix S: A_super = S @ A_prim. Its
atoms are the primitive cell's, translated by every primitive lattice point
inside the supercell, translation-major.
"""

from __future__ import annotations

import numpy as np

from .mole import Cell


def primitive_translations(S) -> np.ndarray:
    """Integer primitive-lattice points inside the supercell (|det S| of them)."""
    S = np.asarray(S, dtype=int)
    n = abs(int(round(np.linalg.det(S))))
    bounds = np.abs(S).sum(axis=0)
    rngs = [np.arange(-b, b + 1) for b in bounds]
    pts = np.array(np.meshgrid(*rngs, indexing="ij")).reshape(3, -1).T
    frac = pts @ np.linalg.inv(S)
    sel = pts[np.all((frac > -1e-9) & (frac < 1 - 1e-9), axis=1)]
    if len(sel) != n:
        raise ValueError(f"found {len(sel)} translations for |det S| = {n}")
    return sel


def get_supercell(cell: Cell, S) -> Cell:
    """Replicate a primitive Cell into the supercell defined by S."""
    S = np.asarray(S, dtype=int)
    trans = primitive_translations(S) @ cell.lattice  # cartesian shifts
    symbols, coords = [], []
    for t in trans:
        for sym, coord in zip(cell.atom_symbols, cell.atom_coords):
            symbols.append(sym)
            coords.append(np.asarray(coord) + t)
    sup = Cell(symbols, np.asarray(coords), {el: cell.basis[el] for el in set(cell.atom_symbols)},
               S @ cell.lattice,
               ecp={el: cell.ecp[el] for el in cell.ecp} if cell.ecp else None,
               spin=cell.spin * len(trans))
    sup.original_cell = cell
    sup.S = S
    sup.scale = len(trans)
    return sup

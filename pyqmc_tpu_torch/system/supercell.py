"""Supercell construction and supercell twists (counterpart of
pyqmc_tpu/system/supercell.py; numpy, and torch for the Jastrow
parameters).

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
    atoms = [(sym, np.asarray(coord) + t) for t in trans
             for sym, coord in zip(cell.atom_symbols, cell.atom_coords)]
    sup = Cell(atoms, S @ cell.lattice,
               basis={el: cell.basis[el] for el in set(cell.atom_symbols)},
               ecp={el: cell.ecp[el] for el in cell.ecp} if cell.ecp else None,
               spin=cell.spin * len(trans))
    sup.original_cell = cell
    sup.S = S
    sup.scale = len(trans)
    return sup


def get_supercell_kpts(supercell, primitive_kpts, twist=None, tol=1e-8):
    """Primitive k-points compatible with a supercell twist (fractional
    coordinates in the supercell's Brillouin zone, default 0): (indices into
    primitive_kpts, the twist in cartesian coordinates)."""
    recip_s = 2 * np.pi * np.linalg.inv(supercell.lattice).T  # rows
    twist_cart = np.zeros(3) @ recip_s if twist is None else np.asarray(twist) @ recip_s
    frac = (np.asarray(primitive_kpts) - twist_cart) @ supercell.lattice.T / (2 * np.pi)
    is_int = np.all(np.abs(frac - np.round(frac)) < tol, axis=1)
    return np.nonzero(is_int)[0], twist_cart


def create_supercell_twists(supercell, primitive_kpts, tol=1e-8):
    """Group a primitive k-mesh by supercell twist (pyqmc's pbc/twists.py):
    {twist in fractional supercell coordinates (a tuple): the indices of
    the k-points that fold onto it}."""
    frac = np.asarray(primitive_kpts) @ supercell.lattice.T / (2 * np.pi)
    frac_mod = frac - np.floor(frac + tol)
    groups = {}
    for i, f in enumerate(np.round(frac_mod, 8)):
        groups.setdefault(tuple(f), []).append(i)
    return {k: np.asarray(v) for k, v in groups.items()}


def replicate_jastrow_params(jastrow_prim, jastrow_super, params_prim):
    """Primitive-cell Jastrow coefficients mapped onto the supercell's
    Jastrow: the atom-resolved acoeff and ccoeff tiled over the replicas
    (the supercell's atoms are translation-major, as get_supercell orders
    them); bcoeff is translation-invariant and copied."""
    nrep = jastrow_super.natom // jastrow_prim.natom
    out = dict(params_prim)
    for k in ("acoeff", "ccoeff"):
        if k in params_prim:
            a = params_prim[k]
            out[k] = a.tile((nrep,) + (1,) * (a.ndim - 1))
    return out

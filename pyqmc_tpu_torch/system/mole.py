"""Molecule record (counterpart of pyqmc_tpu/system/mole.py, open boundary).

Numpy only. The port has no basis library and no SCF: a molecule is built
from an explicit, already normalised basis, as `system/io.py` reads it from
a checkpoint. The shell table follows `Molecule._build_shell_table` of the
JAX package exactly (atoms in order, each atom's shells in basis order,
`2l+1` spherical AOs per shell), because the AO order fixes the meaning of
every row of `mo_coeff`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# Atomic numbers through Kr (pyqmc_tpu/system/elements.py).
SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar",
    "K", "Ca", "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr",
]
_CHARGE = {s: i for i, s in enumerate(SYMBOLS)}


def atomic_number(symbol: str) -> int:
    s = symbol.strip()
    s = s[0].upper() + s[1:].lower() if len(s) > 1 else s.upper()
    return _CHARGE[s]


@dataclasses.dataclass(frozen=True)
class Shell:
    """One contracted shell of an element's basis (normalised coefficients)."""

    l: int
    exps: Tuple[float, ...]
    coeffs: Tuple[float, ...]


@dataclasses.dataclass
class ShellRef:
    """One shell placed on an atom: the flattened AO table entry."""

    atom: int
    l: int
    exps: np.ndarray
    coeffs: np.ndarray
    ao_offset: int  # first AO index of this shell (spherical layout)


class Molecule:
    """Open-boundary molecular system.

    atom_symbols: list of element symbols; atom_coords: (natom, 3) bohr;
    basis: {element: [Shell, ...]}; ecp: pyscf-format
    {element: [ncore, [[l, [slots r^0..r^6]], ...]]} or {}.
    """

    def __init__(self, atom_symbols, atom_coords, basis: Dict[str, List[Shell]],
                 ecp: Optional[dict] = None, charge: int = 0, spin: Optional[int] = None):
        self.atom_symbols = list(atom_symbols)
        self.atom_coords = np.asarray(atom_coords, dtype=np.float64).reshape(-1, 3)
        self.basis = basis
        self.ecp = ecp or {}
        z = np.array([atomic_number(s) for s in self.atom_symbols], dtype=np.int64)
        ncore = np.array(
            [self.ecp[s][0] if s in self.ecp else 0 for s in self.atom_symbols],
            dtype=np.int64,
        )
        self.atom_charges = z - ncore
        nelec_tot = int(self.atom_charges.sum()) - charge
        if spin is None:
            spin = nelec_tot % 2
        if (nelec_tot + spin) % 2 != 0:
            raise ValueError(f"nelec {nelec_tot} and spin {spin} incompatible")
        self.charge = charge
        self.spin = spin
        self.nelec = ((nelec_tot + spin) // 2, (nelec_tot - spin) // 2)
        self.lattice = None
        self._build_shell_table()

    def _build_shell_table(self):
        self.shells: List[ShellRef] = []
        off = 0
        for ia, sym in enumerate(self.atom_symbols):
            for sh in self.basis[sym]:
                self.shells.append(ShellRef(
                    atom=ia, l=sh.l, exps=np.asarray(sh.exps),
                    coeffs=np.asarray(sh.coeffs), ao_offset=off,
                ))
                off += 2 * sh.l + 1
        self.nao = off

    @property
    def natom(self):
        return len(self.atom_symbols)

    def nuclear_repulsion(self) -> float:
        e = 0.0
        for i in range(self.natom):
            for j in range(i + 1, self.natom):
                r = np.linalg.norm(self.atom_coords[i] - self.atom_coords[j])
                e += self.atom_charges[i] * self.atom_charges[j] / r
        return float(e)


@dataclasses.dataclass
class MeanField:
    """The slice of an SCF solution that QMC needs (system/scf.py MeanField)."""

    mol: Molecule
    mo_coeff: Tuple[np.ndarray, np.ndarray]  # per spin (nao, nmo)
    mo_energy: Tuple[np.ndarray, np.ndarray]
    mo_occ: Tuple[np.ndarray, np.ndarray]
    e_tot: float
    restricted: bool

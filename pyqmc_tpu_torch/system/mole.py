"""Molecule and periodic cell records (counterpart of
pyqmc_tpu/system/mole.py).

Numpy only. `Molecule(atom, basis="sto-3g", charge, spin, ecp, unit)`
takes the JAX signature: a "O 0 0 0; H ..." string or a list of (symbol,
xyz), a basis and an ECP by library name or as a dict (system/basis.py's
`get_basis`, `get_ecp`), coordinates in bohr unless unit="angstrom". The
shell table follows `Molecule._build_shell_table` of the JAX package
exactly (atoms in order, each atom's shells in basis order, `2l+1`
spherical AOs per shell), because the AO order fixes the meaning of every
row of `mo_coeff`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import basis as basis_mod
from .basis import Shell  # noqa: F401  (system.mole.Shell, as in the JAX package)
from .elements import atomic_number
from .scf import MeanField  # noqa: F401  (the JAX package keeps it in system/scf.py)

BOHR_PER_ANGSTROM = 1.0 / 0.529177210903


def _parse_atoms(atom) -> Tuple[List[str], np.ndarray]:
    """Accept 'O 0 0 0; H 0 0 1' strings or [('O', (x,y,z)), ...] lists."""
    if isinstance(atom, str):
        entries = []
        for tok in atom.replace("\n", ";").split(";"):
            tok = tok.strip()
            if not tok:
                continue
            parts = tok.split()
            entries.append((parts[0], [float(x) for x in parts[1:4]]))
    else:
        entries = [(a[0], list(np.asarray(a[1], dtype=float))) for a in atom]
    symbols = [e[0] for e in entries]
    coords = np.array([e[1] for e in entries], dtype=np.float64).reshape(-1, 3)
    return symbols, coords


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

    atom: "O 0 0 0; H 0 0 1" or [(symbol, (x, y, z)), ...]; basis: a
    built-in name or {element: pyscf-format list or [Shell, ...]}; ecp: a
    library name ("ccecp", "tpu1"), {element: pyscf-format ECP or library
    name}, or None; unit "bohr" or "angstrom". mol.ecp is pyscf-format
    {element: [ncore, [[l, [slots r^0..r^6]], ...]]} or {}.
    """

    def __init__(self, atom, basis="sto-3g", charge: int = 0, spin: Optional[int] = None,
                 ecp=None, unit: str = "bohr"):
        self.atom_symbols, coords = _parse_atoms(atom)
        if unit.lower().startswith("a"):
            coords = coords * BOHR_PER_ANGSTROM
        self.atom_coords = coords
        elements = sorted(set(self.atom_symbols))
        self.basis: Dict[str, List[Shell]] = basis_mod.get_basis(basis, elements)
        self.ecp = basis_mod.get_ecp(ecp, elements) if ecp else {}
        # effective charges: Z minus ECP core electrons
        z = np.array([atomic_number(s) for s in self.atom_symbols], dtype=np.int64)
        ncore = np.array([self.ecp[s][0] if s in self.ecp else 0 for s in self.atom_symbols],
                         dtype=np.int64)
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


class Cell(Molecule):
    """Periodic system: a molecule plus a lattice (rows are the lattice
    vectors, bohr); the keywords are Molecule's."""

    def __init__(self, atom, lattice, **kwargs):
        super().__init__(atom, **kwargs)
        self.lattice = np.asarray(lattice, dtype=np.float64)

    @property
    def volume(self):
        return float(abs(np.linalg.det(self.lattice)))

    def reciprocal(self):
        """Reciprocal lattice vectors as rows: b = 2 pi inv(a)^T."""
        return 2.0 * np.pi * np.linalg.inv(self.lattice).T

"""PySCF interoperability, duck-typed: no pyscf is needed (counterpart of
pyqmc_tpu/system/pyscf_adapter.py, a numpy-only copy).

Converts pyscf Mole/Cell, mean-field (RHF/ROHF/UHF, KRHF/KRKS) and
multi-configuration (CASCI/HCI/SCI) objects into the port's systems. The
functions read only plain attributes (`_basis`, `_ecp`, `mo_coeff`,
`mo_occ`, `atom_coord`, ...), so any object exposing the same surface
converts too (system/chkfile.py builds such objects from a chkfile).
"""

from __future__ import annotations

import numpy as np

from .mole import Molecule, Cell
from .scf import MeanField

_MOL_ATTRS = ("natm", "atom_symbol", "atom_coord", "_basis", "spin", "charge")


def _check_surface(obj, attrs, what):
    missing = [a for a in attrs if not hasattr(obj, a)]
    if missing:
        raise TypeError(
            f"{what} object {type(obj).__name__!r} lacks pyscf attributes "
            f"{missing}; pass a pyscf {what} (or a duck-typed equivalent "
            "exposing the same attributes)"
        )


def from_pyscf_mol(pmol):
    """Build the port's Molecule/Cell from a pyscf Mole/Cell.

    Reads the already-parsed internal tables (`_basis`, `_ecp`), so custom
    and BSE-downloaded bases carry over digit-exact. Coordinates come from
    `atom_coord(i)` (always bohr in pyscf).
    """
    _check_surface(pmol, _MOL_ATTRS, "Mole/Cell")
    atoms = [
        (pmol.atom_symbol(i), np.asarray(pmol.atom_coord(i), dtype=float))
        for i in range(pmol.natm)
    ]
    basis = {k: v for k, v in pmol._basis.items()}
    ecp = {k: v for k, v in getattr(pmol, "_ecp", {}).items()} or None
    kwargs = dict(basis=basis, ecp=ecp, spin=pmol.spin, charge=pmol.charge)
    if getattr(pmol, "a", None) is not None:  # pyscf Cell
        return Cell(atoms, lattice=np.asarray(pmol.lattice_vectors()), **kwargs)
    return Molecule(atoms, **kwargs)


def _split_spin_channels(mo, moe, occ):
    """pyscf mo arrays -> per-spin tuples (handles RHF/ROHF 2-D and UHF 3-D).

    RHF/ROHF occupations live in {0, 1, 2}: clip(occ, 0, 1) is the up
    channel and clip(occ - 1, 0, 1) the down channel, which is exactly the
    reference's determinant extraction rule
    (pyqmc/pyscftools.py:206-219 single_determinant_from_mf).
    """
    restricted = not isinstance(mo, (list, tuple)) and np.asarray(mo).ndim == 2
    if restricted:
        mo = (np.asarray(mo), np.asarray(mo))
        moe = (np.asarray(moe), np.asarray(moe))
        occ2 = np.asarray(occ)
        occ = (np.clip(occ2, 0, 1), np.clip(occ2 - 1, 0, 1))
    else:
        mo = (np.asarray(mo[0]), np.asarray(mo[1]))
        moe = (np.asarray(moe[0]), np.asarray(moe[1]))
        occ = (np.asarray(occ[0]), np.asarray(occ[1]))
    return mo, moe, occ, restricted


def from_pyscf_mf(pmf):
    """(Molecule/Cell, MeanField) from a converged pyscf SCF object.

    Covers RHF/RKS (2-D mo_coeff), ROHF (2-D with singly-occupied levels),
    and UHF/UKS (per-spin arrays) — the molecular variants of
    pyqmc/pyscftools.py:30-102 recover_pyscf.
    """
    _check_surface(pmf, ("mol", "mo_coeff", "mo_energy", "mo_occ", "e_tot"),
                   "mean-field")
    mol = from_pyscf_mol(pmf.mol)
    mo, moe, occ, restricted = _split_spin_channels(
        pmf.mo_coeff, pmf.mo_energy, pmf.mo_occ
    )
    return mol, MeanField(
        mol=mol, mo_coeff=mo, mo_energy=moe, mo_occ=occ,
        e_tot=float(pmf.e_tot), restricted=restricted,
    )


def from_pyscf_kmf(kmf, realify="auto"):
    """(Cell, KPointOrbitals) from a pyscf KRHF/KRKS object.

    mo_coeff per k is truncated to the occupied orbitals of that k-point
    (occ > 0.5 for up, > 1.5 for down in the restricted convention), the
    layout models.orbitals.KPointOrbitals consumes. realify True or "auto"
    gives the real mode at TRIM k-points, False (and "auto" elsewhere) the
    native complex orbitals; the JAX package's real-pair and embedded
    stand-ins for complex arithmetic are not ported, on purpose (ROADMAP
    queue 1 item 7), so any other value raises.
    """
    if realify not in (True, False, "auto"):
        raise ValueError(f"realify={realify!r}: the real-pair and embedded routes for complex "
                         "orbitals are not ported on purpose (ROADMAP queue 1 item 7); pass "
                         'True, False or "auto" (the native complex path)')
    _check_surface(kmf, ("cell", "kpts", "mo_coeff", "mo_occ"), "k-point SCF")
    cell = from_pyscf_mol(kmf.cell)
    kpts = np.asarray(kmf.kpts, dtype=float).reshape(-1, 3)
    mo = kmf.mo_coeff
    occ = kmf.mo_occ
    restricted = np.asarray(mo[0]).ndim == 2  # list over k of 2-D blocks
    if restricted:
        up = [np.asarray(c)[:, np.asarray(o) > 0.5] for c, o in zip(mo, occ)]
        dn = [np.asarray(c)[:, np.asarray(o) > 1.5] for c, o in zip(mo, occ)]
    else:
        up = [np.asarray(c)[:, np.asarray(o) > 0.5]
              for c, o in zip(mo[0], occ[0])]
        dn = [np.asarray(c)[:, np.asarray(o) > 0.5]
              for c, o in zip(mo[1], occ[1])]
    from ..models.orbitals import KPointOrbitals

    return cell, KPointOrbitals(cell, kpts, (up, dn), realify=realify)


def from_pyscf_mc(pmc, tol: float = 1e-9):
    """(Molecule, MeanField, DeterminantExpansion, det_coeff) from a pyscf
    CASCI/CASSCF/HCI/SCI object (duck-typed through system.ci_import, which
    handles dense CI arrays, `_strs` HCI packs, and the `large_ci` SCI
    protocol — pyqmc/pyscftools.py:252-298).
    """
    _check_surface(pmc, ("_scf", "ci"), "CASCI/HCI")
    from .ci_import import interpret_ci

    mol, mf = from_pyscf_mf(pmc._scf)
    mo = getattr(pmc, "mo_coeff", None)
    if mo is not None and np.asarray(mo).ndim == 2:
        # CASSCF rotates the orbitals; propagate them into the MeanField
        mf.mo_coeff = (np.asarray(mo), np.asarray(mo))
    expansion, det_coeff = interpret_ci(pmc, tol=tol)
    return mol, mf, expansion, det_coeff

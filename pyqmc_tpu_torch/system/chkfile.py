"""pyscf chkfile ingestion without pyscf (counterpart of
pyqmc_tpu/system/chkfile.py, a copy on the port's adapter).

pyscf checkpoint files are plain HDF5: the "mol" dataset holds
``Mole.dumps()`` — a JSON string of the Mole ``__dict__`` including the
parsed ``_atom`` table (always bohr), the internal ``_basis`` /``_ecp``
nested lists, ``charge``/``spin``, and (for Cell) the lattice ``a`` in the
input ``unit``. The "scf" group holds ``e_tot``/``mo_energy``/``mo_coeff``/
``mo_occ`` (python lists are expanded into ``<key>__from_list__`` groups
whose members are the stringified indices). CI solvers write "mcscf"
(CASCI/CASSCF: ``mo_coeff``/``ncore``/``ncas``/``nelecas``/``ci``) or "ci"
(HCI/SCI: adds ``_strs``) groups.

``recover_pyscf()`` rebuilds (Molecule/Cell, MeanField[, mc]) from those
datasets with h5py alone, so a user holding only a chkfile needs no pyscf.
The conversion is the duck-typed adapter's (system/pyscf_adapter.py): this
module only rebuilds objects with the same attribute surface from the HDF5
data. h5py is imported only where a file is opened.
"""

from __future__ import annotations

import json
import re
import types

import numpy as np

from ..method.hdftools import open_hdf

BOHR_PER_ANGSTROM = 1.0 / 0.529177210903
_LIST_SUFFIX = "__from_list__"


def _load_item(obj):
    """Dataset -> ndarray; group -> dict (pyscf chkfile list groups are
    resolved to python lists, members sorted by integer key)."""
    if not hasattr(obj, "keys"):  # an h5py Dataset
        return np.asarray(obj)
    out = {}
    for k in obj:
        if k.endswith(_LIST_SUFFIX):
            grp = obj[k]
            members = sorted(grp.keys(), key=lambda s: int(s))
            out[k[: -len(_LIST_SUFFIX)]] = [_load_item(grp[m]) for m in members]
        else:
            out[k] = _load_item(obj[k])
    return out


def load(chkfile: str, key: str):
    """pyscf.lib.chkfile.load parity: returns the ndarray/dict under `key`,
    or None when absent."""
    with open_hdf(chkfile, "r") as f:
        if key not in f:
            return None
        return _load_item(f[key])


def _clean_symbol(sym: str) -> str:
    """pyscf atom labels ('H1', 'C:2', 'GHOST-H') -> bare element symbol."""
    m = re.match(r"(?:ghost[-_]?)?([A-Za-z]{1,2})", str(sym), re.IGNORECASE)
    if not m:
        raise ValueError(f"cannot parse atom symbol {sym!r}")
    s = m.group(1)
    return s[0].upper() + s[1:].lower()


class _MolShim:
    """Duck-typed pyscf Mole/Cell surface over the chkfile's mol JSON, the
    exact attribute set system/pyscf_adapter.from_pyscf_mol consumes."""

    def __init__(self, d: dict):
        self._d = d
        atoms = d.get("_atom")
        if not atoms:
            raise ValueError(
                "chkfile mol JSON lacks the parsed _atom table; was the "
                "Mole built before saving?"
            )
        self._atoms = atoms  # [[sym, [x, y, z]], ...] in bohr
        self._basis = d.get("_basis") or {}
        if not self._basis:
            raise ValueError("chkfile mol JSON lacks the parsed _basis table")
        self._ecp = d.get("_ecp") or {}
        self.spin = int(d.get("spin") or 0)
        self.charge = int(d.get("charge") or 0)
        self.natm = len(self._atoms)
        self.a = d.get("a")  # not None for pbc Cells

    def atom_symbol(self, i):
        return _clean_symbol(self._atoms[i][0])

    def atom_coord(self, i):
        return np.asarray(self._atoms[i][1], dtype=float)

    def lattice_vectors(self):
        a = self.a
        if isinstance(a, str):
            rows = [r for r in a.replace(";", "\n").splitlines() if r.strip()]
            a = [[float(x) for x in r.replace(",", " ").split()] for r in rows]
        a = np.asarray(a, dtype=float)
        # Cell interprets `a` in the input unit (default angstrom);
        # _atom is always bohr
        unit = str(self._d.get("unit", "angstrom"))
        if unit.lower().startswith("a"):
            a = a * BOHR_PER_ANGSTROM
        return a


def _read_shim(chkfile: str) -> _MolShim:
    with open_hdf(chkfile, "r") as f:
        d = json.loads(np.asarray(f["mol"])[()])
    shim = _MolShim(d)
    # _basis/_ecp keys may carry labels ('H1'); fold them to bare symbols
    shim._basis = {_clean_symbol(k): v for k, v in shim._basis.items()}
    shim._ecp = {_clean_symbol(k): v for k, v in shim._ecp.items()}
    return shim


def read_mol(chkfile: str):
    """Molecule/Cell from the chkfile's mol JSON (basis/ECP digit-exact
    from the parsed internal tables)."""
    from .pyscf_adapter import from_pyscf_mol

    return from_pyscf_mol(_read_shim(chkfile))


def _mc_shim(casdict: dict):
    """Namespace with the attribute surface ci_import.interpret_ci
    duck-types on (ci, ncas, nelecas, ncore [, _strs])."""
    mc = types.SimpleNamespace()
    for k, v in casdict.items():
        setattr(mc, k, v)
    if hasattr(mc, "nelecas"):
        ne = np.asarray(mc.nelecas).ravel()
        mc.nelecas = (int(ne[0]), int(ne[-1]))
    if hasattr(mc, "ncore"):
        mc.ncore = int(np.asarray(mc.ncore))
    if hasattr(mc, "ncas"):
        mc.ncas = int(np.asarray(mc.ncas))
    return mc


def recover_pyscf(chkfile: str, ci_checkfile: str = None):
    """(mol, mf) — or (mol, mf, mc) with `ci_checkfile` — from pyscf HDF5
    checkpoints, without pyscf.

    mol is the port's Molecule/Cell; mf a system.scf.MeanField
    (RHF/ROHF 1-D mo_occ and UHF 2-D mo_occ layouts, reference detection
    rule pyscftools.py:49-61). mc is a duck-typed CASCI/HCI namespace
    consumable by wftools.generate_wf(mc=...) / ci_import.interpret_ci;
    a CASSCF-rotated mo_coeff in the CI chkfile is propagated into mf
    (pyscftools.py:95-99 semantics). k-point (KRHF) chkfiles raise with
    guidance — use the live-object adapter for those.
    """
    from .pyscf_adapter import from_pyscf_mf

    shim = _read_shim(chkfile)
    scf = load(chkfile, "scf")
    if scf is None or "mo_coeff" not in scf:
        raise ValueError(f"{chkfile}: no scf/mo_coeff group — not a pyscf "
                         "SCF checkpoint")
    if isinstance(scf["mo_coeff"], list) or "kpts" in scf:
        raise NotImplementedError(
            "k-point SCF chkfiles are not supported yet; rebuild with "
            "pyscf and use system.pyscf_adapter.from_pyscf_kmf"
        )
    mf_shim = types.SimpleNamespace(
        mol=shim,
        mo_coeff=np.asarray(scf["mo_coeff"]),
        mo_energy=np.asarray(scf["mo_energy"]),
        mo_occ=np.asarray(scf["mo_occ"]),
        e_tot=float(np.asarray(scf["e_tot"])),
    )
    if mf_shim.mo_coeff.ndim == 3:  # UHF: (2, nao, nmo) arrays
        mf_shim.mo_coeff = (mf_shim.mo_coeff[0], mf_shim.mo_coeff[1])
        mf_shim.mo_energy = (mf_shim.mo_energy[0], mf_shim.mo_energy[1])
        mf_shim.mo_occ = (mf_shim.mo_occ[0], mf_shim.mo_occ[1])
    mol, mf = from_pyscf_mf(mf_shim)

    if ci_checkfile is None:
        return mol, mf
    casdict = load(ci_checkfile, "ci")
    if casdict is None:
        casdict = load(ci_checkfile, "mcscf")
    if casdict is None:
        raise ValueError(
            f"{ci_checkfile}: neither 'ci' nor 'mcscf' group present — not "
            "a pyscf CASCI/HCI checkpoint"
        )
    mc = _mc_shim(casdict)
    mo = getattr(mc, "mo_coeff", None)
    if mo is not None and np.asarray(mo).ndim == 2:
        # CASSCF rotates the orbitals; propagate them into the MeanField
        mf.mo_coeff = (np.asarray(mo), np.asarray(mo))
    return mol, mf, mc

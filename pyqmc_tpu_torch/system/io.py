"""System + mean-field checkpoints (counterpart of pyqmc_tpu/system/io.py).

`save_system` and `load_system` write and read a Molecule or Cell and its
SCF solution under the groups "system" and "scf" of an open h5py File, the
JAX package's layout, so either package reads the other's files. A
machine without h5py (the GPU machine) reads an `.npz` holding the same
datasets under the same names instead, with the two JSON blobs (basis,
ECP) stored as numpy unicode strings so that `np.load(allow_pickle=False)`
reads every entry. `convert_hdf5_to_npz` makes the `.npz` once from an
HDF5 checkpoint; h5py is imported only where a file is opened.

    python -m pyqmc_tpu_torch.system.io SRC.hdf5 DST.npz

Periodic cells come in the format of the JAX package's test fixtures
(`load_cell_npz`): a primitive cell with its pyscf-format basis and ECP as
JSON bytes, the lattice, the k-points and the per-k MO coefficients.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .basis import Shell
from .mole import Cell, Molecule
from .scf import MeanField

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
H2O_CCECP = os.path.join(DATA_DIR, "h2o_ccecp-ccpvdz_ccecp_scf.npz")
# the full-valence CASCI(8e,8o) expansion of that H2O (1,098 determinants
# over its first 8 MOs), written by tools/h2o_casci_data.py with the JAX
# package's run_casci
H2O_CAS88 = os.path.join(DATA_DIR, "h2o_ccecp_cas88.npz")
# two- and three-body Jastrow coefficients of that H2O (acoeff, bcoeff,
# ccoeff), optimized by the JAX package with tools/h2o_j3_jax_reference.py
H2O_J3_PARAMS = os.path.join(DATA_DIR, "h2o_j3_params.npz")
# KRKS diamond-C primitive cell, ccECP, 2x2x2 TRIM k-mesh (a byte-for-byte
# copy of the JAX package's test fixture tests/files/diamond_primitive.npz)
DIAMOND_PRIMITIVE = os.path.join(DATA_DIR, "diamond_primitive.npz")

_SYSTEM_KEYS = ("atom_symbols", "atom_coords", "charge", "spin", "basis_json", "ecp_json")
_SCF_KEYS = ("mo_coeff_alpha", "mo_coeff_beta", "mo_energy_alpha", "mo_energy_beta",
             "mo_occ_alpha", "mo_occ_beta", "e_tot", "restricted")


def _basis_to_json(basis):
    return json.dumps({el: [[s.l] + [[e, c] for e, c in zip(s.exps, s.coeffs)] for s in shells]
                       for el, shells in basis.items()})


def save_system(f, mol, mf: MeanField = None):
    """Write mol under the group "system" (and mf under "scf") of an open
    h5py File. The basis is stored with its normalized coefficients, which
    load_system takes as they are."""
    g = f.require_group("system")

    def put(grp, name, data):
        if name in grp:
            del grp[name]
        grp.create_dataset(name, data=data)

    put(g, "atom_symbols", np.array(mol.atom_symbols, dtype="S4"))
    put(g, "atom_coords", mol.atom_coords)
    put(g, "charge", mol.charge)
    put(g, "spin", mol.spin)
    put(g, "basis_json", np.bytes_(_basis_to_json(mol.basis)))
    put(g, "ecp_json", np.bytes_(json.dumps(mol.ecp)))
    if mol.lattice is not None:
        put(g, "lattice", mol.lattice)
    if mf is not None:
        s = f.require_group("scf")
        for i, spin in enumerate(("alpha", "beta")):
            put(s, f"mo_coeff_{spin}", np.asarray(mf.mo_coeff[i]))
            put(s, f"mo_energy_{spin}", np.asarray(mf.mo_energy[i]))
            put(s, f"mo_occ_{spin}", np.asarray(mf.mo_occ[i]))
        put(s, "e_tot", mf.e_tot)
        put(s, "restricted", mf.restricted)


def load_system(f):
    """(mol, mf or None) from an open h5py File written by save_system (of
    either package): a Cell where the file holds a lattice."""
    g = f["system"]
    atoms = list(zip([s.decode() for s in np.asarray(g["atom_symbols"])],
                     np.asarray(g["atom_coords"])))
    kwargs = dict(basis=basis_from_json(bytes(np.asarray(g["basis_json"])).decode()),
                  ecp=json.loads(bytes(np.asarray(g["ecp_json"])).decode()) or None,
                  charge=int(np.asarray(g["charge"])), spin=int(np.asarray(g["spin"])))
    if "lattice" in g:
        mol = Cell(atoms, lattice=np.asarray(g["lattice"]), **kwargs)
    else:
        mol = Molecule(atoms, **kwargs)
    mf = None
    if "scf" in f:
        s = f["scf"]
        pair = lambda name: (np.asarray(s[f"{name}_alpha"]), np.asarray(s[f"{name}_beta"]))
        mf = MeanField(mol=mol, mo_coeff=pair("mo_coeff"), mo_energy=pair("mo_energy"),
                       mo_occ=pair("mo_occ"), e_tot=float(np.asarray(s["e_tot"])),
                       restricted=bool(np.asarray(s["restricted"])))
    return mol, mf


def convert_hdf5_to_npz(src: str, dst: str) -> None:
    """Copy a `save_system` HDF5 checkpoint (groups 'system', 'scf') to an
    `.npz` with string datasets as numpy unicode."""
    from ..method.hdftools import open_hdf

    out = {}
    with open_hdf(src, "r") as f:
        g = f["system"]
        out["atom_symbols"] = np.array([s.decode() for s in np.asarray(g["atom_symbols"])])
        out["atom_coords"] = np.asarray(g["atom_coords"], dtype=np.float64)
        out["charge"] = np.asarray(g["charge"])
        out["spin"] = np.asarray(g["spin"])
        for name in ("basis_json", "ecp_json"):
            out[name] = np.str_(bytes(np.asarray(g[name])).decode())
        if "lattice" in g:
            raise ValueError(f"{src}: periodic cells are not supported by the port yet")
        s = f["scf"]
        for name in _SCF_KEYS:
            out[name] = np.asarray(s[name])
    np.savez(dst, **out)


def basis_from_json(text: str):
    """{element: [Shell]} from the JSON written by the JAX package's
    `_basis_to_json`: per element a list of [l, [exp, coeff], ...]."""
    raw = json.loads(text)
    return {
        el: [
            Shell(l=int(entry[0]), exps=tuple(float(p[0]) for p in entry[1:]),
                  coeffs=tuple(float(p[1]) for p in entry[1:]))
            for entry in entries
        ]
        for el, entries in raw.items()
    }


def load_cell_npz(path: str = DIAMOND_PRIMITIVE):
    """(Cell, {"kpts" (nk, 3), "mo_coeff" (nk, nao, nmo) complex, "mo_occ"
    (nk, nmo), "e_tot"}) from a periodic `.npz` (keys basis_json, ecp_json,
    atom_symbols, atom_coords, lattice, spin, kpts, mo_coeff, mo_occ,
    e_tot)."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    ecp = json.loads(bytes(d["ecp_json"]).decode())
    symbols = [s.decode() if isinstance(s, bytes) else str(s) for s in d["atom_symbols"]]
    cell = Cell(list(zip(symbols, d["atom_coords"])), d["lattice"],
                basis=json.loads(bytes(d["basis_json"]).decode()), ecp=ecp or None,
                spin=int(d["spin"]))
    return cell, {"kpts": d["kpts"], "mo_coeff": d["mo_coeff"], "mo_occ": d["mo_occ"],
                  "e_tot": float(d["e_tot"])}


def load_expansion_npz(path: str = H2O_CAS88):
    """A determinant expansion written by tools/h2o_casci_data.py, as a dict
    of numpy arrays and floats: occ_up, occ_dn, map_up, map_dn (int64),
    det_coeff, e_casci and e_hf (Ha), ncas, nelecas, tol."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    out = {k: np.asarray(d[k], dtype=np.int64) for k in ("occ_up", "occ_dn", "map_up", "map_dn")}
    out.update(det_coeff=np.asarray(d["det_coeff"], dtype=np.float64),
               e_casci=float(d["e_casci"]), e_hf=float(d["e_hf"]), ncas=int(d["ncas"]),
               nelecas=tuple(int(n) for n in d["nelecas"]), tol=float(d["tol"]))
    return out


def load_npz(path: str = H2O_CCECP):
    """(Molecule, MeanField) from an `.npz` written by `convert_hdf5_to_npz`."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in _SYSTEM_KEYS + _SCF_KEYS}
    mol = Molecule(
        list(zip([str(s) for s in d["atom_symbols"]], d["atom_coords"])),
        basis=basis_from_json(str(d["basis_json"])),
        ecp=json.loads(str(d["ecp_json"])) or None,
        charge=int(d["charge"]), spin=int(d["spin"]),
    )
    mf = MeanField(
        mol=mol,
        mo_coeff=(d["mo_coeff_alpha"], d["mo_coeff_beta"]),
        mo_energy=(d["mo_energy_alpha"], d["mo_energy_beta"]),
        mo_occ=(d["mo_occ_alpha"], d["mo_occ_beta"]),
        e_tot=float(d["e_tot"]),
        restricted=bool(d["restricted"]),
    )
    return mol, mf


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 3:
        raise SystemExit("usage: python -m pyqmc_tpu_torch.system.io SRC.hdf5 DST.npz")
    convert_hdf5_to_npz(sys.argv[1], sys.argv[2])

"""System + mean-field checkpoints as `.npz` (counterpart of
pyqmc_tpu/system/io.py).

The JAX package writes a molecule and its SCF solution to HDF5
(`save_system`). The machine the port runs on has no h5py, so the port reads
an `.npz` holding the same datasets under the same names, with the two JSON
blobs (basis, ECP) stored as numpy unicode strings so that
`np.load(allow_pickle=False)` reads every entry. `convert_hdf5_to_npz` makes
the `.npz` once from an HDF5 checkpoint; it imports h5py only when called.

    python -m pyqmc_tpu_torch.system.io SRC.hdf5 DST.npz

Periodic cells come in the format of the JAX package's test fixtures
(`load_cell_npz`): a primitive cell with its pyscf-format basis and ECP as
JSON bytes, the lattice, the k-points and the per-k MO coefficients.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..ops.harmonics import normalize_contraction
from .mole import Cell, MeanField, Molecule, Shell

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
H2O_CCECP = os.path.join(DATA_DIR, "h2o_ccecp-ccpvdz_ccecp_scf.npz")
# KRKS diamond-C primitive cell, ccECP, 2x2x2 TRIM k-mesh (a byte-for-byte
# copy of the JAX package's test fixture tests/files/diamond_primitive.npz)
DIAMOND_PRIMITIVE = os.path.join(DATA_DIR, "diamond_primitive.npz")

_SYSTEM_KEYS = ("atom_symbols", "atom_coords", "charge", "spin", "basis_json", "ecp_json")
_SCF_KEYS = ("mo_coeff_alpha", "mo_coeff_beta", "mo_energy_alpha", "mo_energy_beta",
             "mo_occ_alpha", "mo_occ_beta", "e_tot", "restricted")


def convert_hdf5_to_npz(src: str, dst: str) -> None:
    """Copy a `save_system` HDF5 checkpoint (groups 'system', 'scf') to an
    `.npz` with string datasets as numpy unicode."""
    import h5py

    out = {}
    with h5py.File(src, "r") as f:
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


def basis_from_pyscf_json(text: str):
    """{element: [Shell]} from pyscf-format JSON, per element a list of
    [l, [exp, c1, c2, ...], ...]; every coefficient column becomes a shell,
    normalised as pyscf does (system/basis.py:parse_pyscf_basis)."""
    out = {}
    for el, entries in json.loads(text).items():
        shells = []
        for entry in entries:
            l = int(entry[0])
            prims = np.asarray(entry[1:], dtype=np.float64)
            for col in range(1, prims.shape[1]):
                keep = prims[:, col] != 0.0
                if np.any(keep):
                    c = normalize_contraction(l, prims[keep, 0], prims[keep, col])
                    shells.append(Shell(l=l, exps=tuple(float(e) for e in prims[keep, 0]),
                                        coeffs=tuple(float(x) for x in c)))
        out[el] = shells
    return out


def load_cell_npz(path: str = DIAMOND_PRIMITIVE):
    """(Cell, {"kpts" (nk, 3), "mo_coeff" (nk, nao, nmo) complex, "e_tot"})
    from a periodic `.npz` (keys basis_json, ecp_json, atom_symbols,
    atom_coords, lattice, spin, kpts, mo_coeff, e_tot)."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in z.files}
    ecp = json.loads(bytes(d["ecp_json"]).decode())
    cell = Cell([s.decode() if isinstance(s, bytes) else str(s) for s in d["atom_symbols"]],
                d["atom_coords"], basis_from_pyscf_json(bytes(d["basis_json"]).decode()),
                d["lattice"], ecp=ecp or None, spin=int(d["spin"]))
    return cell, {"kpts": d["kpts"], "mo_coeff": d["mo_coeff"], "e_tot": float(d["e_tot"])}


def load_npz(path: str = H2O_CCECP):
    """(Molecule, MeanField) from an `.npz` written by `convert_hdf5_to_npz`."""
    with np.load(path, allow_pickle=False) as z:
        d = {k: z[k] for k in _SYSTEM_KEYS + _SCF_KEYS}
    mol = Molecule(
        [str(s) for s in d["atom_symbols"]], d["atom_coords"],
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

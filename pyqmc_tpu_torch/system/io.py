"""System + mean-field checkpoints as `.npz` (counterpart of
pyqmc_tpu/system/io.py).

The JAX package writes a molecule and its SCF solution to HDF5
(`save_system`). The machine the port runs on has no h5py, so the port reads
an `.npz` holding the same datasets under the same names, with the two JSON
blobs (basis, ECP) stored as numpy unicode strings so that
`np.load(allow_pickle=False)` reads every entry. `convert_hdf5_to_npz` makes
the `.npz` once from an HDF5 checkpoint; it imports h5py only when called.

    python -m pyqmc_tpu_torch.system.io SRC.hdf5 DST.npz
"""

from __future__ import annotations

import json
import os

import numpy as np

from .mole import MeanField, Molecule, Shell

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
H2O_CCECP = os.path.join(DATA_DIR, "h2o_ccecp-ccpvdz_ccecp_scf.npz")

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

"""The full-valence CASCI(8e,8o) expansion of ccECP/cc-pVDZ H2O, from the JAX
package (pyqmc_tpu.system.casci.run_casci) on the committed SCF checkpoint,
written as an .npz that the PyTorch port reads with numpy only.

    python tools/h2o_casci_data.py [DST.npz]

DST defaults to pyqmc_tpu_torch/data/h2o_ccecp_cas88.npz. Entries: occ_up,
occ_dn (unique spin-determinants, orbital indices into the first ncas MOs),
map_up, map_dn (per determinant, into those), det_coeff, e_casci, e_hf
(Ha), ncas, nelecas and tol (run_casci's coefficient cut). About 20 s on
one CPU core.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import h5py
import numpy as np

SRC = os.path.join(ROOT, "benchmarks", "h2o_ccecp-ccpvdz_ccecp_scf.hdf5")
DST = os.path.join(ROOT, "pyqmc_tpu_torch", "data", "h2o_ccecp_cas88.npz")
NCAS, NELECAS, TOL = 8, (4, 4), 1e-6


def main(dst=DST):
    from pyqmc_tpu.system.casci import run_casci
    from pyqmc_tpu.system.io import load_system

    with h5py.File(SRC, "r") as f:
        mol, mf = load_system(f)
    t0 = time.perf_counter()
    energies, roots = run_casci(mf, ncas=NCAS, nelecas=NELECAS, tol=TOL)
    exp, coeff = roots[0]
    np.savez(dst, occ_up=np.asarray(exp.occ_up, dtype=np.int64),
             occ_dn=np.asarray(exp.occ_dn, dtype=np.int64),
             map_up=np.asarray(exp.map_up, dtype=np.int64),
             map_dn=np.asarray(exp.map_dn, dtype=np.int64),
             det_coeff=np.asarray(coeff, dtype=np.float64), e_casci=float(energies[0]),
             e_hf=float(mf.e_tot), ncas=NCAS, nelecas=np.asarray(NELECAS), tol=TOL)
    print(f"{len(coeff)} determinants from {exp.occ_up.shape[0]} x {exp.occ_dn.shape[0]} unique "
          f"spin-determinants; E_CASCI {energies[0]:.6f}, E_HF {mf.e_tot:.6f} Ha; "
          f"{time.perf_counter() - t0:.1f} s; wrote {dst}")


if __name__ == "__main__":
    main(*sys.argv[1:])

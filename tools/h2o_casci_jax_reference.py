"""Reference VMC energy of the multi-Slater-Jastrow H2O configuration from
the JAX package (pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/h2o_casci_jax_reference.py [nconfig] [nblocks] [nwarm] [nruns]

The configuration is that of pyqmc_tpu_torch.entry.h2o_casci_setup: the
committed ccECP/cc-pVDZ H2O checkpoint, the full-valence CASCI(8e,8o)
expansion of pyqmc_tpu_torch/data/h2o_ccecp_cas88.npz (1,098
determinants over the first 8 MOs) times JastrowSpin with its default
parameters, the energy with the dense nonlocal ECP, tstep 0.5, 50-step
blocks. Each of `nruns` runs starts from its own walkers and drops its
first `nwarm` blocks. Prints every block's energy and acceptance, then one
JSON line: the mean over the runs' kept blocks, its standard error (over
the runs' means, or from reblocking the one run into up to 8 groups
(pyqmc_tpu.reblock)), and the mean acceptance.
"""

import json
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

H2O = os.path.join(ROOT, "benchmarks", "h2o_ccecp-ccpvdz_ccecp_scf.hdf5")
CAS = os.path.join(ROOT, "pyqmc_tpu_torch", "data", "h2o_ccecp_cas88.npz")


def main(nconfig=128, nblocks=8, nwarm=2, nruns=1, nsteps=50, seed=3):
    from pyqmc_tpu.configs import Geometry, initial_guess
    from pyqmc_tpu.method.vmc import make_vmc_block
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.reblock import reblock_summary
    from pyqmc_tpu.system.io import load_system

    with h5py.File(H2O, "r") as f:
        mol, mf = load_system(f)
    d = np.load(CAS)
    exp = DeterminantExpansion(occ_up=d["occ_up"], occ_dn=d["occ_dn"], map_up=d["map_up"],
                               map_dn=d["map_dn"])
    ca = np.asarray(mf.mo_coeff[0])[:, :int(d["ncas"])]
    wf = MultiplyWF(Slater(mol, None, exp, (ca, ca), det_coeff=d["det_coeff"]),
                    JastrowSpin(mol))
    params = wf.make_params()
    block = make_vmc_block(wf, {"energy": EnergyAccumulator(mol)}, Geometry(None), tstep=0.5,
                           nsteps=nsteps, fused=False)
    t0 = time.perf_counter()
    means, kept, accs = [], [], []
    for run in range(nruns):
        configs = initial_guess(mol, nconfig, key=jax.random.PRNGKey(seed + 2 * run))
        pos, wrap = configs.positions, configs.wrap
        key = jax.random.PRNGKey(seed + 2 * run + 1)
        rows = []
        for b in range(nblocks):
            key, bk = jax.random.split(key)
            pos, wrap, avg = block(params, pos, wrap, bk)
            rows.append((float(avg["energytotal"]), float(avg["acceptance"])))
            print(f"run {run} block {b}: E {rows[-1][0]:.6f} acc {rows[-1][1]:.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        e = np.array([r[0] for r in rows[nwarm:]])
        kept.append(e)
        means.append(float(np.mean(e)))
        accs += [r[1] for r in rows[nwarm:]]
    if nruns > 1:
        sem = float(np.std(means, ddof=1) / np.sqrt(nruns))
    else:
        sem = float(reblock_summary(kept[0], nblocks=min(8, len(kept[0])))["standard error"])
    print(json.dumps({"nconfig": nconfig, "nblocks": nblocks, "nwarm": nwarm, "nruns": nruns,
                      "nsteps": nsteps, "e_mean": float(np.mean(np.concatenate(kept))),
                      "e_sem": sem, "run_means": means, "acceptance": float(np.mean(accs)),
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])

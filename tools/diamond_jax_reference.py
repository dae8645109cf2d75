"""Reference VMC energy of the periodic diamond-C configuration from the JAX
package (pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/diamond_jax_reference.py [nconfig] [nblocks] [nwarm]

The configuration is that of benchmarks/c_solid_benchmark.py:e2e_vmc
(TRIM branch) and of pyqmc_tpu_torch.entry.diamond_setup: the 2x2x2
supercell of the fixture's primitive cell, k-point Slater x default
periodic Jastrow, Ewald and the downselected ECP, tstep 0.5, 10-step
blocks. Prints each block's energy per primitive cell and acceptance, then
the mean over the blocks after `nwarm` with its standard error from
reblocking into 8 groups (pyqmc_tpu.reblock), as one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np


def main(nconfig=64, nblocks=24, nwarm=4, nsteps=10, seed=3):
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.vmc import make_vmc_block
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.models.orbitals import KPointOrbitals
    from pyqmc_tpu.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.reblock import reblock_summary
    from pyqmc_tpu.system.supercell import get_supercell
    from pyqmc_tpu.wftools import default_jastrow_basis
    from tests.fixtures_pbc import load_cell

    cell, d = load_cell("diamond_primitive")
    sup = get_supercell(cell, 2 * np.eye(3, dtype=int))
    kpts = np.asarray(d["kpts"])
    blocks = [np.asarray(d["mo_coeff"][k])[:, :4] for k in range(len(kpts))]
    orb = KPointOrbitals(cell, kpts, (blocks, blocks), img_tol=1e-4)
    a_b, b_b = default_jastrow_basis(sup)
    wf = MultiplyWF(Slater(sup, orb, DeterminantExpansion.single(32, 32)),
                    JastrowSpin(sup, a_basis=a_b, b_basis=b_b))
    params = wf.make_params()
    configs = initial_guess(sup, nconfig, key=jax.random.PRNGKey(seed))
    block = make_vmc_block(wf, {"energy": EnergyAccumulator(sup)}, configs.geometry, tstep=0.5,
                           nsteps=nsteps, fused=False)
    pos, wrap = configs.positions, configs.wrap
    key = jax.random.PRNGKey(seed + 1)
    rows = []
    t0 = time.perf_counter()
    for b in range(nblocks):
        key, bk = jax.random.split(key)
        pos, wrap, avg = block(params, pos, wrap, bk)
        e_cell, acc = float(avg["energytotal"]) / 8, float(avg["acceptance"])
        rows.append((e_cell, acc))
        print(f"block {b}: E/cell {e_cell:.6f} acc {acc:.4f} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    e = np.array([r[0] for r in rows[nwarm:]])
    summ = reblock_summary(e, nblocks=min(8, len(e)))
    print(json.dumps({"nconfig": nconfig, "nblocks": nblocks, "nwarm": nwarm, "nsteps": nsteps,
                      "e_cell_mean": float(np.mean(e)), "e_cell_sem": float(summ["standard error"]),
                      "acceptance": float(np.mean([r[1] for r in rows[nwarm:]])),
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

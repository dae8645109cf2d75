"""Reference DMC energy of the periodic diamond-C configuration from the JAX
package (pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/diamond_dmc_jax_reference.py [nconfig nrepeats nblocks nwarm nlast nworkers]

The configuration is that of tools/diamond_jax_reference.py and of
pyqmc_tpu_torch.entry.diamond_setup: the 2x2x2 supercell of the fixture's
primitive cell, k-point Slater x default periodic Jastrow, Ewald and the
ECP downselected to 24 of 96 points for the energy. The schedule is that
of chip_smoke.py's periodic DMC phase: `pyqmc_tpu.method.dmc.rundmc` with
`nwarm` VMC warm-up blocks (10 steps at tstep 0.5), then `nblocks` DMC
blocks of 10 steps at tstep 0.02 with T-moves. Each of `nrepeats`
independent runs (its own walkers and key; `nworkers` processes side by
side) gives the mean energy per primitive cell of its last `nlast` blocks,
that of its warm-up VMC walkers (the mean local energy that sets e_trial),
and each block's mean weight; each run prints one JSON line, then the
runs' means, the standard error of the energy over the runs and each
block's weight (geometric mean over the runs) are printed as one more.
"""

import json
import multiprocessing
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

NCELL = 8  # primitive cells in the 2x2x2 supercell


def setup():
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.models.orbitals import KPointOrbitals
    from pyqmc_tpu.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
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
    return sup, wf, EnergyAccumulator(sup)


def run_one(args):
    """One independent rundmc run; returns its per-block numbers."""
    r, nconfig, nblocks, nwarm, nlast, tstep, seed = args
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.dmc import rundmc

    sup, wf, energy = setup()
    ecp = energy.ecp_acc
    assert ecp.nselect == 24 and ecp.nq_total == 96, (ecp.nselect, ecp.nq_total)
    t0 = time.perf_counter()
    configs = initial_guess(sup, nconfig, key=jax.random.PRNGKey(seed + 100 * r))
    blocks, _, _ = rundmc(
        wf, wf.make_params(), configs, nblocks=nblocks, nsteps_per_block=10, tstep=tstep,
        energy_acc=energy, key=jax.random.PRNGKey(seed + 100 * r + 1), warmup_vmc_blocks=nwarm)
    e = [float(b["energytotal"]) / NCELL for b in blocks]
    # the warm-up walkers' mean local energy: after block 0, e_est is the
    # mean of it and block 0's energy
    e_warm = (2 * float(blocks[0]["e_est"]) - float(blocks[0]["energytotal"])) / NCELL
    out = {"run": r, "e_cell_last": float(np.mean(e[-nlast:])), "e_vmc_cell": e_warm,
           "e_cell_blocks": e, "weights": [float(b["weight"]) for b in blocks],
           "acceptance": float(np.mean([float(b["acceptance"]) for b in blocks[-nlast:]])),
           "block_seconds": [float(b["block time"]) for b in blocks],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


def main(nconfig=32, nrepeats=4, nblocks=8, nwarm=4, nlast=4, nworkers=1, tstep=0.02, seed=3):
    t0 = time.perf_counter()
    tasks = [(r, nconfig, nblocks, nwarm, nlast, tstep, seed) for r in range(nrepeats)]
    if nworkers > 1:
        with multiprocessing.get_context("spawn").Pool(nworkers) as pool:
            runs = pool.map(run_one, tasks, chunksize=1)
    else:
        runs = [run_one(t) for t in tasks]
    last = np.array([x["e_cell_last"] for x in runs])
    sem = float(np.std(last, ddof=1) / np.sqrt(len(last))) if len(last) > 1 else float("nan")
    logw = np.log(np.array([x["weights"] for x in runs]))
    print(json.dumps({
        "nconfig": nconfig, "nrepeats": nrepeats, "nblocks": nblocks, "nwarm": nwarm,
        "nlast": nlast, "nsteps": 10, "tstep": tstep,
        "e_cell_mean": float(np.mean(last)), "e_cell_sem": sem,
        "e_vmc_cell_mean": float(np.mean([x["e_vmc_cell"] for x in runs])),
        "acceptance": float(np.mean([x["acceptance"] for x in runs])),
        "e_cell_blocks_mean": np.mean([x["e_cell_blocks"] for x in runs], axis=0).tolist(),
        # each block's mean weight, the geometric mean over the runs
        "weight_blocks": np.exp(np.mean(logw, axis=0)).tolist(),
        "weight_blocks_max": np.max(np.exp(logw), axis=0).tolist(),
        "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)

"""Reference optimized Slater-Jastrow VMC energy of ccECP H2O from the JAX
package (pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/h2o_opt_jax_reference.py [nconfig] [nruns] [max_iterations] [seed] [dmc]

The schedule is that of chip_smoke.py's phase 17 (recipes.OPTIMIZE's, with
tools/h2o_anchor.py's 20 iterations): the committed ccECP/cc-pVDZ H2O
checkpoint, generate_wf(mol, mf) (the two-body Jastrow of
generate_jastrow's defaults, 33 free coefficients, the Slater frozen), the
energy with the dense nonlocal ECP; 4 x 10 VMC steps of equilibration,
line_minimization with its defaults, then 6 x 50 VMC steps at tstep 0.5
from the optimizer's walkers, the mean of the blocks after the first. With
dmc = 1, phase 18's schedule follows from the VMC's walkers: rundmc with 2
VMC warm-up blocks and 30 x 10 steps at tstep 0.02 with T-moves, the mean
of blocks 11-30. Each of `nruns` runs starts from its own walkers and
keys. Prints every iteration and block, then one JSON line: the means over
the runs, their standard errors (over the runs' means with more than one
run, else from the kept blocks' scatter, the DMC's reblocked into 8
groups), and the wall time.
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

NWARM_BLOCKS, NWARM_STEPS = 4, 10
VMC_BLOCKS, VMC_STEPS = 6, 50
DMC_WARMUP, DMC_BLOCKS, DMC_SKIP, DMC_TSTEP = 2, 30, 10, 0.02


def sem_of(means, kept, nblocks=None):
    """The standard error of the runs' mean: over the runs' means with more
    than one run, else from the one run's kept blocks (reblocked into
    `nblocks` groups when given)."""
    from pyqmc_tpu.reblock import reblock_summary

    if len(means) > 1:
        return float(np.std(means, ddof=1) / np.sqrt(len(means)))
    if nblocks:
        return float(reblock_summary(kept[0], nblocks=nblocks)["standard error"])
    return float(np.std(kept[0], ddof=1) / np.sqrt(len(kept[0])))


def main(nconfig=256, nruns=1, max_iterations=20, seed=11, dmc=0):
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.dmc import rundmc
    from pyqmc_tpu.method.linemin import line_minimization
    from pyqmc_tpu.method.vmc import vmc
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.observables.transform import LinearTransform
    from pyqmc_tpu.system.io import load_system
    from pyqmc_tpu.wftools import generate_wf

    with h5py.File(H2O, "r") as f:
        mol, mf = load_system(f)
    wf, params0, to_opt = generate_wf(mol, mf)
    energy = EnergyAccumulator(mol)
    transform = LinearTransform(params0, to_opt)
    t0 = time.perf_counter()
    means, kept, finals, dmeans, dkept = [], [], [], [], []
    for run in range(nruns):
        s = seed + 10 * run
        configs = initial_guess(mol, nconfig, key=jax.random.PRNGKey(s))
        _, configs = vmc(wf, params0, configs, nblocks=NWARM_BLOCKS,
                         nsteps_per_block=NWARM_STEPS, key=jax.random.PRNGKey(s + 1))
        params, configs, records = line_minimization(
            wf, params0, configs, transform, energy, key=jax.random.PRNGKey(s + 2),
            max_iterations=max_iterations)
        for r in records:
            print(f"run {run} iteration {r['iteration']}: E {r['energy']:.6f} "
                  f"+- {r['energy_err']:.6f} |g| {r['gnorm']:.4f} tau {r['tau']} "
                  f"stalled {r['stalled']} ({time.perf_counter() - t0:.1f} s)", flush=True)
        data, configs = vmc(wf, params, configs, nblocks=VMC_BLOCKS, nsteps_per_block=VMC_STEPS,
                            accumulators={"energy": energy}, key=jax.random.PRNGKey(s + 3))
        e = np.array([float(d["energytotal"]) for d in data])
        for b, x in enumerate(e):
            print(f"run {run} VMC block {b}: E {x:.6f} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        kept.append(e[1:])
        means.append(float(np.mean(e[1:])))
        finals.append(float(records[-1]["energy"]))
        if dmc:
            ddata, _, _ = rundmc(wf, params, configs, nblocks=DMC_BLOCKS, nsteps_per_block=10,
                                 tstep=DMC_TSTEP, energy_acc=energy,
                                 key=jax.random.PRNGKey(s + 4), warmup_vmc_blocks=DMC_WARMUP)
            ed = np.array([float(d["energytotal"]) for d in ddata])
            for b, (x, d) in enumerate(zip(ed, ddata)):
                print(f"run {run} DMC block {b}: E {x:.6f} w {float(d['weight']):.5f} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
            dkept.append(ed[DMC_SKIP:])
            dmeans.append(float(np.mean(ed[DMC_SKIP:])))
    out = {"nconfig": nconfig, "nruns": nruns, "max_iterations": max_iterations, "seed": seed,
           "e_mean": float(np.mean(means)), "e_sem": sem_of(means, kept), "run_means": means,
           "last_iteration_energies": finals}
    if dmc:
        out.update({"dmc_mean": float(np.mean(dmeans)), "dmc_sem": sem_of(dmeans, dkept, 8),
                    "dmc_run_means": dmeans})
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])

"""Reference run of the complex-orbital optimization, from the JAX package
(pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/complex_opt_jax_reference.py [nconfig nruns max_iterations sr_blocks seed nworkers]

The schedule is that of chip_smoke.py's phase 35, the set-up that of
tests/integration/test_complex_linemin.py on ccECP/cc-pVDZ H2O: the
molecule from the geometry string of `__graft_entry__._h2o_setup` with the
package's own basis and ECP library, its own run_scf; the occupied MO
coefficients of both spins multiplied by i plus real noise uniform in
[-0.1, 0.1) (numpy default_rng(7), the up block first); the wavefunction
MultiplyWF(Slater, JastrowSpin(mol)); both spins' mo_coeff and the
Jastrow's acoeff and bcoeff optimized by line_minimization from
initial_guess's walkers (max_iterations iterations of sr_blocks x 10 SR
steps, the other keywords its defaults); then vmc with the energy, 4 x 20
steps at tstep 0.5 from the optimizer's walkers, the mean of the blocks
after the first. Run r uses the keys PRNGKey(seed + 10 r) (walkers), + 1
(optimizer), + 2 (VMC), and runs in its own worker process when nworkers
> 1. Prints every iteration and block, then one JSON line: the means over
the runs of the first and last iterations' energies and of the VMC
energy, their standard error over the runs' means, the spread (the
standard deviation of the runs' means), each run's numbers and the wall
time.
"""

import json
import multiprocessing
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

H2O_ATOM = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
VMC_BLOCKS, VMC_STEPS, VMC_SKIP = 4, 20, 1
NOISE_SEED = 7


def setup():
    """(mol, wf, params, to_opt) of the complex-orbital H2O."""
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu.system.mole import Molecule
    from pyqmc_tpu.system.scf import run_scf

    mol = Molecule(H2O_ATOM, basis="ccecp-ccpvdz", ecp="ccecp")
    mf = run_scf(mol)
    nup, ndn = mol.nelec
    rng = np.random.default_rng(NOISE_SEED)
    ca = np.asarray(mf.mo_coeff[0])[:, :nup] * 1j
    cb = np.asarray(mf.mo_coeff[1])[:, :ndn] * 1j
    ca = ca + (rng.random(ca.shape) - 0.5) * 0.2
    cb = cb + (rng.random(cb.shape) - 0.5) * 0.2
    slater = Slater(mol, None, DeterminantExpansion.single(nup, ndn), mo_coeff=(ca, cb))
    wf = MultiplyWF(slater, JastrowSpin(mol))
    to_opt = {"wf0": {"det_coeff": False, "mo_coeff_alpha": np.ones(ca.shape, dtype=bool),
                      "mo_coeff_beta": np.ones(cb.shape, dtype=bool)},
              "wf1": {"acoeff": True, "bcoeff": True}}
    return mol, mf, wf, wf.make_params(), to_opt


def one_run(args):
    run, nconfig, max_iterations, sr_blocks, seed = args
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.linemin import line_minimization
    from pyqmc_tpu.method.vmc import vmc
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.observables.transform import LinearTransform

    t0 = time.perf_counter()
    s = seed + 10 * run
    mol, mf, wf, params, to_opt = setup()
    lt = LinearTransform(params, to_opt)
    energy = EnergyAccumulator(mol)
    configs = initial_guess(mol, nconfig, key=jax.random.PRNGKey(s))
    params2, configs, records = line_minimization(
        wf, params, configs, lt, energy, key=jax.random.PRNGKey(s + 1),
        max_iterations=max_iterations, vmc_blocks=sr_blocks, vmc_steps_per_block=10)
    for r in records:
        print(f"run {run} iteration {r['iteration']}: E {r['energy']:.6f} +- "
              f"{r['energy_err']:.6f} |g| {r['gnorm']:.4f} tau {r['tau']} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    data, _ = vmc(wf, params2, configs, nblocks=VMC_BLOCKS, nsteps_per_block=VMC_STEPS,
                  tstep=0.5, accumulators={"energy": energy}, key=jax.random.PRNGKey(s + 2))
    ev = np.array([float(d["energytotal"]) for d in data])
    print(f"run {run} VMC blocks {np.round(ev, 6).tolist()} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return {"run": run, "nparams": int(lt.nparams), "nimag": int(lt.nimag),
            "e_first": float(records[0]["energy"]), "err_first": float(records[0]["energy_err"]),
            "e_last": float(records[-1]["energy"]), "err_last": float(records[-1]["energy_err"]),
            "taus": [float(r["tau"]) for r in records],
            "e_vmc": float(np.mean(ev[VMC_SKIP:])),
            "sem_vmc": float(np.std(ev[VMC_SKIP:], ddof=1) / np.sqrt(len(ev) - VMC_SKIP)),
            "seconds": time.perf_counter() - t0}


def stats(values):
    m = np.asarray(values, dtype=np.float64)
    spread = float(np.std(m, ddof=1)) if len(m) > 1 else 0.0
    return float(np.mean(m)), spread / np.sqrt(len(m)), spread


def main(nconfig=2048, nruns=3, max_iterations=4, sr_blocks=5, seed=17, nworkers=1):
    t0 = time.perf_counter()
    tasks = [(r, nconfig, max_iterations, sr_blocks, seed) for r in range(nruns)]
    if nworkers > 1:
        with multiprocessing.get_context("spawn").Pool(nworkers) as pool:
            runs = pool.map(one_run, tasks, chunksize=1)
    else:
        runs = [one_run(t) for t in tasks]
    out = {"nconfig": nconfig, "nruns": nruns, "max_iterations": max_iterations,
           "sr_blocks": sr_blocks, "vmc_blocks": VMC_BLOCKS, "vmc_steps": VMC_STEPS,
           "vmc_skip": VMC_SKIP, "seed": seed}
    for k in ("e_first", "e_last", "e_vmc"):
        out[k], out[f"sem_{k[2:]}"], out[f"spread_{k[2:]}"] = stats([r[k] for r in runs])
    out.update(runs=runs, seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])

"""Reference runs of the three-body Jastrow on ccECP H2O from the JAX package
(pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/h2o_j3_jax_reference.py opt [nconfig] [nruns] [seed]
    python tools/h2o_j3_jax_reference.py vmc [nconfig] [nruns] [seed]

opt: the schedules of chip_smoke.py's phases 17 and 20. generate_wf(mol,
mf) on the committed ccECP/cc-pVDZ checkpoint, 4 x 10 VMC steps of
equilibration and line_minimization of the two-body Jastrow with its
defaults for 20 iterations (phase 17); then generate_wf(mol, mf,
jastrow3=True) from those two-body coefficients with ccoeff at zero, and
line_minimization of the two- and three-body Jastrow (276 free
coefficients) for J3_ITERATIONS iterations of J3_SR_BLOCKS x 10 SR steps
(phase 20), then 4 x 50 VMC steps at tstep 0.5, the mean of the blocks after
the first. Each run starts from its own walkers and keys; the first run's
coefficients are written to pyqmc_tpu_torch/data/h2o_j3_params.npz (acoeff,
bcoeff, ccoeff, with the run's energies).

vmc: BASELINE config 3 at the committed coefficients (entry.h2o_casci_j3_setup
of the port): the CASCI(8e,8o) expansion of
pyqmc_tpu_torch/data/h2o_ccecp_cas88.npz times the two- and three-body
Jastrow, the energy with the dense nonlocal ECP, 6 x 50 VMC steps at tstep
0.5, the mean of the blocks after the first (phase 21's schedule).

Each prints its iterations or blocks, then one JSON line: the mean over the
runs, its standard error (over the runs' means, or with one run from its
kept blocks), and the wall time.
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
PARAMS = os.path.join(ROOT, "pyqmc_tpu_torch", "data", "h2o_j3_params.npz")

NWARM_BLOCKS, NWARM_STEPS = 4, 10  # phase 17's equilibration
J2_ITERATIONS = 20  # phase 17
J3_ITERATIONS, J3_SR_BLOCKS = 6, 5  # phase 20: iterations of 5 x 10 SR steps
VMC_BLOCKS, VMC_STEPS = 4, 50  # phase 20's VMC
CAS_BLOCKS = 6  # phase 21's VMC, 50-step blocks


def sem_of(means, kept):
    """Standard error of the runs' mean: over the runs' means with more than
    one run, else from the one run's kept blocks."""
    if len(means) > 1:
        return float(np.std(means, ddof=1) / np.sqrt(len(means)))
    return float(np.std(kept[0], ddof=1) / np.sqrt(len(kept[0])))


def load():
    from pyqmc_tpu.system.io import load_system

    with h5py.File(H2O, "r") as f:
        return load_system(f)


def optimize(nconfig=2048, nruns=2, seed=61):
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.linemin import line_minimization
    from pyqmc_tpu.method.vmc import vmc
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.observables.transform import LinearTransform
    from pyqmc_tpu.wftools import generate_wf

    mol, mf = load()
    wf2, p2_0, opt2 = generate_wf(mol, mf)
    wf3, p3_0, opt3 = generate_wf(mol, mf, jastrow3=True)
    energy = EnergyAccumulator(mol)
    t2, t3 = LinearTransform(p2_0, opt2), LinearTransform(p3_0, opt3)
    print(f"free coefficients: two-body {t2.nparams}, two- and three-body {t3.nparams}",
          flush=True)
    t0 = time.perf_counter()
    means, kept, out = [], [], []
    for run in range(nruns):
        s = seed + 10 * run
        configs = initial_guess(mol, nconfig, key=jax.random.PRNGKey(s))
        _, configs = vmc(wf2, p2_0, configs, nblocks=NWARM_BLOCKS, nsteps_per_block=NWARM_STEPS,
                         key=jax.random.PRNGKey(s + 1))
        p2, configs, rec2 = line_minimization(wf2, p2_0, configs, t2, energy,
                                              key=jax.random.PRNGKey(s + 2),
                                              max_iterations=J2_ITERATIONS)
        p3 = dict(p3_0)
        p3["wf1"] = p2["wf1"]
        p3, configs, rec3 = line_minimization(wf3, p3, configs, t3, energy,
                                              key=jax.random.PRNGKey(s + 3),
                                              max_iterations=J3_ITERATIONS,
                                              vmc_blocks=J3_SR_BLOCKS)
        for tag, recs in (("two-body", rec2), ("three-body", rec3)):
            for r in recs:
                print(f"run {run} {tag} iteration {r['iteration']}: E {r['energy']:.6f} "
                      f"+- {r['energy_err']:.6f} |g| {r['gnorm']:.4f} tau {r['tau']} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
        data, configs = vmc(wf3, p3, configs, nblocks=VMC_BLOCKS, nsteps_per_block=VMC_STEPS,
                            accumulators={"energy": energy}, key=jax.random.PRNGKey(s + 4))
        e = np.array([float(d["energytotal"]) for d in data])
        for b, x in enumerate(e):
            print(f"run {run} VMC block {b}: E {x:.6f} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        kept.append(e[1:])
        means.append(float(np.mean(e[1:])))
        out.append((p3, rec2, rec3))
    p3, rec2, rec3 = out[0]
    j2, j3 = jax.device_get(p3["wf1"]), jax.device_get(p3["wf2"])
    np.savez(PARAMS, acoeff=np.asarray(j2["acoeff"]), bcoeff=np.asarray(j2["bcoeff"]),
             ccoeff=np.asarray(j3["ccoeff"]), e_vmc=np.asarray(means[0]),
             e_two_body=np.asarray(float(rec2[-1]["energy"])),
             e_three_body=np.asarray(float(rec3[-1]["energy"])), nconfig=np.asarray(nconfig),
             seed=np.asarray(seed))
    print(json.dumps({"nconfig": nconfig, "nruns": nruns, "seed": seed,
                      "j3_iterations": J3_ITERATIONS, "j3_sr_blocks": J3_SR_BLOCKS,
                      "e_mean": float(np.mean(means)), "e_sem": sem_of(means, kept),
                      "run_means": means, "params": os.path.relpath(PARAMS, ROOT),
                      "seconds": time.perf_counter() - t0}), flush=True)


def casci_vmc(nconfig=256, nruns=8, seed=71):
    from pyqmc_tpu.configs import Geometry, initial_guess
    from pyqmc_tpu.method.vmc import make_vmc_block
    from pyqmc_tpu.models.slater import DeterminantExpansion
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu.wftools import generate_wf

    mol, mf = load()
    d = np.load(CAS)
    exp = DeterminantExpansion(occ_up=d["occ_up"], occ_dn=d["occ_dn"], map_up=d["map_up"],
                               map_dn=d["map_dn"])
    wf, params, _ = generate_wf(mol, mf, mc=(exp, d["det_coeff"]), jastrow3=True)
    z = np.load(PARAMS)
    for leaf, k in (("wf1", "acoeff"), ("wf1", "bcoeff"), ("wf2", "ccoeff")):
        assert params[leaf][k].shape == z[k].shape, (leaf, k)
        params[leaf][k] = jax.numpy.asarray(z[k])
    block = make_vmc_block(wf, {"energy": EnergyAccumulator(mol)}, Geometry(None), tstep=0.5,
                           nsteps=50, fused=False)
    t0 = time.perf_counter()
    means, kept, accs = [], [], []
    for run in range(nruns):
        configs = initial_guess(mol, nconfig, key=jax.random.PRNGKey(seed + 2 * run))
        pos, wrap = configs.positions, configs.wrap
        key = jax.random.PRNGKey(seed + 2 * run + 1)
        rows = []
        for b in range(CAS_BLOCKS):
            key, bk = jax.random.split(key)
            pos, wrap, avg = block(params, pos, wrap, bk)
            rows.append((float(avg["energytotal"]), float(avg["acceptance"])))
            print(f"run {run} block {b}: E {rows[-1][0]:.6f} acc {rows[-1][1]:.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        e = np.array([r[0] for r in rows[1:]])
        kept.append(e)
        means.append(float(np.mean(e)))
        accs += [r[1] for r in rows[1:]]
    print(json.dumps({"nconfig": nconfig, "nruns": nruns, "seed": seed, "nblocks": CAS_BLOCKS,
                      "e_mean": float(np.mean(np.concatenate(kept))),
                      "e_sem": sem_of(means, kept), "run_means": means,
                      "acceptance": float(np.mean(accs)),
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    mode, args = sys.argv[1], [int(a) for a in sys.argv[2:]]
    {"opt": optimize, "vmc": casci_vmc}[mode](*args)

"""Reference run of the recipes from a geometry string, from the JAX package
(pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/recipes_jax_reference.py [nconfig] [nruns] [max_iterations] [seed] [dmc]
    python tools/recipes_jax_reference.py scf
    python tools/recipes_jax_reference.py h [nconfig] [nruns] [seed]

The schedule is that of chip_smoke.py's phase 32: ccECP/cc-pVDZ H2O built
from the geometry string of `__graft_entry__._h2o_setup` with the package's
own basis and ECP library, its own run_scf; then recipes.OPTIMIZE(mol,
mf=mf, nconfig, max_iterations, seed) with the line minimization's
defaults (its 4 x 10 VMC steps of equilibration first), and
recipes.VMC(mol, mf=mf, params=..., nconfig, nblocks=8,
nsteps_per_block=25, seed) from new walkers, the mean of the blocks after
the first 2. With dmc = 1, recipes.DMC(mol, mf=mf, params=..., nconfig,
nblocks=6, nsteps_per_block=10, tstep=0.02, warmup_vmc_blocks=2, seed),
the mean of the last 3 blocks. Run r uses seed + 10 r. Prints every
iteration and block, then one JSON line: the SCF energy, the means over
the runs, their standard error over the runs' means, the spread (the
standard deviation of the runs' means), each run's mean and the wall time.

scf: the package's run_scf energies of phase 31's systems, at full
precision: He/STO-3G, H2/STO-3G at 1.4 bohr, H2O/STO-3G at the geometry
above, the H atom in cc-pVDZ (UHF), and the ccECP/cc-pVDZ H2O, as one JSON
line.

h: phase 33's H-atom DMC schedule, recipes.DMC(Molecule("H 0 0 0",
basis="ccpvdz", spin=1), nconfig, nblocks=30, nsteps_per_block=10,
tstep=0.02, warmup_vmc_blocks=2, seed) per run (seed + 10 r), the mean of
the blocks after the first 4 and its standard error from the blocks'
scatter and from reblock_summary over 6 groups; then the runs' mean.
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

import numpy as np

H2O_ATOM = "O 0 0 0.2217; H 0 1.4309 -0.8867; H 0 -1.4309 -0.8867"
VMC_BLOCKS, VMC_STEPS, VMC_SKIP = 8, 25, 2
DMC_BLOCKS, DMC_STEPS, DMC_WARMUP, DMC_LAST, DMC_TSTEP = 6, 10, 2, 3, 0.02


def stats(means):
    m = np.asarray(means, dtype=np.float64)
    spread = float(np.std(m, ddof=1)) if len(m) > 1 else 0.0
    return float(np.mean(m)), spread / np.sqrt(len(m)), spread


def main(nconfig=2048, nruns=3, max_iterations=5, seed=13, dmc=1):
    from pyqmc_tpu.recipes import DMC, OPTIMIZE, VMC
    from pyqmc_tpu.system.mole import Molecule
    from pyqmc_tpu.system.scf import run_scf

    t0 = time.perf_counter()
    mol = Molecule(H2O_ATOM, basis="ccecp-ccpvdz", ecp="ccecp")
    mf = run_scf(mol)
    print(f"SCF e_tot {mf.e_tot:.9f} ({time.perf_counter() - t0:.1f} s)", flush=True)
    vmeans, dmeans, finals = [], [], []
    for run in range(nruns):
        s = seed + 10 * run
        wf, params, records = OPTIMIZE(mol, mf=mf, nconfig=nconfig,
                                       max_iterations=max_iterations, seed=s)
        for r in records:
            print(f"run {run} iteration {r['iteration']}: E {r['energy']:.6f} "
                  f"+- {r['energy_err']:.6f} |g| {r['gnorm']:.4f} tau {r['tau']} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        finals.append(float(records[-1]["energy"]))
        data, _ = VMC(mol, mf=mf, params=params, nconfig=nconfig, nblocks=VMC_BLOCKS,
                      nsteps_per_block=VMC_STEPS, seed=s)
        e = np.array([float(d["energytotal"]) for d in data])
        for b, x in enumerate(e):
            print(f"run {run} VMC block {b}: E {x:.6f} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        vmeans.append(float(np.mean(e[VMC_SKIP:])))
        if dmc:
            ddata, _, _ = DMC(mol, mf=mf, params=params, nconfig=nconfig, nblocks=DMC_BLOCKS,
                              nsteps_per_block=DMC_STEPS, tstep=DMC_TSTEP,
                              warmup_vmc_blocks=DMC_WARMUP, seed=s)
            ed = np.array([float(d["energytotal"]) for d in ddata])
            for b, (x, d) in enumerate(zip(ed, ddata)):
                print(f"run {run} DMC block {b}: E {x:.6f} w {float(d['weight']):.5f} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
            dmeans.append(float(np.mean(ed[-DMC_LAST:])))
    e, sem, spread = stats(vmeans)
    out = {"nconfig": nconfig, "nruns": nruns, "max_iterations": max_iterations, "seed": seed,
           "e_scf": float(mf.e_tot), "e_vmc": e, "sem_vmc": sem, "spread_vmc": spread,
           "run_means_vmc": vmeans, "last_iteration_energies": finals}
    if dmc:
        e, sem, spread = stats(dmeans)
        out.update({"e_dmc": e, "sem_dmc": sem, "spread_dmc": spread, "run_means_dmc": dmeans})
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


SCF_SYSTEMS = {"he_sto3g": ("He 0 0 0", dict(basis="sto-3g")),
               "h2_sto3g": ("H 0 0 0; H 0 0 1.4", dict(basis="sto-3g")),
               "h2o_sto3g": (H2O_ATOM, dict(basis="sto-3g")),
               "h_ccpvdz_uhf": ("H 0 0 0", dict(basis="ccpvdz", spin=1)),
               "h2o_ccecp": (H2O_ATOM, dict(basis="ccecp-ccpvdz", ecp="ccecp"))}


def scf():
    from pyqmc_tpu.system.mole import Molecule
    from pyqmc_tpu.system.scf import run_scf

    print(json.dumps({k: run_scf(Molecule(atom, **kw)).e_tot
                      for k, (atom, kw) in SCF_SYSTEMS.items()}), flush=True)


H_BLOCKS, H_WARMUP, H_SKIP = 30, 2, 4


def h_atom(nconfig=200, nruns=4, seed=13):
    from pyqmc_tpu.recipes import DMC
    from pyqmc_tpu.reblock import reblock_summary
    from pyqmc_tpu.system.mole import Molecule

    t0 = time.perf_counter()
    mol = Molecule("H 0 0 0", basis="ccpvdz", spin=1)
    means = []
    for run in range(nruns):
        data, _, _ = DMC(mol, nconfig=nconfig, nblocks=H_BLOCKS, nsteps_per_block=10,
                         tstep=DMC_TSTEP, warmup_vmc_blocks=H_WARMUP, seed=seed + 10 * run)
        e = np.array([float(d["energytotal"]) for d in data])[H_SKIP:]
        means.append(float(np.mean(e)))
        print(f"run {run}: E {means[-1]:.6f} +- {np.std(e, ddof=1) / np.sqrt(len(e)):.6f} "
              f"(blocks), +- {float(reblock_summary(e, 6)['standard error']):.6f} (6 groups) "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    e, sem, spread = stats(means)
    print(json.dumps({"nconfig": nconfig, "nruns": nruns, "seed": seed, "e": e, "sem": sem,
                      "spread": spread, "run_means": means,
                      "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["scf"]:
        scf()
    elif sys.argv[1:2] == ["h"]:
        h_atom(*[int(a) for a in sys.argv[2:]])
    else:
        main(*[int(a) for a in sys.argv[1:]])

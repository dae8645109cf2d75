"""Reference energies of BASELINE config 5, the periodic diamond-C supercell
at a general twist and its two-twist average, from the JAX package
(pyqmc_tpu), on the CPU in float64 with the plain XLA paths.

    python tools/diamond_twist_jax_reference.py vmc [nconfig nruns nblocks nwarm nworkers]
    python tools/diamond_twist_jax_reference.py dmc [nconfig nruns nblocks nwarm nlast nworkers]
    python tools/diamond_twist_jax_reference.py average [nconfig nruns nblocks nwarm nworkers]

The configuration is that of benchmarks/c_solid_benchmark.py:e2e_vmc with
general_twist=True and of pyqmc_tpu_torch.entry.diamond_twist_setup: the
2x2x2 supercell of the fixture's primitive cell, the fixture's 8 k-points
shifted by (0.023, -0.017, 0.011) with 4 occupied orbitals each,
KPointOrbitals(realify=False, img_tol=1e-4), the native complex Slater
(pyqmc_tpu/models/slater.py) times JastrowSpin with default_jastrow_basis,
Ewald and the ECP downselected to 24 of 96 points.

vmc      `nruns` runs of `nconfig` walkers, each from its own walkers: `nwarm`
         10-step blocks at tstep 0.5 dropped, then `nblocks` kept; the
         energy per primitive cell of each run's kept blocks, their mean
         and its standard error over the runs.
dmc      `nruns` runs of `pyqmc_tpu.method.dmc.rundmc` with `nwarm` VMC
         warm-up blocks (10 steps at tstep 0.5) and `nblocks` DMC blocks of
         10 steps at tstep 0.02 with T-moves; each run's energy per cell of
         its last `nlast` blocks, their mean and standard error over the
         runs, and each block's mean weight (geometric mean over the runs).
average  the twist average of pyqmc_tpu/method/twist_average.py over the
         union of the fixture's 8 TRIM k-points and the same 8 shifted:
         create_supercell_twists groups them into two supercell twists (the
         TRIM one runs in real mode, the shifted one in complex mode); each
         twist's wavefunction is the configuration above on its k-points.
         Per twist, `nruns` runs of `nconfig` walkers: `nwarm` blocks of
         equilibration, then `nblocks` blocks averaged by the rule of
         twist_average_vmc (the blocks after max(1, nblocks // 4)); per
         twist the mean over the runs and its standard error, and the
         equal-weight average of the twists.

Runs go to `nworkers` processes side by side. Each run prints one JSON
line; the summary is the last JSON line.
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
TWIST = np.array([0.023, -0.017, 0.011])  # c_solid_benchmark.py:130
NOCC = 4


def _cell():
    from pyqmc_tpu.system.supercell import get_supercell
    from tests.fixtures_pbc import load_cell

    cell, d = load_cell("diamond_primitive")
    return cell, d, get_supercell(cell, 2 * np.eye(3, dtype=int))


def twist_wf(cell, sup, kpts, blocks):
    """Slater(KPointOrbitals(kpts)) x JastrowSpin of the supercell; complex
    mode unless every k-point is TRIM (realify "auto")."""
    from pyqmc_tpu.models.jastrow import JastrowSpin
    from pyqmc_tpu.models.multiply import MultiplyWF
    from pyqmc_tpu.models.orbitals import KPointOrbitals
    from pyqmc_tpu.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu.wftools import default_jastrow_basis

    orb = KPointOrbitals(cell, kpts, (blocks, blocks), img_tol=1e-4)
    n = sum(b.shape[1] for b in blocks)
    a_b, b_b = default_jastrow_basis(sup)
    return MultiplyWF(Slater(sup, orb, DeterminantExpansion.single(n, n)),
                      JastrowSpin(sup, a_basis=a_b, b_basis=b_b))


def setups():
    """{twist key: (wf, real_mode)} of the union mesh, sorted by twist, as
    twist_average_vmc orders them; the orbitals of each k are the
    fixture's first NOCC (the occupied ones, mo_occ > 0.5 after halving)."""
    from pyqmc_tpu.system.supercell import create_supercell_twists

    cell, d, sup = _cell()
    kpts = np.asarray(d["kpts"])
    mesh = np.concatenate([kpts, kpts + TWIST])
    coeff = [np.asarray(d["mo_coeff"][k % len(kpts)]) for k in range(len(mesh))]
    occ = [np.asarray(d["mo_occ"][k % len(kpts)]) / 2.0 > 0.5 for k in range(len(mesh))]
    out = {}
    for key, idx in sorted(create_supercell_twists(sup, mesh).items()):
        blocks = [coeff[k][:, occ[k]] for k in idx]
        wf = twist_wf(cell, sup, mesh[idx], blocks)
        out[key] = (wf, wf.wfs[0].orbitals.real_mode)
    return sup, out


def general_twist_wf():
    cell, d, sup = _cell()
    kpts = np.asarray(d["kpts"]) + TWIST
    blocks = [np.asarray(d["mo_coeff"][k])[:, :NOCC] for k in range(len(kpts))]
    return sup, twist_wf(cell, sup, kpts, blocks)


def vmc_run(args):
    """One VMC run: kept blocks' energies per cell and acceptances."""
    r, nconfig, nblocks, nwarm, seed, twist = args
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.vmc import make_vmc_block
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator

    if twist is None:
        sup, wf = general_twist_wf()
        real = False
    else:
        sup, wfs = setups()
        wf, real = wfs[twist]
    energy = EnergyAccumulator(sup)
    assert energy.ecp_acc.nselect == 24 and energy.ecp_acc.nq_total == 96
    t0 = time.perf_counter()
    configs = initial_guess(sup, nconfig, key=jax.random.PRNGKey(seed + 100 * r))
    block = make_vmc_block(wf, {"energy": energy}, configs.geometry, tstep=0.5, nsteps=10,
                           fused=False)
    params = wf.make_params()
    pos, wrap = configs.positions, configs.wrap
    key = jax.random.PRNGKey(seed + 100 * r + 1)
    e, acc = [], []
    for _ in range(nwarm + nblocks):
        key, bk = jax.random.split(key)
        pos, wrap, avg = block(params, pos, wrap, bk)
        e.append(float(avg["energytotal"]) / NCELL)
        acc.append(float(avg["acceptance"]))
    out = {"run": r, "twist": None if twist is None else [float(x) for x in twist],
           "real_mode": bool(real), "e_cell_blocks": e[nwarm:], "e_cell_warm": e[:nwarm],
           "e_cell_kept": float(np.mean(e[nwarm:])), "acceptance": float(np.mean(acc[nwarm:])),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


def dmc_run(args):
    """One rundmc run; its per-block numbers."""
    r, nconfig, nblocks, nwarm, nlast, seed = args
    from pyqmc_tpu.configs import initial_guess
    from pyqmc_tpu.method.dmc import rundmc
    from pyqmc_tpu.observables.accumulators import EnergyAccumulator

    sup, wf = general_twist_wf()
    energy = EnergyAccumulator(sup)
    t0 = time.perf_counter()
    configs = initial_guess(sup, nconfig, key=jax.random.PRNGKey(seed + 100 * r))
    blocks, _, _ = rundmc(
        wf, wf.make_params(), configs, nblocks=nblocks, nsteps_per_block=10, tstep=0.02,
        energy_acc=energy, key=jax.random.PRNGKey(seed + 100 * r + 1), warmup_vmc_blocks=nwarm)
    e = [float(b["energytotal"]) / NCELL for b in blocks]
    e_warm = (2 * float(blocks[0]["e_est"]) - float(blocks[0]["energytotal"])) / NCELL
    out = {"run": r, "e_cell_last": float(np.mean(e[-nlast:])), "e_vmc_cell": e_warm,
           "e_cell_blocks": e, "weights": [float(b["weight"]) for b in blocks],
           "acceptance": float(np.mean([float(b["acceptance"]) for b in blocks[-nlast:]])),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


def _map(fn, tasks, nworkers):
    if nworkers > 1:
        with multiprocessing.get_context("spawn").Pool(nworkers) as pool:
            return pool.map(fn, tasks, chunksize=1)
    return [fn(t) for t in tasks]


def _mean_sem(x):
    x = np.asarray(x, dtype=float)
    return float(np.mean(x)), (float(np.std(x, ddof=1) / np.sqrt(len(x))) if len(x) > 1
                               else float("nan"))


def main(mode="vmc", nconfig=64, nruns=4, nblocks=8, nwarm=4, *rest, seed=5):
    t0 = time.perf_counter()
    if mode == "vmc":
        nworkers = rest[0] if rest else 1
        runs = _map(vmc_run, [(r, nconfig, nblocks, nwarm, seed, None) for r in range(nruns)],
                    nworkers)
        m, s = _mean_sem([x["e_cell_kept"] for x in runs])
        summary = {"mode": mode, "nconfig": nconfig, "nruns": nruns, "nblocks": nblocks,
                   "nwarm": nwarm, "nsteps": 10, "tstep": 0.5, "e_cell_mean": m, "e_cell_sem": s,
                   "acceptance": float(np.mean([x["acceptance"] for x in runs]))}
    elif mode == "dmc":
        nlast = rest[0] if rest else 2
        nworkers = rest[1] if len(rest) > 1 else 1
        runs = _map(dmc_run, [(r, nconfig, nblocks, nwarm, nlast, seed) for r in range(nruns)],
                    nworkers)
        m, s = _mean_sem([x["e_cell_last"] for x in runs])
        logw = np.log(np.array([x["weights"] for x in runs]))
        summary = {"mode": mode, "nconfig": nconfig, "nruns": nruns, "nblocks": nblocks,
                   "nwarm": nwarm, "nlast": nlast, "nsteps": 10, "tstep": 0.02,
                   "e_cell_mean": m, "e_cell_sem": s,
                   "e_vmc_cell_mean": float(np.mean([x["e_vmc_cell"] for x in runs])),
                   "acceptance": float(np.mean([x["acceptance"] for x in runs])),
                   "e_cell_blocks_mean": np.mean([x["e_cell_blocks"] for x in runs],
                                                 axis=0).tolist(),
                   "weight_blocks": np.exp(np.mean(logw, axis=0)).tolist(),
                   "weight_blocks_max": np.max(np.exp(logw), axis=0).tolist()}
    elif mode == "average":
        nworkers = rest[0] if rest else 1
        _, wfs = setups()
        keys = list(wfs)
        tasks = [(r, nconfig, nblocks, nwarm, seed + 7 * ti, key)
                 for ti, key in enumerate(keys) for r in range(nruns)]
        runs = _map(vmc_run, tasks, nworkers)
        warm = max(1, nblocks // 4)  # twist_average_vmc's rule
        twists = []
        for ti, key in enumerate(keys):
            mine = runs[ti * nruns:(ti + 1) * nruns]
            m, s = _mean_sem([np.mean(x["e_cell_blocks"][warm:]) for x in mine])
            twists.append({"twist": [float(v) for v in key], "real_mode": mine[0]["real_mode"],
                           "e_cell_mean": m, "e_cell_sem": s,
                           "acceptance": float(np.mean([x["acceptance"] for x in mine]))})
        summary = {"mode": mode, "nconfig": nconfig, "nruns": nruns, "nblocks": nblocks,
                   "nwarm": nwarm, "averaged_from_block": warm, "twists": twists,
                   "e_cell_average": float(np.mean([t["e_cell_mean"] for t in twists])),
                   "e_cell_average_sem": float(np.sqrt(sum(t["e_cell_sem"] ** 2
                                                           for t in twists)) / len(twists))}
    else:
        raise SystemExit(f"unknown mode {mode!r}: vmc, dmc or average")
    summary["seconds"] = time.perf_counter() - t0
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "vmc", *[int(a) for a in sys.argv[2:]])

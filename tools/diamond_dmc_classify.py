"""Classify the gap between the port's periodic DMC energy and the JAX
package's on the 8-block schedule: float32 against float64, and the port at
the JAX runs' walker count against their energy. Imports torch, never jax;
needs one NVIDIA GPU.

    python tools/diamond_dmc_classify.py [budget_s nworkers]

The configuration is pyqmc_tpu_torch.entry.diamond_setup (the 2x2x2
diamond-C supercell, k-point Slater x periodic Jastrow, Ewald, the ECP
downselected to 24 of 96 points); the schedule that of
tools/diamond_dmc_jax_reference.py 32 6 8 4 4 3: `rundmc` with 4 VMC
warm-up blocks (10 steps at tstep 0.5), then 8 DMC blocks of 10 steps at
tstep 0.02 with T-moves; a run's energy is the mean energy per primitive
cell of its last 4 blocks, its standard error the scatter of those blocks
over 2.

  (i)  500 walkers from one seed, float32 then float64, in the main
       process: if the two differ by more than 3 combined standard errors,
       float32 is at fault;
  (ii) 32 walkers, float64, independent runs (walkers and generator from
       the run's index) in `nworkers` processes beside (i), as many as
       start before `budget_s` less a run's expected length (at least one
       per worker): their mean and its standard error over the runs,
       against the JAX package's -10.894527 +- 0.054767 Ha per cell (6
       runs of 32 walkers, float64 on the CPU).

Prints the card's name and power limit, one JSON line per run, and one
summary line.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NCELL = 8  # primitive cells in the 2x2x2 supercell
NBLOCKS, NWARM, NLAST, NSTEPS, TSTEP = 8, 4, 4, 10, 0.02
JAX_32 = {"e_cell": -10.894527, "sem": 0.054767}  # diamond_dmc_jax_reference.py 32 6 8 4 4 3
RUN_32_S = 300.0  # a 32-walker float64 run's expected length on an H100, seconds


def run(dtype_name, nconf, seed):
    """One rundmc run on the GPU; returns its numbers."""
    from pyqmc_tpu_torch.entry import diamond_setup
    from pyqmc_tpu_torch.method.dmc import rundmc

    t0 = time.perf_counter()
    dtype = getattr(torch, dtype_name)
    sup, wf, params, configs, acc = diamond_setup(nconf, dtype=dtype, seed=seed)
    gen = torch.Generator(device=configs.positions.device).manual_seed(1000 + seed)
    blocks, _, _ = rundmc(wf, params, configs, nblocks=NBLOCKS, nsteps_per_block=NSTEPS,
                          tstep=TSTEP, energy_acc=acc["energy"], generator=gen,
                          warmup_vmc_blocks=NWARM)
    e = np.array([b["energytotal"] / NCELL for b in blocks])
    out = {"dtype": dtype_name, "nconf": nconf, "seed": seed,
           "e_cell_last": float(np.mean(e[-NLAST:])),
           "sem": float(np.std(e[-NLAST:], ddof=1) / np.sqrt(NLAST)),
           "e_cell_blocks": e.tolist(), "weights": [b["weight"] for b in blocks],
           "acceptance": float(np.mean([b["acceptance"] for b in blocks[-NLAST:]])),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


def run_32(args):
    """Worker: run 32-walker float64 run `seed` if it can end before the deadline."""
    seed, deadline = args
    if time.time() + RUN_32_S > deadline:
        return None
    return run("float64", 32, seed)


def main(budget_s=1000, nworkers=3):
    if not torch.cuda.is_available():
        raise SystemExit("diamond_dmc_classify: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    from pyqmc_tpu_torch.ops import _build

    _build.library()  # build once, before the workers load the libraries
    t0 = time.time()
    deadline = t0 + budget_s
    # the first wave starts at once whatever the deadline
    tasks = [(r, deadline + (RUN_32_S if r < nworkers else 0.0)) for r in range(4 * nworkers)]
    with multiprocessing.get_context("spawn").Pool(nworkers) as pool:
        pending = pool.map_async(run_32, tasks, chunksize=1)
        big = {name: run(name, 500, 7) for name in ("float32", "float64")}
        small = [x for x in pending.get() if x is not None]

    d = big["float32"]["e_cell_last"] - big["float64"]["e_cell_last"]
    comb = float(np.hypot(big["float32"]["sem"], big["float64"]["sem"]))
    last = np.array([x["e_cell_last"] for x in small])
    mean32 = float(np.mean(last))
    sem32 = float(np.std(last, ddof=1) / np.sqrt(len(last))) if len(last) > 1 else float("nan")
    comb32 = float(np.hypot(sem32, JAX_32["sem"]))
    print(json.dumps({
        "card": card,
        "float32_vs_float64_500": {"float32": big["float32"]["e_cell_last"],
                                   "float64": big["float64"]["e_cell_last"], "difference": d,
                                   "combined_sem": comb, "in_combined_sem": abs(d) / comb},
        "float64_32_walkers": {"runs": len(last), "e_cell_mean": mean32, "sem": sem32,
                               "jax": JAX_32, "difference": mean32 - JAX_32["e_cell"],
                               "in_combined_sem": abs(mean32 - JAX_32["e_cell"]) / comb32},
        "float32_at_fault": bool(abs(d) > 3 * comb),
        "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])

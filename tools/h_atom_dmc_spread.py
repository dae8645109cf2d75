"""The spread of the H-atom DMC energy over seeds on the card, float32 and
float64 (chip_smoke.py phase 33's schedule).

    python tools/h_atom_dmc_spread.py

The H atom in cc-pVDZ (spin 1), 200 walkers, 2 VMC warm-up blocks and 30 x
10 DMC steps at tstep 0.02, the blocks after the first 4: in float32 through
the DMC recipe (seeds 13, 23, ..., 63), in float64 through generate_wf and
rundmc on the card with the same seeds. Prints each run's mean and its
standard error from the blocks' scatter, then per dtype the runs' mean, its
standard error and their spread. Needs one CUDA device (about 2 minutes).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from pyqmc_tpu_torch.api import (DMC, EnergyAccumulator, Molecule, generate_wf, initial_guess,
                                 run_scf, rundmc)

SEEDS = range(13, 73, 10)
NCONF, NBLOCKS, NSKIP, WARMUP, TSTEP = 200, 30, 4, 2, 0.02


def main():
    h = Molecule("H 0 0 0", basis="ccpvdz", spin=1)
    mf = run_scf(h)
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.float64):
        means = []
        for seed in SEEDS:
            if dtype == torch.float32:
                blocks, _, _ = DMC(h, mf=mf, nconfig=NCONF, nblocks=NBLOCKS, nsteps_per_block=10,
                                   tstep=TSTEP, warmup_vmc_blocks=WARMUP, seed=seed)
            else:
                wf, params, _ = generate_wf(h, mf, device="cuda", dtype=dtype)
                configs = initial_guess(h, NCONF, generator=torch.Generator().manual_seed(seed),
                                        device="cuda", dtype=dtype)
                blocks, _, _ = rundmc(wf, params, configs, nblocks=NBLOCKS, nsteps_per_block=10,
                                      tstep=TSTEP, energy_acc=EnergyAccumulator(h),
                                      warmup_vmc_blocks=WARMUP,
                                      generator=torch.Generator(device="cuda").manual_seed(
                                          seed + 4))
            e = np.array([b["energytotal"] for b in blocks])[NSKIP:]
            means.append(float(np.mean(e)))
            print(dtype, seed, round(means[-1], 6), round(np.std(e, ddof=1) / np.sqrt(len(e)), 6),
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        spread = float(np.std(means, ddof=1))
        print(dtype, "mean", np.mean(means), spread / np.sqrt(len(means)), spread, flush=True)
    print(torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()

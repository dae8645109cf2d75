"""Time the three-body Jastrow's plain pieces on BASELINE config 3, and a
config 3 VMC block, for the pyqmc_tpu_torch of a given checkout, on one
NVIDIA GPU.

    python tools/time_j3_pieces.py [ROOT] [LABEL]

ROOT (default: this checkout) is the directory that holds the package, so
two checkouts are timed with one procedure in one call (parent, change,
change, parent). The wavefunction is h2o_casci_j3_setup(2048, float32,
seed 11): the CASCI(8e,8o) expansion times the two- and three-body
Jastrow on the committed coefficients. The pieces, each timed by CUDA
events over REPS calls after a warm-up (host work included, as
chip_smoke.py phase 21 times them):

  j3_sweep_ms        move_begin, move_finish and updateinternals of the
                     ThreeBodyJastrow for each of the 8 electrons
  j3_kinetic_ms      gradient_laplacian_many of all 8 electrons
  j3_ecp_ratios_ms   testvalue_aux_all at 6 points per electron
  j3_recompute_ms    recompute

and the host time of a 10-step VMC block (vmc() with the energy
accumulator, one warm-up block, then the mean of NBLOCKS, each ending in a
synchronize). Prints the card's name and power limit and one JSON line.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")
LABEL = sys.argv[2] if len(sys.argv) > 2 else ROOT
sys.path.insert(0, ROOT)

import torch  # noqa: E402

NCONF, REPS, NSTEPS, NBLOCKS = 2048, 5, 10, 3


def cuda_ms(fn, reps=REPS):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from pyqmc_tpu_torch.entry import h2o_casci_j3_setup
    from pyqmc_tpu_torch.method.vmc import vmc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    mol, wf, params, configs, acc = h2o_casci_j3_setup(NCONF, dtype=torch.float32, seed=11)
    j3, p3 = wf.wfs[2], params["wf2"]
    pos = configs.positions
    state = j3.recompute(p3, pos)
    gen = torch.Generator(device="cuda").manual_seed(13)
    moved = pos + 0.1
    half = torch.arange(NCONF, device="cuda") % 2 == 0
    aux = pos.transpose(0, 1)[:, :, None, :] + 0.3 * torch.randn(
        (8, NCONF, 6, 3), generator=gen, device="cuda")

    def sweep():
        s = state
        for e in range(8):
            _, a = j3.move_begin(p3, s, e, s.positions[:, e])
            _, _, saved = j3.move_finish(p3, s, e, moved[:, e], a)
            s = j3.updateinternals(p3, s, e, moved[:, e], half, saved)

    out = {"label": LABEL,
           "j3_sweep_ms": cuda_ms(sweep),
           "j3_kinetic_ms": cuda_ms(lambda: j3.gradient_laplacian_many(p3, state, tuple(range(8)),
                                                                       pos)),
           "j3_ecp_ratios_ms": cuda_ms(lambda: j3.testvalue_aux_all(p3, state, aux)),
           "j3_recompute_ms": cuda_ms(lambda: j3.recompute(p3, pos))}
    _, configs = vmc(wf, params, configs, nblocks=1, nsteps_per_block=2, accumulators=acc,
                     generator=gen)
    seconds = []
    for _ in range(NBLOCKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, configs = vmc(wf, params, configs, nblocks=1, nsteps_per_block=NSTEPS,
                         accumulators=acc, generator=gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    out["vmc_step_ms"] = 1e3 * sum(seconds) / (NBLOCKS * NSTEPS)
    out["vmc_block_s"] = seconds
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

"""The control of a cell's comparison, the planted faults, and the
program's readings beside them.

    python -m qmcbench.control --workload h2o_sj.dmc --seeds 2147483951,2147483952 \
        --faults half_the_batch,comb_unchanged --out control.jsonl

For each seed, in one process: the cell's set-up and a window of one
block at the cell's own size, then the numbers compared twice: the
program's, and the control's, the reference computed in float32 with
TF32 matmuls (the precision below the configuration's float32 with TF32
off) put in the program's place over the same sample, start and streams
(and float32 reductions in the place of the program's comb and averages).
Then, for each fault of --faults (`qmcbench/faults.py`), the same set-up,
block and check with that fault planted under the timed path. Each line
gives the numbers, the cell's limits and the verdict: a limit lies above
the program's readings and below the control's or a fault's, and the
control and every fault have to come out not correct.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from . import checks, faults, harness


def reading(cell, seed, fault=None, control=False, device="cuda", dtype=None):
    """(numbers, seconds of set-up and block, seconds of the check) of one
    set-up and one block, with `fault` planted."""
    import torch

    dtype = dtype or getattr(torch, cell.config["dtype"])
    t0 = time.perf_counter()
    with faults.planted(fault) if fault else contextlib.nullcontext():
        system = cell.system_module().System(cell.config, cell.traffic["nconf"], seed, device,
                                             dtype)
        run = cell.method_module().Run(system, cell.traffic, seed)
        run.setup(timed=False)
        run.window(1)
    run.release()
    t1 = time.perf_counter()
    numbers = {"program": run.check()}
    if control:
        numbers["control"] = run.check(control=True)
    t2 = time.perf_counter()
    del run, system
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return numbers, t1 - t0, t2 - t1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", default="")
    p.add_argument("--control", type=int, choices=(0, 1), default=1,
                   help="0: the faults alone, without the program's and the control's readings")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    cell = harness.Cell(args.workload)
    wanted = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        runs = [(None, True)] * args.control + [(f, False) for f in wanted]
        for fault, control in runs:
            numbers, setup_s, check_s = reading(cell, seed, fault, control)
            for who, values in numbers.items():
                name = fault or who
                correct, rows = checks.verdict(values, cell.limits)
                line = {"workload": cell.name, "seed": seed, "side": name, "correct": correct,
                        "numbers": values, "limits": cell.limits, "setup_and_block_s": setup_s,
                        "check_s": check_s, "device": torch.cuda.get_device_name()}
                print(json.dumps(line), flush=True)
                print(f"qmcbench: seed {seed} {name}: correct = {correct}; " + ", ".join(
                    f"{k} {v!r} (limit {lim!r})" for k, v, lim in rows), file=sys.stderr,
                    flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()

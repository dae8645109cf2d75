"""The population sweep of one configuration and traffic mix: for each
population, set-up, a timed window of whole blocks and one traced block.

    python -m qmcbench.sweep --config h2o_sj --traffic dmc_262144 \
        --populations 65536,131072,262144,524288 --seed 2147483911 --seconds 10

Prints one JSON line per population: walker-steps/s, the traced block's
device idle share, the peak device memory and the set-up seconds. A cell
takes the smallest population whose rate is within 10% of the sweep's best.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import time

from . import harness, run as qrun


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--populations", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    import torch

    from . import checks, tracing

    if not torch.cuda.is_available():
        qrun.fail("no CUDA device", code=3)
    bench = harness.load_benchmark()
    entry = {c["name"]: c for c in bench["configs"]}[args.config]
    config = harness.read_json(harness.repo_path(entry["file"]))
    base = harness.read_json(os.path.join(harness.PACKAGE, "traffic", args.traffic + ".json"))
    dtype = getattr(torch, config["dtype"])
    sync = lambda: checks.sync("cuda")
    for nconf in (int(n) for n in args.populations.split(",")):
        traffic = dict(base, nconf=nconf)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mod = importlib.import_module(f"qmcbench.systems.{config['kind']}")
        system = mod.System(config, nconf, args.seed, "cuda", dtype)
        method = importlib.import_module(f"qmcbench.methods.{traffic['method']}")
        r = method.Run(system, traffic, args.seed)
        t_block = r.setup()
        setup_s = time.perf_counter() - t0
        nblocks = qrun.blocks_in_window(args.seconds, t_block)
        sync()
        t1 = time.perf_counter()
        r.window(nblocks)
        sync()
        window_s = time.perf_counter() - t1
        with tracing.traced(sync) as tr:
            r.window(1)
        summary = tracing.Summary(tr.pop("events"))
        line = {"config": args.config, "traffic": args.traffic, "nconf": nconf,
                "blocks": nblocks, "walker_steps_per_s": r.walker_steps(nblocks) / window_s,
                "device_idle": 1.0 - summary.busy_s / tr["window_s"],
                "device_events_per_step": summary.device_events / traffic["nsteps_per_block"],
                "memory_peak_bytes": torch.cuda.max_memory_allocated(),
                "setup_s": setup_s, "device": torch.cuda.get_device_name()}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        del r, system, summary, tr
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

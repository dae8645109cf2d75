"""One run of one benchmark cell of pyqmc_tpu_torch on the card.

    python -m qmcbench.run --workload h2o_sj.dmc --seed 2147483901 --seconds 10 --trace 0

Set-up (from process start): the system's files, the program's objects on
the card, walkers and Jastrow coefficients from the seed, equilibration and
one pass of every shape the window runs. The window: as many whole blocks
of the program's VMC or DMC loop as fit in --seconds (reckoned from a warm
block), the host clock read after a synchronisation at both ends. Then the import
check, the peak memory, and the reference's check of the last block.

The last line of standard output is the result: with --trace 0 the cell's
end-to-end metrics, with --trace 1 its per-layer metrics (read from a
traced window of the traffic's `trace_blocks` blocks). The numbers that
decide `correct` are printed beside their limits as the last lines of
standard error and under "checks", the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pyqmc_tpu")  # whole top-level module names


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def blocks_in_window(seconds, t_block):
    """Whole blocks in a window of `seconds`, reckoned from a warm block of
    `t_block` seconds: at least one."""
    return max(1, int(seconds // max(t_block, 1e-9)))


def fail(msg, code=2):
    print(f"qmcbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def execute(cell, seed, seconds, trace, device="cuda", dtype=None, t_start=None):
    """Set up, time and check one run of `cell`; returns the result dict
    (its "checks" last) and the check's rows."""
    import torch

    from . import checks, tracing

    t_start = T_START if t_start is None else t_start
    dtype = dtype or getattr(torch, cell.config["dtype"])
    system = cell.system_module().System(cell.config, cell.traffic["nconf"], seed, device, dtype)
    run = cell.method_module().Run(system, cell.traffic, seed)
    t_block = run.setup()
    sync = lambda: checks.sync(device)
    nblocks = blocks_in_window(seconds, t_block)
    if trace:
        nblocks = min(nblocks, cell.traffic["trace_blocks"])
    sync()
    setup_s = time.perf_counter() - t_start
    if trace:
        with tracing.traced(sync) as tr:
            data = run.window(nblocks)
        window_s = tr["window_s"]
    else:
        t0 = time.perf_counter()
        data = run.window(nblocks)
        sync()
        window_s = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = sum(1 for b in data if not all(
        np_isfinite(v) for k, v in b.items() if k not in ("block", "block time")))
    print("qmcbench: {} blocks in {:.4f} s; the program's block times {}".format(
        nblocks, window_s, [round(b.get("block time", 0.0), 4) for b in data]), file=sys.stderr)
    run.release()
    t_check = time.perf_counter()
    numbers = run.check()
    print(f"qmcbench: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    correct, rows = checks.verdict(numbers, cell.limits)
    correct = correct and failed == 0
    walker_steps = run.walker_steps(nblocks)
    if trace:
        summary = tracing.Summary(tr.pop("events"))
        ctx = {"cell": cell, "summary": summary, "shapes": system.shapes(), "nblocks": nblocks,
               "steps": nblocks * cell.traffic["nsteps_per_block"], "walker_steps": walker_steps,
               "window_s": window_s, "blocks": data}
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"walker_steps_per_s": walker_steps / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        dev.update(busy_s=summary.busy_s, window_s=window_s)
    result = {"correct": bool(correct), "attempted": nblocks, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": [[k, v] for k, v in summary.idle_gaps]}
    result["read_too"] = {k: v for k, v in numbers.items() if k not in cell.limits}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows


def np_isfinite(v):
    import numpy as np

    return bool(np.all(np.isfinite(v)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from . import harness

    try:
        cell = harness.Cell(args.workload)
    except (harness.MissingFile, KeyError) as exc:
        fail(f"cannot read the cell: {exc}")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device", code=3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.chips} cards asked, {torch.cuda.device_count()} present", code=3)
    try:
        import pyqmc_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the program is not in the checkout: {exc}")
    result, rows = execute(cell, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        fail(f"the run loaded {', '.join(found)}", code=4)
    for name, value in result.pop("read_too").items():
        print(f"qmcbench: read too, not compared: {name} = {value!r}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()

"""Runs of one cell, each a process of its own like any benchmark run,
with a summary of their spread.

    python -m qmcbench.repeat --workload h2o_sj.dmc --seeds 2147483901,2147483902 \
        --seconds 10 --trace 0 --out h2o_sj.dmc.jsonl

Each run's result line (with its seed and exit code) is appended to --out;
at the end one line per metric and per number compared: the values, the
median and the spread, the distance between the first and third quartiles
(statistics.quantiles, n=4) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / abs(med) if med else None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    results = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cmd = [sys.executable, "-m", "qmcbench.run", "--workload", args.workload, "--seed",
               str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = {"error": proc.stderr[-4000:]}
        res.update(seed=seed, rc=proc.returncode, stderr_tail=proc.stderr[-1500:])
        results.append(res)
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")
        print(json.dumps({k: res.get(k) for k in ("seed", "rc", "correct", "metrics", "checks")}),
              flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr, flush=True)
    keys = sorted({k for r in results for k in r.get("metrics", {})})
    for k in keys:
        vals = [r["metrics"][k]["value"] for r in results if k in r.get("metrics", {})]
        print(json.dumps({"metric": k, "values": vals, "median": statistics.median(vals),
                          "spread": spread(vals)}), flush=True)
    for k in sorted({k for r in results for k in r.get("checks", {})}):
        vals = [r["checks"][k]["value"] for r in results if k in r.get("checks", {})]
        print(json.dumps({"check": k, "max": max(vals), "values": vals}), flush=True)


if __name__ == "__main__":
    main()

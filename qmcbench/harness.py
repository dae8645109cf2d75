"""Finds a cell's files by name and holds what the methods share.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives it:

    qmcbench/configs/<config>.json    the system and its sizes; its "kind"
                                      names qmcbench/systems/<kind>.py
    qmcbench/traffic/<traffic>.json   the method's parameters; its "method"
                                      names qmcbench/methods/<method>.py
    qmcbench/limits/<cell>.json       the limit of each number compared
    qmcbench/metrics/<metric>.py      read(ctx) -> value or None

A cell or a metric is added with files and entries alone.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import os

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "qmcbench")

# the seed's streams: each is its own SeedSequence([seed, stream])
STREAM_WALKERS, STREAM_JASTROW, STREAM_RUN, STREAM_SAMPLE = 1, 2, 3, 4


class MissingFile(RuntimeError):
    """A file the cell needs is not in the checkout."""


def repo_path(rel):
    return os.path.join(ROOT, rel)


def read_json(path):
    if not os.path.exists(path):
        raise MissingFile(f"{os.path.relpath(path, ROOT)} is missing")
    with open(path) as f:
        return json.load(f)


def load_benchmark(root=ROOT):
    return read_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and
    limits read from their files, and the metrics it reports."""

    def __init__(self, name, bench=None, package=PACKAGE):
        bench = bench or load_benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise MissingFile(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.spec = name, cells[name]
        self.chips = int(self.spec["chips"])
        entry = {c["name"]: c for c in bench["configs"]}[self.spec["config"]]
        self.config = read_json(os.path.join(ROOT, entry["file"]))
        self.traffic = read_json(os.path.join(package, "traffic", self.spec["traffic"] + ".json"))
        self.limits = read_json(os.path.join(package, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self.reports(m)]
        self.package = package

    def reports(self, metric):
        return self.name in metric.get("workloads", [self.name])

    def system_module(self):
        return importlib.import_module(f"qmcbench.systems.{self.config['kind']}")

    def method_module(self):
        return importlib.import_module(f"qmcbench.methods.{self.traffic['method']}")

    def metric_reader(self, name):
        path = os.path.join(self.package, "metrics", name + ".py")
        if not os.path.exists(path):
            raise MissingFile(f"qmcbench/metrics/{name}.py is missing")
        spec = importlib.util.spec_from_file_location(f"qmcbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def seed_of(seed, stream):
    """A 63-bit seed of one stream of the run's seed."""
    word = np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0]
    return int(word) & (2**63 - 1)


def generator(seed, stream, device):
    import torch

    return torch.Generator(device=device).manual_seed(seed_of(seed, stream))


def sample_walkers(nconf, size, seed, device):
    """The sorted indices of the walkers the reference follows."""
    import torch

    gen = generator(seed, STREAM_SAMPLE, device)
    idx = torch.randperm(nconf, generator=gen, device=device)[:min(size, nconf)]
    return torch.sort(idx).values


class EnergyLog:
    """The program's local energies in its last `depth` calls: `calls`,
    (the sampled walkers' positions, their outputs); `whole`, each output
    of the whole population as the program returned it (kept, not copied).
    Off until `on` is set."""

    def __init__(self, sample, depth):
        self.sample = sample
        self.last = int(sample[-1])  # read once: a read in the window would wait for the card
        self.calls = collections.deque(maxlen=depth)
        self.whole = collections.deque(maxlen=depth)
        self.on = False

    def record(self, positions, out):
        if self.on:
            self.calls.append((self.pick(positions), {k: self.pick(v) for k, v in out.items()}))
            self.whole.append(dict(out))

    def pick(self, x):
        """The sampled walkers' rows of x; inf for a walker past its end (a
        call on fewer walkers than the population: a fault's)."""
        s = self.sample
        if x.shape[0] > self.last:
            return x[s]
        ok = s < x.shape[0]
        out = torch.full((len(s),) + tuple(x.shape[1:]), float("inf"), dtype=x.dtype,
                         device=x.device)
        out[ok] = x[s[ok]]
        return out

    def covers(self, nconf):
        """Whether every kept call evaluated the whole population."""
        return all(o["total"].shape[0] == nconf for o in self.whole)


def recording_energy(mol):
    """The program's EnergyAccumulator for `mol`, which hands each call's
    per-walker outputs to its `log` (an EnergyLog) as well."""
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator

    class RecordingEnergy(EnergyAccumulator):
        log = None

        def __call__(self, wf, params, state, positions, rot=None, u_sel=None, with_imag=False):
            out = super().__call__(wf, params, state, positions, rot, u_sel, with_imag)
            if self.log is not None:
                self.log.record(positions, out)
            return out

    return RecordingEnergy(mol)

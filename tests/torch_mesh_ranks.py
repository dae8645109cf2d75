"""The runs of tests/test_torch_mesh.py, in rank processes and in the test
process. This module imports torch and the port only, never JAX: the rank
processes start from a fresh interpreter and import it.

`spawn(tmp_path, payload)` starts three processes: ranks 0 and 1 of a gloo
group on a FileStore in tmp_path (the walker mesh of two), and a third
whose walker_mesh() makes a group of one of its own. Each rank runs every
scenario of MESH_RUNS under its mesh, plus the JAX-fed block and the comb,
and saves what it got to tmp_path; the third runs VMC and DMC with a mesh
of one and without a mesh. `collect` waits for them (with a timeout) and
reads the results back.

The same scenario functions run in the test process with mesh=None inside
`emulated_ranks(2)`, which makes every block draw the streams that the two
ranks draw (shard_generators, each rank's streams drawn for its walkers
and concatenated in rank order along the walker axis): the one-process run
fed the ranks' concatenated streams. chip_smoke.py phase 36 takes its
reference on the card the same way.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pyqmc_tpu_torch.configs import Geometry, initial_guess
from pyqmc_tpu_torch.convert import params_from_numpy
from pyqmc_tpu_torch.entry import h2o_excited_setup, h2o_setup
from pyqmc_tpu_torch.method import dmc as dmc_mod
from pyqmc_tpu_torch.method import sample_many as overlap_mod
from pyqmc_tpu_torch.method import vmc as vmc_mod
from pyqmc_tpu_torch.method.dmc import branch, rundmc
from pyqmc_tpu_torch.method.ensemble import optimize_ensemble
from pyqmc_tpu_torch.method.linemin import line_minimization
from pyqmc_tpu_torch.method.sample_many import sample_overlap
from pyqmc_tpu_torch.method.vmc import make_vmc_block, shard_generators, vmc
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.transform import LinearTransform
from pyqmc_tpu_torch.parallel.mesh import gather_walkers, shard_walkers, walker_mesh
from pyqmc_tpu_torch.system.io import load_npz
from pyqmc_tpu_torch.wftools import generate_wf

F64 = torch.float64
NCONF = 16  # walkers in all; 8 per rank on the mesh of two
RANK_TIMEOUT = 120.0  # seconds the test waits for the rank processes

# the walker axis of every stream of a block (method/vmc.py, dmc.py, sample_many.py)
VMC_AXES = {"gauss": 2, "unif": 2, "rot": 2, "u_sel": 2}
DMC_AXES = {"gauss": 2, "unif": 2, "erot": 2, "erot0": 1, "tqrot": 2, "u_sel": 2, "u_acc": 2,
            "esel": 2, "esel0": 1}
OVERLAP_AXES = {"gauss": 2, "unif": 2, "rot": 3, "u_sel": 3, "arot": 3, "asel": 3}


def _host(tree):
    """Tensors of a result as numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host(v) for v in tree]
    return tree


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def run_vmc(mesh, payload):
    _, wf, _, configs, acc = h2o_setup(NCONF, device="cpu")
    params = params_from_numpy(payload["params"], device="cpu", dtype=F64)
    data, cfg = vmc(wf, params, configs, nblocks=2, nsteps_per_block=3, accumulators=acc,
                    generator=_gen(11), mesh=mesh)
    return {"data": data, "positions": cfg.positions}


def run_dmc(mesh, payload):
    _, wf, _, configs, acc = h2o_setup(NCONF, device="cpu")
    params = params_from_numpy(payload["params"], device="cpu", dtype=F64)
    blocks, cfg, weights = rundmc(wf, params, configs, nblocks=2, nsteps_per_block=2,
                                  tstep=0.02, energy_acc=acc["energy"], generator=_gen(12),
                                  warmup_vmc_blocks=1, mesh=mesh)
    return {"data": blocks, "positions": cfg.positions, "weights": weights}


def run_linemin(mesh, payload):
    mol, mf = load_npz()
    wf, params, to_opt = generate_wf(mol, mf, device="cpu")
    configs = initial_guess(mol, NCONF, generator=_gen(0), device="cpu")
    lt = LinearTransform(params, to_opt)
    params, cfg, records = line_minimization(
        wf, params, configs, lt, EnergyAccumulator(mol), generator=_gen(13), max_iterations=1,
        vmc_blocks=2, vmc_steps_per_block=2, mesh=mesh)
    rec = records[0]
    return {"x": lt.serialize(params), "positions": cfg.positions, "energy": rec["energy"],
            "energy_err": rec["energy_err"], "gnorm": rec["gnorm"],
            "line_energies": rec["line_energies"], "tau": rec["tau"]}


def run_overlap(mesh, payload):
    _, wfs, plist, configs, acc, _ = h2o_excited_setup(NCONF, device="cpu")
    data, cfg = sample_overlap(wfs, plist, configs, _gen(14), nblocks=2, nsteps=2,
                               energy_acc=acc["energy"], mesh=mesh)
    return {"data": data, "positions": cfg.positions}


def run_ensemble(mesh, payload):
    _, _, _, configs, acc, ens = h2o_excited_setup(NCONF, device="cpu")
    plist, records = optimize_ensemble(**ens, configs=configs, energy_acc=acc["energy"],
                                       generator=_gen(15), max_iterations=1, nblocks=1, nsteps=2,
                                       mesh=mesh)
    x = ens["transforms"][1].serialize(plist[1])
    return {"x": x, "energy1": records[0]["energy1"], "overlap": records[0]["overlap"]}


MESH_RUNS = {"vmc": run_vmc, "dmc": run_dmc, "linemin": run_linemin, "overlap": run_overlap,
             "ensemble": run_ensemble}


def _jax_fed_block(mesh, payload):
    """One VMC block on the streams the JAX package's meshed block draws on
    this rank's shard (fold_in(key, shard index))."""
    _, wf, _, _, acc = h2o_setup(NCONF, device="cpu")
    params = params_from_numpy(payload["params"], device="cpu", dtype=F64)
    p = payload["jax_block"]
    block = make_vmc_block(wf, acc, Geometry(), tstep=p["tstep"], nsteps=p["nsteps"], mesh=mesh)
    pos, wrap = shard_walkers(mesh, torch.as_tensor(p["positions"]),
                              torch.zeros(p["positions"].shape, dtype=torch.int32))
    streams = {k: torch.as_tensor(v) for k, v in p["streams"][mesh.rank].items()}
    pos, wrap, avg = block(params, pos, wrap, None, streams)
    return {"avg": avg, "positions": gather_walkers(mesh, pos)}


def _comb(mesh, payload):
    p = payload["comb"]
    pos, wrap, w = shard_walkers(mesh, *(torch.as_tensor(p[k]) for k in ("positions", "wrap",
                                                                          "weights")))
    pos, wrap, w = branch(pos, wrap, w, torch.as_tensor(p["u_branch"]), mesh=mesh)
    pos, wrap, w = gather_walkers(mesh, pos, wrap, w)
    return {"positions": pos, "wrap": wrap, "weights": w}


def _rank_main(index, store, payload, out_dir):
    torch.set_num_threads(1)
    if index < 2:
        dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=index, world_size=2)
        mesh = walker_mesh(2, device="cpu")
        out = {name: run(mesh, payload) for name, run in MESH_RUNS.items()}
        out["jax_block"] = _jax_fed_block(mesh, payload)
        out["comb"] = _comb(mesh, payload)
        out["mesh"] = (mesh.rank, mesh.size, mesh.backend)
    else:
        mesh = walker_mesh(device="cpu")  # no group yet: a group of one of its own
        out = {"mesh": (mesh.rank, mesh.size, mesh.backend)}
        for name in ("vmc", "dmc"):
            out[f"{name}_mesh1"] = MESH_RUNS[name](mesh, payload)
            out[f"{name}_nomesh"] = MESH_RUNS[name](None, payload)
    torch.save(_host(out), os.path.join(out_dir, f"rank{index}.pt"))
    dist.destroy_process_group()


def spawn(tmp_path, payload):
    """Start the three rank processes; returns what `collect` takes."""
    ctx = mp.start_processes(_rank_main, args=(str(tmp_path / "store"), payload, str(tmp_path)),
                             nprocs=3, join=False, start_method="spawn")
    return ctx, tmp_path


def collect(started):
    """The three processes' results, after they ended (each within
    RANK_TIMEOUT); a rank that failed raises here."""
    ctx, tmp_path = started
    while not ctx.join(timeout=RANK_TIMEOUT):
        pass
    return [torch.load(tmp_path / f"rank{i}.pt", weights_only=False) for i in range(3)]


def _concat(parts, axes):
    return {k: torch.cat([p[k] for p in parts], dim=axes[k]) for k in parts[0]}


@contextlib.contextmanager
def emulated_ranks(size):
    """Within it, a block without a mesh draws the streams of `size` ranks
    (module docstring)."""
    saved = vmc_mod.draw_streams, dmc_mod.draw_dmc_streams, overlap_mod.draw_overlap_streams

    def sharded(draw, nconf_at, axes):
        def f(generator, *args, **kw):
            args = list(args)
            args[nconf_at - 2] //= size  # nconf, the nconf_at-th argument
            parts = [draw(g, *args, **kw) for g in shard_generators(generator, size)]
            return _concat(parts, axes)
        return f

    vmc_mod.draw_streams = sharded(saved[0], 4, VMC_AXES)
    dmc_mod.draw_dmc_streams = sharded(saved[1], 4, DMC_AXES)
    overlap_mod.draw_overlap_streams = sharded(saved[2], 5, OVERLAP_AXES)
    try:
        yield
    finally:
        vmc_mod.draw_streams, dmc_mod.draw_dmc_streams, overlap_mod.draw_overlap_streams = saved


def reference_runs(payload):
    """Every scenario of MESH_RUNS in this process, without a mesh, on the
    two ranks' concatenated streams."""
    with emulated_ranks(2):
        return {name: _host(run(None, payload)) for name, run in MESH_RUNS.items()}

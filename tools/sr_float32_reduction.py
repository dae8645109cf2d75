"""How far float32 SR moves with the walker reduction's order, on the CPU.

    python tools/sr_float32_reduction.py port [nconf] [sr_blocks]   # about 5 minutes
    JAX_PLATFORMS=cpu python tools/sr_float32_reduction.py jax      # reads the port's npz

`port` replays chip_smoke.py phase 36 (c) on the CPU with pyqmc_tpu_torch
only: H2O's walkers after 2 x 10 VMC steps (h2o_setup, 2048 by default),
then one line_minimization iteration (sr_blocks x 10 SR steps, 4 by
default) of generate_wf's Jastrow in float32 and in float64, each on two
gloo ranks (spawned processes, half the walkers each) and in one process
fed the two ranks' streams (tests/torch_mesh_ranks.py:emulated_ranks), so
the two runs differ only in the order of the walker sums. It prints, per
dtype, the parameters' distance (max |x_ranks - x_one| / max |x_one|), the
largest relative difference of each SR average between the two runs,
cond(S + eps) of the step and S's cancellation (max |dpidpj| / max |S|),
and the step's distance when the one-process float32 averages are solved
beside their float64 sums, and writes the float32 averages of both runs to
build/sr_float32_reduction.npz.

`jax` applies the JAX package's own update rule
(pyqmc_tpu/observables/sr.py:StochasticReconfiguration.delta_p, which
keeps float32 averages in float32) to the same two sets of averages and
prints its distance in the same measure.
"""

from __future__ import annotations

import os
import sys
import tempfile
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "sr_float32_reduction.npz")
KEYS = ("total", "dp", "dpH", "dpidpj")
EPS = 1e-3


def _setup(nconf):
    import torch

    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.vmc import vmc

    torch.set_num_threads(4)
    _, wf, params, configs, acc = h2o_setup(nconf, device="cpu", dtype=torch.float32)
    _, configs = vmc(wf, params, configs, nblocks=2, nsteps_per_block=10, accumulators=acc,
                     generator=torch.Generator().manual_seed(91))
    return configs


def _linemin(mesh, positions, dtype, sr_blocks):
    """One iteration from `positions` (the whole population, on every rank);
    returns the serialized parameters, the iteration's SR averages and its
    steps."""
    import torch

    from pyqmc_tpu_torch.configs import Configs
    from pyqmc_tpu_torch.method.linemin import line_minimization
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.transform import LinearTransform
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.wftools import generate_wf

    mol, mf = load_npz()
    wf, p0, to_opt = generate_wf(mol, mf, device="cpu", dtype=dtype)
    lt = LinearTransform(p0, to_opt)
    pos = torch.as_tensor(positions, dtype=dtype)  # every rank passes the whole population
    wrap = torch.zeros(pos.shape, dtype=torch.int32)
    infos = []
    p, _, recs = line_minimization(
        wf, p0, Configs.create(pos, wrap=wrap), lt, EnergyAccumulator(mol),
        generator=torch.Generator().manual_seed(95), max_iterations=1, vmc_blocks=sr_blocks,
        vmc_steps_per_block=10, mesh=mesh, callback=lambda rec, info: infos.append(info))
    avg = {k: np.asarray(infos[0]["block_avg"][k]) for k in KEYS}
    return {"x": lt.serialize(p).double().numpy(), "avg": avg, "tau": recs[0]["tau"],
            "steps": np.asarray(infos[0]["steps"])}


def _rank(index, store, positions, sr_blocks, out_dir):
    import torch
    import torch.distributed as dist

    from pyqmc_tpu_torch.parallel.mesh import walker_mesh

    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=index, world_size=2)
    mesh = walker_mesh(2, device="cpu")
    out = {str(dt): _linemin(mesh, positions, dt, sr_blocks)
           for dt in (torch.float32, torch.float64)}
    torch.save(out, os.path.join(out_dir, f"rank{index}.pt"))
    dist.destroy_process_group()


def _solve(avg, dtype=np.float64):
    """The SR step direction S_eps^-1 g and S of block averages, in `dtype`."""
    m = {k: np.mean(np.asarray(avg[k], dtype=dtype), axis=0) for k in KEYS}
    g = 2.0 * (m["dpH"] - m["total"] * m["dp"])
    S = m["dpidpj"] - np.outer(m["dp"], m["dp"])
    return np.linalg.solve(S + EPS * np.eye(len(g), dtype=dtype), g), S, m["dpidpj"]


def port(nconf=2048, sr_blocks=4):
    import torch
    import torch.multiprocessing as mp

    from tests.torch_mesh_ranks import emulated_ranks

    positions = _setup(nconf).positions.numpy()
    tmp = tempfile.mkdtemp()
    ctx = mp.start_processes(_rank, args=(os.path.join(tmp, "store"), positions, sr_blocks, tmp),
                             nprocs=2, join=False, start_method="spawn")
    with emulated_ranks(2):
        one = {str(dt): _linemin(None, positions, dt, sr_blocks)
               for dt in (torch.float32, torch.float64)}
    while not ctx.join(timeout=1200):
        pass
    ranks = [torch.load(os.path.join(tmp, f"rank{i}.pt"), weights_only=False) for i in range(2)]
    for dt in ("torch.float32", "torch.float64"):
        a, b = ranks[0][dt], one[dt]
        dx = float(np.max(np.abs(a["x"] - b["x"])) / np.max(np.abs(b["x"])))
        davg = {k: float(np.max(np.abs(a["avg"][k].astype(np.float64) - b["avg"][k]))
                         / np.max(np.abs(b["avg"][k]))) for k in KEYS}
        step, S, dpidpj = _solve(b["avg"])
        cond = float(np.linalg.cond(S + EPS * np.eye(len(step))))
        step_r = _solve(a["avg"])[0]
        print(f"{dt}: {nconf} walkers, {sr_blocks} x 10 SR steps; ranks' parameters "
              f"{'equal' if np.array_equal(ranks[0][dt]['x'], ranks[1][dt]['x']) else 'unequal'};"
              f" tau {a['tau']} (two ranks) and {b['tau']} (one process); parameters "
              f"{dx:.3e} relative from one process; SR averages' largest relative difference "
              f"{ {k: float(f'{v:.2e}') for k, v in davg.items()} }; cond(S + {EPS}) {cond:.4e}; "
              f"max |dpidpj| / max |S| {np.max(np.abs(dpidpj)) / np.max(np.abs(S)):.1f}; "
              f"the step from the two sets of averages "
              f"{np.max(np.abs(step_r - step)) / np.max(np.abs(step)):.3e} relative", flush=True)
    f32 = one["torch.float32"]
    exact = _solve(f32["avg"], np.float64)[0]  # the same float32 sums, solved in float64
    print(f"one process, float32 averages: the step solved in float32 is "
          f"{np.max(np.abs(_solve(f32['avg'], np.float32)[0] - exact)) / np.max(np.abs(exact)):.3e}"
          f" relative from the same averages solved in float64", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, **{f"ranks_{k}": ranks[0]["torch.float32"]["avg"][k] for k in KEYS},
             **{f"one_{k}": f32["avg"][k] for k in KEYS})
    print(f"wrote {OUT}")


def jax():
    from pyqmc_tpu.observables.sr import StochasticReconfiguration

    d = np.load(OUT)
    sets = [{k: d[f"{w}_{k}"] for k in KEYS} for w in ("ranks", "one")]
    sr = types.SimpleNamespace(eps=EPS)
    steps = [StochasticReconfiguration.delta_p(sr, [1.0], s)[0][0] for s in sets]
    ref = -_solve(sets[1])[0]
    print(f"the JAX package's delta_p on the same float32 averages (dtype {steps[0].dtype}): "
          f"the two reduction orders' steps {np.max(np.abs(steps[0] - steps[1])) / np.max(np.abs(steps[1])):.3e} "
          f"relative; its one-process step {np.max(np.abs(steps[1] - ref)) / np.max(np.abs(ref)):.3e} "
          f"from the port's float64 solve of the same averages", flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port(*(int(a) for a in sys.argv[2:]))
    else:
        jax()

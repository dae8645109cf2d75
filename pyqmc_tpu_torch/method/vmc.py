"""Variational Monte Carlo driver (counterpart of pyqmc_tpu/method/vmc.py).

A block is a Python loop over steps; each step is one Metropolis sweep over
all electrons (the CUDA kernel of ops/move_sweep.py on the GPU when the
wavefunction passes its gate, else the plain sweep) followed by the
accumulators. All random numbers of a block are drawn at its start from a
torch.Generator, in one batch per kind:

  gauss (nsteps, nelec, nconf, 3), scaled by sqrt(tstep);
  unif  (nsteps, nelec, nconf);
  rot   (nsteps, nelec, nconf, 3, 3), ECP quadrature rotations from normal
        quaternions;
  u_sel (nsteps, nelec, nconf), the per-walker uniform of each electron's
        ECP downselection (observables/ecp.py:systematic_downselect), drawn
        last and only where an accumulator's ECP evaluates a subset of its
        points (a periodic solid), so other paths draw what they did before.

  draws {name: {key: (nsteps, ...)}}, the random numbers of each
        accumulator that draws its own (one with a `draw` method: the
        auxiliary points of the density matrices), drawn after the others,
        in the accumulators' order, and only for such accumulators, so a
        block without one draws what it drew before.

A `streams` dict with those keys replaces the draws, so tests can feed the
port and the JAX package the same numbers.

`vmc(hdf_file=)` appends each block's averages to an HDF5 file (one row per
block, the JAX package's datasets) and keeps the walkers there (group
"configs"); a second call on the same file continues it. h5py is imported
only then: every path without a file runs where h5py is absent.

With a walker mesh (parallel/mesh.py) each rank sweeps its slice of the
walkers. A block's streams come from the rank's generator,
`shard_generators(generator, R)[rank]`, made anew at every block from the
caller's generator (which every rank holds alike), as the JAX block folds
the shard index into its key; the block averages are means over the mesh.
A mesh of one rank draws from the caller's generator itself, so it runs
what no mesh runs, bit for bit.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from ..configs import Configs
from ..models.orbitals import plain_orbitals
from ..observables.ecp import rotations_from_quaternions
from ..ops.move_sweep import build_fused_sweep, limdrift, sweep_plain  # noqa: F401 (limdrift re-exported)
from ..parallel.mesh import check_divides, gather_walkers, mean_over, shard_walkers
from ..utils.profiling import measure_phase_split, trace
from .hdftools import append_hdf, open_hdf


def fold_generator(generator, index):
    """A new torch.Generator on `generator`'s device, seeded from its
    initial seed and `index` (the JAX package's fold_in(key, index)): a run
    resumed at block or iteration `index` draws what it would have drawn
    whatever came before."""
    state = np.random.SeedSequence([int(generator.initial_seed()), int(index)]).generate_state(
        1, np.uint64)
    return torch.Generator(device=generator.device).manual_seed(int(state[0]) & (2**63 - 1))


def shard_generators(generator, size):
    """The generators of the ranks of a mesh of `size` ranks, one per rank:
    a generator seeded from `generator`'s present state, folded with each
    rank (fold_generator). `generator` is then advanced by one draw, so
    the next call gives other streams, as the JAX package splits its key
    before each block and folds the shard index into it. Reading the state
    needs no copy from the device. One rank: [generator] itself."""
    if size == 1:
        return [generator]
    words = np.frombuffer(generator.get_state().numpy().tobytes(), dtype=np.uint32)
    seed = np.random.SeedSequence(words.tolist()).generate_state(1, np.uint64)[0]
    torch.rand((1,), generator=generator, device=generator.device)
    base = torch.Generator(device=generator.device).manual_seed(int(seed) & (2**63 - 1))
    return [fold_generator(base, r) for r in range(size)]


def checkpoint_configs(saved, configs, where):
    """The walkers of a checkpoint, `saved` an h5py "configs" group, a dict
    of its arrays or a Configs, on `configs`' device in its dtype;
    ValueError where their shape or lattice is not that of `configs`."""
    device, dtype = configs.positions.device, configs.positions.dtype
    if isinstance(saved, Configs):  # copied: the run must not write into the caller's
        saved = Configs.create(saved.positions.to(device=device, dtype=dtype, copy=True),
                               saved.geometry, wrap=saved.wrap.to(device, copy=True))
    else:
        saved = Configs.from_hdf(saved, device=device, dtype=dtype)
    if saved.positions.shape != configs.positions.shape:
        raise ValueError(f"{where}: checkpoint walker shape {tuple(saved.positions.shape)} does "
                         f"not match requested {tuple(configs.positions.shape)}; rerun with "
                         "matching nconfig or delete the file")
    if saved.geometry != configs.geometry:
        raise ValueError(f"{where}: checkpoint lattice does not match the requested geometry")
    return saved


def draw_streams(generator, nsteps, nelec, nconf, tstep, device, dtype, downselect=False):
    """One block's random numbers (see the module docstring); u_sel only
    with `downselect`."""
    gdev = generator.device
    gauss = torch.randn((nsteps, nelec, nconf, 3), generator=generator, device=gdev, dtype=dtype)
    unif = torch.rand((nsteps, nelec, nconf), generator=generator, device=gdev, dtype=dtype)
    quat = torch.randn((nsteps, nelec, nconf, 4), generator=generator, device=gdev, dtype=dtype)
    streams = {
        "gauss": (gauss * float(np.sqrt(tstep))).to(device),
        "unif": unif.to(device),
        "rot": rotations_from_quaternions(quat).to(device),
    }
    if downselect:
        streams["u_sel"] = torch.rand((nsteps, nelec, nconf), generator=generator, device=gdev,
                                      dtype=dtype).to(device)
    return streams


def accumulator_draws(accumulators, generator, nsteps, nconf, device, dtype):
    """{name: acc.draw(...)} of the accumulators that draw random numbers of
    their own, in their order (observables/accumulators.py)."""
    return {name: a.draw(generator, nsteps, nconf, device, dtype)
            for name, a in accumulators.items() if hasattr(a, "draw")}


def step_draws(draws, name, step):
    """The keyword arguments of accumulator `name` at `step`: its draws of
    that step, or none for an accumulator that draws nothing."""
    if name not in draws:
        return {}
    return {"draws": {k: v[step] for k, v in draws[name].items()}}


def averages_to_host(avg, dtype):
    """Device averages -> {key: float (0-d) or numpy array}, in one copy to
    the host of all the real ones (flattened and concatenated); complex ones
    (the overlap matrix of complex wavefunctions) are copied apart."""
    keys = sorted(k for k in avg if not avg[k].is_complex())
    out = {}
    if keys:
        flat = torch.cat([avg[k].reshape(-1).to(dtype) for k in keys]).cpu().numpy()
        off = 0
        for k in keys:
            shape = tuple(avg[k].shape)
            n = int(np.prod(shape))
            out[k] = float(flat[off]) if not shape else flat[off:off + n].reshape(shape).copy()
            off += n
    for k in avg:
        if avg[k].is_complex():
            v = avg[k].cpu().numpy()
            out[k] = complex(v) if not v.shape else v
    return out


def downselects(accumulators):
    """Whether an accumulator's ECP evaluates a subset of its quadrature
    points, and so reads the u_sel stream."""
    ecps = (getattr(a, "ecp_acc", a) for a in accumulators.values())
    return any(getattr(e, "nselect", None) is not None for e in ecps)


def make_vmc_block(wf, accumulators, geometry, tstep=0.5, nsteps=10, drift_cutoff=1.0,
                   fused=True, accumulate_every=1, mesh=None):
    """Returns block(params, positions, wrap, generator, streams=None)
    -> (positions, wrap, averages), averages being tensors on the walkers'
    device: "acceptance" (per electron move), the mean over all steps, and
    f"{name}{key}" for every accumulator output (0-d for a walker mean,
    arrays for the SR accumulator's dp, dpidpj or a density matrix), the
    mean over the steps with step % accumulate_every == 0, the only steps
    whose accumulators run (the JAX block evaluates them at every step and
    weights the others by zero). Every step's streams are drawn.

    fused=True takes the CUDA sweep kernel when the wavefunction passes its
    gate (its wrapper runs the plain sweep for CPU tensors): K1 for an open
    boundary, K7 for a periodic real-mode k-point Slater-Jastrow
    (ops/move_sweep_pbc.py); the orbitals take K3 and K6 where their gates
    pass. fused=False runs the plain sweep and evaluates the orbitals
    without K3 and K6 (models/orbitals.py:plain_orbitals); the ECP
    accumulator's kernel K2 is its own choice (ECPAccumulator(fused=)).
    The wrap counts of a periodic geometry are carried through the block.

    mesh: a walker mesh (parallel/mesh.py); each rank passes its own walkers
    and the caller's generator, the block draws from the rank's generator
    (shard_generators) and its averages are the means over the mesh.
    Given `streams` are this rank's.
    """
    accumulators = accumulators or {}
    sweep = build_fused_sweep(wf, geometry, tstep, drift_cutoff) if fused else None
    if sweep is None:
        sweep = functools.partial(sweep_plain, wf, geometry, tstep, drift_cutoff)
    orbitals = contextlib.nullcontext if fused else plain_orbitals
    downselect = downselects(accumulators)
    if accumulate_every < 1:
        raise ValueError(f"accumulate_every must be at least 1, got {accumulate_every}")

    def block(params, positions, wrap, generator, streams=None):
        with orbitals():
            return run(params, positions, wrap, generator, streams)

    def run(params, positions, wrap, generator, streams):
        nconf, nelec = positions.shape[:2]
        state = wf.recompute(params, positions)
        if streams is None:
            if mesh is not None:
                generator = shard_generators(generator, mesh.size)[mesh.rank]
            streams = draw_streams(generator, nsteps, nelec, nconf, tstep, positions.device,
                                   positions.dtype, downselect)
            draws = accumulator_draws(accumulators, generator, nsteps, nconf, positions.device,
                                      positions.dtype)
            if draws:
                streams["draws"] = draws
        draws = streams.get("draws", {})
        acceptance, records = [], []
        for step in range(nsteps):
            positions, wrap, state, acc = sweep(params, positions, wrap, state,
                                                streams["gauss"][step], streams["unif"][step])
            acceptance.append(acc / nelec)
            if step % accumulate_every:
                continue
            out = {}
            for name, a in accumulators.items():
                u_sel = streams["u_sel"][step] if "u_sel" in streams else None
                rot = streams["rot"][step] if "rot" in streams else None
                for k, v in a.avg(wf, params, state, positions, rot, u_sel,
                                  **step_draws(draws, name, step)).items():
                    out[name + k] = v
            records.append(out)
        avg = {"acceptance": torch.mean(torch.stack(acceptance), dim=0)}
        avg.update({k: torch.mean(torch.stack([r[k] for r in records]), dim=0)
                    for k in records[0]})
        if mesh is not None:
            avg = mean_over(mesh, avg)
        return positions, wrap, avg

    return block


def vmc(wf, params, configs: Configs, nblocks: int = 10, nsteps_per_block: int = 10,
        tstep: float = 0.5, accumulators: Optional[dict] = None,
        generator: Optional[torch.Generator] = None, block_fn=None, verbose: bool = False,
        accumulate_every: int = 1, hdf_file: Optional[str] = None,
        continue_from: Optional[str] = None, profile_dir: Optional[str] = None,
        mesh=None, profile_phases: bool = False):
    """Run VMC; returns (list of per-block dicts, final Configs): a 0-d
    average becomes a float, an array-valued one (the SR accumulator's dp,
    dpidpj, a density matrix, ...) a numpy array, as the JAX package's vmc
    returns them. The accumulators run every `accumulate_every` steps.

    hdf_file: append every block's averages to this HDF5 file and keep the
    walkers there; where the file already holds walkers and blocks, continue
    it: its walkers, blocks numbered on from its last, and a generator
    folded from `generator`'s seed and that block (fold_generator).
    continue_from: start from the walkers of another run's file, blocks
    from 0, writing to `hdf_file`, which must not exist yet.
    profile_dir: write a torch.profiler trace of the first block there
    (utils/profiling.trace).
    mesh: a walker mesh (parallel/mesh.py). Every rank passes the whole
    population (`configs`) and a generator in the same state; each sweeps
    its slice (ValueError where the walkers do not divide evenly over the
    ranks), the averages are the mesh's, the returned Configs hold the
    whole population, gathered once at the end, and rank 0 alone writes
    `hdf_file` (the walkers gathered at every block).
    profile_phases: before the blocks, time a block with the accumulators
    and one without (utils/profiling.measure_phase_split, on the walkers'
    start, drawing from `generator`); every block record then carries
    their "move time" and "accumulate time" (the difference).

    Without a file, blocks are pipelined: block b's averages are fetched
    (one copy to the host of all of them, flattened and concatenated) after
    block b+1 has been queued, so the host round trip hides behind device
    work. With a file every block's averages and walkers reach it before
    the next block starts. "block time" is the host time from the block's
    start until `block_fn` returned; the device may still be finishing the
    block's last kernels.
    """
    if generator is None:
        generator = torch.Generator(device=configs.positions.device)
        generator.manual_seed(int(time.time() * 1e6) % (2**31))
    block0 = 0
    if continue_from is not None:
        if hdf_file is not None and os.path.exists(hdf_file):
            raise ValueError(f"continue_from: output file {hdf_file} already exists — refusing "
                             "to overwrite (pick a new hdf_file)")
        with open_hdf(continue_from, "r") as f:
            if "configs" not in f:
                raise ValueError(f"continue_from file {continue_from} holds no walker configs")
            configs = checkpoint_configs(f["configs"], configs, f"VMC checkpoint {continue_from}")
    elif hdf_file is not None and os.path.exists(hdf_file):
        with open_hdf(hdf_file, "r") as f:
            if "configs" in f and "block" in f:
                configs = checkpoint_configs(f["configs"], configs, f"VMC checkpoint {hdf_file}")
                block0 = int(np.asarray(f["block"])[-1]) + 1
                generator = fold_generator(generator, block0)
    if mesh is not None:
        check_divides(configs.positions.shape[0], mesh, "nconf")
    if block_fn is None:
        block_fn = make_vmc_block(wf, accumulators, configs.geometry, tstep=tstep,
                                  nsteps=nsteps_per_block, accumulate_every=accumulate_every,
                                  mesh=mesh)
    if mesh is None:
        positions, wrap = configs.positions.clone(), configs.wrap.clone()
    else:
        positions, wrap = shard_walkers(mesh, configs.positions, configs.wrap)
    writes = hdf_file is not None and (mesh is None or mesh.rank == 0)
    phase_split = None
    if profile_phases and accumulators:
        move_fn = make_vmc_block(wf, {}, configs.geometry, tstep=tstep, nsteps=nsteps_per_block,
                                 accumulate_every=accumulate_every, mesh=mesh)
        split = measure_phase_split(block_fn, move_fn,
                                    (params, positions.clone(), wrap.clone(), generator))
        phase_split = {k: split[k] for k in ("move time", "accumulate time")}
        if verbose:
            print(f"phase split: move {phase_split['move time']:.4f}s, accumulate "
                  f"{phase_split['accumulate time']:.4f}s per block", flush=True)
    block_data = []
    pending = None

    def flush(entry):
        b, avg_dev, seconds = entry
        avg = averages_to_host(avg_dev, configs.positions.dtype)
        avg["block"] = b
        avg["block time"] = seconds
        if phase_split is not None:
            avg.update(phase_split)
        block_data.append(avg)
        if verbose and (mesh is None or mesh.rank == 0):
            tot = avg.get("energytotal")
            print(f"block {b}: acc={avg['acceptance']:.3f}"
                  + (f" E={tot:.6f}" if tot is not None else ""), flush=True)

    def whole():
        """The whole population's walkers."""
        if mesh is None:
            return positions, wrap
        return gather_walkers(mesh, positions, wrap)

    for b in range(block0, block0 + nblocks):
        t0 = time.perf_counter()
        with trace(profile_dir if b == block0 else None):
            positions, wrap, avg = block_fn(params, positions, wrap, generator)
        seconds = time.perf_counter() - t0
        if pending is not None:
            flush(pending)
        pending = (b, avg, seconds)
        if hdf_file is not None:
            flush(pending)
            pending = None
            all_pos, all_wrap = whole()
            if writes:
                with open_hdf(hdf_file, "a") as f:
                    append_hdf(f, block_data[-1])
                    Configs.create(all_pos, configs.geometry, wrap=all_wrap).to_hdf(
                        f.require_group("configs"))
    if pending is not None:
        flush(pending)
    all_pos, all_wrap = whole()
    return block_data, Configs.create(all_pos, configs.geometry, wrap=all_wrap)

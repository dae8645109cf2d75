"""Fixed-node diffusion Monte Carlo with T-moves, branching and population
control (counterpart of pyqmc_tpu/method/dmc.py).

A block is a Python loop over steps. Each step runs the Casula T-move sweep
(ops/tmove_sweep.py) when the ECP has nonlocal channels, the
drift-diffusion sweep with Umrigar drift limiting and fixed-node rejection
(ops/move_sweep.py, mode "dmc"), the energy accumulator, and the weight
update with the effective time step tdamp = r2_accepted / r2_proposed. On
the GPU both sweeps are hand-written CUDA kernels when the wavefunction
passes their gates; for CPU tensors their wrappers run the plain versions.

All random numbers of a block are drawn at its start from a
torch.Generator, in one batch per kind (`draw_dmc_streams`):

  gauss (nsteps, nelec, nconf, 3), scaled by sqrt(tstep);
  unif  (nsteps, nelec, nconf), the drift-diffusion acceptance;
  erot  (nsteps, nelec, nconf, 3, 3), each step's ECP-energy rotations;
  erot0 (nelec, nconf, 3, 3), the rotations of the block's first energy;
  tqrot (nsteps, nelec, nconf, 3, 3), u_sel and u_acc (nsteps, nelec,
        nconf): the T-move quadrature rotations and uniforms; u_sel picks
        the T-move's point among the dense quadrature's;
  esel  (nsteps, nelec, nconf), each step's ECP-energy downselection
        uniforms (observables/ecp.py:systematic_downselect);
  esel0 (nelec, nconf), those of the block's first energy.

esel and esel0 are drawn only where the energy's ECP evaluates a subset of
its points (a periodic solid). They are the energy's selection stream and
have nothing to do with the T-moves' u_sel: the T-move quadrature is
always dense. Last, where the block holds further accumulators:

  draws {name: {key: (nsteps, ...)}}, each further accumulator's own
        numbers, in the accumulators' order, as the JAX block gives each
        its own key: for one with an ECP its rotations "rot" (nsteps,
        nelec, nconf, 3, 3), and "u_sel" where that ECP downselects;
        then, for one that draws its own (acc.draw), its draws.

So a block without further accumulators draws what it drew before. A
`streams` dict with those keys replaces the draws, so tests can feed the
port and the JAX package the same numbers. The comb takes its one
uniform, `u_branch`, as an argument.

`rundmc` is the pipelined path of the JAX package's `rundmc`: propagation, population
control and branching keep their state on the device, and a block's
averages are copied to the host only after `pipeline_depth` later blocks
have been queued. With `hdf_file` every block is copied at once and
written to the file (its averages as a row, the walkers, the weights and
esigma), and a second call on the file resumes the run from them; the
same restart contents can be carried in a dict (`checkpoint=`), so a run
resumes on a machine without h5py.

With a walker mesh (parallel/mesh.py) each rank propagates its slice of
the walkers on the streams of its own generator (vmc.shard_generators);
the weighted block means reduce their numerators and denominators over
the mesh, so the population control reads global scalars, and the comb is
global: the weights, positions and wrap counts are gathered in rank order,
one comb with a `u_branch` drawn from the caller's generator (alike on
every rank, as the JAX package uses one key on every shard) resamples the
whole population, each rank keeps its slice and every weight becomes the
global mean. A comb local to each rank would leave each shard's weights
uniform but not the population's.
"""

from __future__ import annotations

import collections
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
from ..ops.move_sweep import build_fused_sweep, limdrift_umrigar, sweep_plain
from ..ops.tmove_sweep import build_fused_tmove_sweep, tmove_sweep_plain
from ..parallel.mesh import check_divides, gather_walkers, shard_walkers, sum_over
from ..utils.profiling import trace
from .hdftools import append_hdf, open_hdf
from .vmc import (accumulator_draws, averages_to_host, checkpoint_configs, downselects,
                  fold_generator, shard_generators)
from .vmc import vmc as vmc_run

__all__ = ["limdrift_umrigar", "compute_S", "branch", "draw_dmc_streams", "make_dmc_block",
           "make_popctrl_update", "read_checkpoint", "restart_state", "rundmc"]


def compute_S(e_trial, e_est, esigma, eloc, grad2, tstep, nelec):
    """Saturated, velocity-damped branching exponent:
    S = E_T - E_est + clip(E_est - E_L, +-esigma sqrt(2 / tau))
                      / sqrt(1 + (v^2 tau / nelec)^2).
    The damping suppresses the diverging local energy of a walker near a
    node."""
    cutoff = esigma * float(np.sqrt(2.0 / tstep))
    eclip = torch.clamp(e_est - eloc, min=-cutoff, max=cutoff)
    denom = torch.sqrt(1.0 + (grad2 * tstep / nelec) ** 2)
    return e_trial - e_est + eclip / denom


def branch(positions, wrap, weights, u_branch, mesh=None):
    """Stochastic comb (systematic resampling) on the walkers' device:
    nconf teeth spaced sum(w) / nconf apart, the first at u_branch times
    the spacing. Returns (positions, wrap, weights), every weight reset to
    the mean. With a mesh the comb is global (the module docstring):
    u_branch must be alike on every rank."""
    nconf = weights.shape[0]
    if mesh is None:
        idx = _comb(weights, u_branch)
        return positions[idx], wrap[idx], torch.ones_like(weights) * torch.mean(weights)
    wall, pall, rall = gather_walkers(mesh, weights, positions, wrap)
    idx = _comb(wall, u_branch)[mesh.rank * nconf:(mesh.rank + 1) * nconf]
    return pall[idx], rall[idx], torch.ones_like(weights) * torch.mean(wall)


def _comb(weights, u_branch):
    """The indices the comb keeps."""
    n = weights.shape[0]
    cum = torch.cumsum(weights, dim=0)
    spacing = cum[-1] / n
    pts = u_branch * spacing + torch.arange(n, device=weights.device,
                                            dtype=weights.dtype) * spacing
    return torch.clamp(torch.searchsorted(cum, pts), 0, n - 1)


def draw_dmc_streams(generator, nsteps, nelec, nconf, tstep, device, dtype, tmoves=True,
                     downselect=False, accumulators=None):
    """One block's random numbers (see the module docstring); esel and
    esel0 only with `downselect`, draws only for `accumulators` (the
    further ones)."""
    gdev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=gdev, dtype=dtype)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=gdev, dtype=dtype)

    def rotations(*shape):
        return rotations_from_quaternions(normal(*shape, 4)).to(device)

    streams = {
        "gauss": (normal(nsteps, nelec, nconf, 3) * float(np.sqrt(tstep))).to(device),
        "unif": uniform(nsteps, nelec, nconf).to(device),
        "erot": rotations(nsteps, nelec, nconf),
        "erot0": rotations(nelec, nconf),
    }
    if tmoves:
        streams["tqrot"] = rotations(nsteps, nelec, nconf)
        streams["u_sel"] = uniform(nsteps, nelec, nconf).to(device)
        streams["u_acc"] = uniform(nsteps, nelec, nconf).to(device)
    if downselect:
        streams["esel"] = uniform(nsteps, nelec, nconf).to(device)
        streams["esel0"] = uniform(nelec, nconf).to(device)
    draws = {}
    for name, a in (accumulators or {}).items():
        d = {}
        if _ecp_of(a) is not None:
            d["rot"] = rotations(nsteps, nelec, nconf)
            if downselects({name: a}):
                d["u_sel"] = uniform(nsteps, nelec, nconf).to(device)
        d.update(accumulator_draws({name: a}, generator, nsteps, nconf, device, dtype).get(name, {}))
        if d:
            draws[name] = d
    if draws:
        streams["draws"] = draws
    return streams


def _ecp_of(acc):
    """The ECP an accumulator evaluates (its own ecp_acc, or itself for an
    ECPAccumulator), or None."""
    from ..observables.ecp import ECPAccumulator

    return acc if isinstance(acc, ECPAccumulator) else getattr(acc, "ecp_acc", None)


def _weighted_sum(x, w):
    wb = w.reshape(w.shape + (1,) * (x.ndim - 1))
    return torch.sum(wb * x, dim=0)


def make_dmc_block(wf, energy_acc, geometry, tstep, nsteps, tdamp=None, tmoves=True,
                   accumulators=None, fused=True, mesh=None):
    """(block, branch) of a DMC run.

    block(params, positions, wrap, weights, generator, e_trial, e_est,
          esigma, streams=None) -> (positions, wrap, weights, averages):
    nsteps propagation steps; averages are tensors on the walkers'
    device, weight-averaged over walkers and averaged over steps:
    "acceptance", "weight", "energy{key}" and f"{name}{key}" for every
    further accumulator (0-d, or arrays for a density matrix), each of
    which reads its own streams (the module docstring).

    tdamp=None uses each walker's effective-time-step ratio
    r2_accepted / r2_proposed; a float fixes it. tmoves=False leaves the
    T-move sweep out (the locality approximation). fused=True takes the
    CUDA kernels when the wavefunction passes their gates (their wrappers
    run the plain versions for CPU tensors); fused=False always runs the
    plain sweeps and evaluates the orbitals without K3 and K6
    (models/orbitals.py:plain_orbitals). The ECP energy's kernel K2 is the
    accumulator's own choice (ECPAccumulator(fused=)).

    mesh: a walker mesh; each rank passes its walkers and weights and the
    caller's generator, the block draws from the rank's generator, its
    weighted means are global (each step's numerators and denominators
    summed over the mesh) and `branch` is the global comb.
    """
    accumulators = accumulators or {}
    nelec = wf.nelec
    ecp_acc = getattr(energy_acc, "ecp_acc", None)
    do_tmoves = bool(tmoves) and ecp_acc is not None and ecp_acc.active
    sweep = build_fused_sweep(wf, geometry, tstep, mode="dmc") if fused else None
    if sweep is None:
        sweep = functools.partial(sweep_plain, wf, geometry, tstep, 1.0, mode="dmc")
    tmove = None
    if do_tmoves:
        tmove = build_fused_tmove_sweep(wf, geometry, ecp_acc, tstep) if fused else None
        if tmove is None:
            tmove = functools.partial(tmove_sweep_plain, wf, geometry, ecp_acc, tstep)
    orbitals = contextlib.nullcontext if fused else plain_orbitals
    downselect = downselects({"energy": energy_acc})

    def block(params, positions, wrap, weights, generator, e_trial, e_est, esigma,
              streams=None):
        with orbitals():
            return run(params, positions, wrap, weights, generator, e_trial, e_est, esigma,
                       streams)

    def run(params, positions, wrap, weights, generator, e_trial, e_est, esigma, streams):
        nconf = positions.shape[0]
        if streams is None:
            if mesh is not None:
                generator = shard_generators(generator, mesh.size)[mesh.rank]
            streams = draw_dmc_streams(generator, nsteps, nelec, nconf, tstep, positions.device,
                                       positions.dtype, tmoves=do_tmoves, downselect=downselect,
                                       accumulators=accumulators)
        esel = streams.get("esel")
        draws = streams.get("draws", {})
        state = wf.recompute(params, positions)
        edat0 = energy_acc(wf, params, state, positions, streams["erot0"], streams.get("esel0"))
        S_old = compute_S(e_trial, e_est, esigma, edat0["total"], edat0["grad2"], tstep, nelec)
        # per step: the plain means, and the weighted sums with their
        # denominator; the weighted means are taken at the end, after the
        # sums are reduced over the mesh
        means, sums, dens = [], [], []
        for step in range(nsteps):
            if do_tmoves:
                positions, wrap, state = tmove(params, positions, wrap, state,
                                               streams["tqrot"][step], streams["u_sel"][step],
                                               streams["u_acc"][step])
            positions, wrap, state, (acc, r2p, r2a) = sweep(
                params, positions, wrap, state, streams["gauss"][step], streams["unif"][step])
            u_sel = None if esel is None else esel[step]
            edat = energy_acc(wf, params, state, positions, streams["erot"][step], u_sel)
            S_new = compute_S(e_trial, e_est, esigma, edat["total"], edat["grad2"], tstep, nelec)
            # effective time step: the accepted share of the proposed
            # squared displacement
            step_tdamp = r2a / torch.clamp(r2p, min=1e-30) if tdamp is None else tdamp
            weights = weights * torch.exp(tstep * step_tdamp * 0.5 * (S_new + S_old))
            S_old = S_new
            wsum = {f"energy{k}": _weighted_sum(v, weights) for k, v in edat.items()}
            for name, a in accumulators.items():
                # weight-averaged mixed estimator, on the accumulator's own streams
                own = {k: v[step] for k, v in draws.get(name, {}).items()}
                rot, a_sel = own.pop("rot", None), own.pop("u_sel", None)
                kw = {"draws": own} if hasattr(a, "draw") else {}
                for k, v in a(wf, params, state, positions, rot, a_sel, **kw).items():
                    wsum[f"{name}{k}"] = _weighted_sum(v, weights)
            means.append({"acceptance": acc / nelec, "weight": torch.mean(weights)})
            sums.append(wsum)
            dens.append(torch.sum(weights, dim=0))
        avg = {k: torch.mean(torch.stack([m[k] for m in means]), dim=0) for k in means[0]}
        num = {k: torch.stack([r[k] for r in sums]) for k in sums[0]}
        den = torch.stack(dens)
        if mesh is not None:
            avg, num, den = sum_over(mesh, (avg, num, den))
            avg = {k: v / mesh.size for k, v in avg.items()}
        for k, v in num.items():
            avg[k] = torch.mean(v / den.reshape(den.shape + (1,) * (v.ndim - 1)), dim=0)
        return positions, wrap, weights, avg

    return block, (branch if mesh is None else functools.partial(branch, mesh=mesh))


def make_popctrl_update(feedback, ewin):
    """update(ring, nhist, eb, wavg) -> (ring, nhist, e_trial, e_est): the
    population control between blocks, on device scalars with no copy to
    the host. `ring` (ewin,) holds the last block energies, `nhist` (0-d
    int64) how many were written; e_est is the mean of the window and
    e_trial = e_est - feedback * log(mean weight)."""

    def update(ring, nhist, eb, wavg):
        slot = torch.arange(ewin, device=ring.device) == nhist % ewin
        ring = torch.where(slot, eb.to(ring.dtype), ring)
        nhist = nhist + 1
        e_est = torch.sum(ring) / torch.clamp(nhist, max=ewin).to(ring.dtype)
        e_trial = e_est - feedback * torch.log(torch.clamp(wavg.to(ring.dtype), min=1e-12))
        return ring, nhist, e_trial, e_est

    return update


_CHECKPOINT_KEYS = {"weights", "configs", "e_trial", "e_est", "block"}


def read_checkpoint(hdf_file):
    """The restart contents of a DMC checkpoint file (rundmc(hdf_file=) of
    either package): {"configs": {"positions", "wrap"[, "lattice"]} numpy,
    "weights", and the last block's "e_trial", "e_est", "block"; "esigma"}.
    None where the file does not exist or holds nothing (a run killed
    before its first block); ValueError where it holds something else (a
    VMC output, an optimization file)."""
    if not os.path.exists(hdf_file):
        return None
    with open_hdf(hdf_file, "r") as f:
        keys = set(f.keys())
        if _CHECKPOINT_KEYS <= keys:
            return {"configs": {k: np.asarray(f["configs"][k])
                                for k in ("positions", "wrap", "lattice") if k in f["configs"]},
                    "weights": np.asarray(f["weights"]),
                    "e_trial": float(np.asarray(f["e_trial"])[-1]),
                    "e_est": float(np.asarray(f["e_est"])[-1]),
                    "block": int(np.asarray(f["block"])[-1]),
                    "esigma": float(f.attrs.get("esigma", 1.0))}
        if keys:
            raise ValueError(f"not a DMC checkpoint: {hdf_file} has keys {sorted(keys)} but a DMC "
                             f"restart needs {sorted(_CHECKPOINT_KEYS)}; point hdf_file at a "
                             "fresh path or a DMC-produced checkpoint")
    return None


def restart_state(contents, configs, where="DMC restart"):
    """(configs, weights, e_trial, e_est, esigma, first block) of a restart
    from checkpoint contents (read_checkpoint's, or the dict rundmc fills
    through `checkpoint=`), on `configs`' device in its dtype; ValueError
    where the walkers' shape, their count against the weights' or the
    lattice is not that of `configs`."""
    device, dtype = configs.positions.device, configs.positions.dtype
    saved = checkpoint_configs(contents["configs"], configs, where)
    weights = torch.as_tensor(contents["weights"]).to(device=device, dtype=dtype, copy=True)
    if weights.shape[0] != configs.positions.shape[0]:
        raise ValueError(f"{where}: {weights.shape[0]} saved weights vs "
                         f"{configs.positions.shape[0]} walkers")
    scalar = lambda v: torch.as_tensor(float(v), dtype=dtype, device=device)
    return (saved, weights, scalar(contents["e_trial"]), scalar(contents["e_est"]),
            scalar(contents["esigma"]), int(contents["block"]) + 1)


def rundmc(wf, params, configs: Configs, nblocks: int = 100, nsteps_per_block: int = 10,
           tstep: float = 0.02, accumulators: Optional[dict] = None, energy_acc=None,
           generator: Optional[torch.Generator] = None, verbose: bool = False,
           feedback: float = 1.0, warmup_vmc_blocks: int = 5, branchtime: int = 1,
           ewin: int = 25, pipeline_depth: int = 4, hdf_file: Optional[str] = None,
           profile_dir: Optional[str] = None, checkpoint: Optional[dict] = None, mesh=None):
    """Run DMC where `configs` live; returns (list of per-block dicts of
    floats, numpy arrays for array-valued averages, final Configs, final
    weights).

    A VMC warm-up of `warmup_vmc_blocks` blocks (10 steps, tstep 0.5)
    equilibrates the walkers; the local energies after it give the first
    e_est, e_trial and the clipping width esigma (their rotations, and
    where the ECP downselects their selection uniforms, are drawn from
    `generator` after the warm-up's). Then, per block: the
    propagation block, the population-control update and, every
    `branchtime` blocks, the comb. Each block dict carries the block's
    averages plus "e_trial", "e_est", "block" and "block time" (the host
    time between this block's copy to the host and the previous one's).

    hdf_file: append every block's averages to this HDF5 file, keep the
    walkers, weights and esigma there; where it already holds a DMC
    checkpoint, resume from it (read_checkpoint, restart_state): no
    warm-up, its walkers, weights, e_trial, e_est and esigma, blocks
    numbered on from its last, and a generator folded from `generator`'s
    seed and that block (fold_generator). A file of another kind raises; an
    empty one starts afresh.
    checkpoint: a dict standing for the file's restart contents: empty, the
    run starts afresh; holding contents (as rundmc leaves them, or
    read_checkpoint's), it resumes from them as from a file. rundmc leaves
    the contents of its last block in it (device tensors, no copy to the
    host).
    profile_dir: write a torch.profiler trace of the first block there
    (utils/profiling.trace).
    mesh: a walker mesh (parallel/mesh.py). Every rank passes the whole
    population and a generator in the same state; each propagates its
    slice (ValueError where the walkers do not divide evenly), the warm-up
    runs under the same mesh, the rotations of the first local energies
    are drawn for the whole population on every rank (each takes its
    slice), the comb is global (the module docstring). The restart
    contents, the returned Configs and weights hold the whole population;
    rank 0 alone writes `hdf_file`.
    """
    if energy_acc is None:
        raise ValueError("energy_acc (EnergyAccumulator) is required")
    device, dtype = configs.positions.device, configs.positions.dtype
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(time.time() * 1e6) % (2**31))
    nconf, nelec = configs.positions.shape[:2]
    if mesh is not None:
        check_divides(nconf, mesh, "nconf")
        device = mesh.device
    contents = read_checkpoint(hdf_file) if hdf_file is not None else checkpoint or None

    def local(*arrays):
        """This rank's slice of whole-population arrays."""
        return arrays if mesh is None else shard_walkers(mesh, *arrays)

    def whole(*arrays):
        """The whole population's arrays from this rank's slices."""
        if mesh is None:
            return arrays
        out = gather_walkers(mesh, *arrays)
        return out if len(arrays) > 1 else (out,)

    if contents is not None:
        where = f"DMC restart from {hdf_file}" if hdf_file is not None else "DMC restart"
        configs, weights, e_trial, e_est, esigma, block0 = restart_state(contents, configs, where)
        positions, wrap, weights = local(configs.positions, configs.wrap, weights)
        generator = fold_generator(generator, block0)
        if verbose:
            print(f"dmc: resuming at block {block0}", flush=True)
    else:
        # VMC warm-up, then e_trial from the walkers' local energies
        _, configs = vmc_run(wf, params, configs, nblocks=warmup_vmc_blocks,
                             nsteps_per_block=10, tstep=0.5,
                             accumulators={"energy": energy_acc}, generator=generator, mesh=mesh)
        positions, wrap = local(configs.positions, configs.wrap)
        quat = torch.randn((nelec, nconf, 4), generator=generator, device=generator.device,
                           dtype=dtype)
        rot = rotations_from_quaternions(quat).to(device)
        u_sel = None
        if downselects({"energy": energy_acc}):
            u_sel = torch.rand((nelec, nconf), generator=generator, device=generator.device,
                               dtype=dtype).to(device)
        if mesh is not None:  # the rotations of this rank's walkers
            rot = shard_walkers(mesh, rot.transpose(0, 1)).transpose(0, 1)
            u_sel = None if u_sel is None else shard_walkers(mesh, u_sel.T).T
        eloc, = whole(energy_acc(wf, params, wf.recompute(params, positions), positions, rot,
                                 u_sel)["total"])
        e_est = torch.mean(eloc)
        esigma = torch.std(eloc, unbiased=False)
        e_trial = e_est
        weights = torch.ones(positions.shape[0], dtype=dtype, device=device)
        block0 = 0

    block_fn, branch_fn = make_dmc_block(wf, energy_acc, configs.geometry, tstep,
                                         nsteps_per_block, accumulators=accumulators, mesh=mesh)
    popctrl = make_popctrl_update(feedback, ewin)
    ring = torch.zeros(ewin, dtype=dtype, device=device)
    ring[0] = e_est
    nhist = torch.ones((), dtype=torch.int64, device=device)

    block_data = []
    last_flush = [None]
    talks = mesh is None or mesh.rank == 0

    def finish(avg_dev, b, t0):
        avg = averages_to_host(avg_dev, dtype)
        now = time.perf_counter()
        avg["block time"] = now - (last_flush[0] if last_flush[0] is not None else t0)
        last_flush[0] = now
        avg["block"] = b
        block_data.append(avg)
        if verbose and talks:
            print(f"dmc block {b}: E={avg['energytotal']:.6f} w={avg['weight']:.4f} "
                  f"e_trial={avg['e_trial']:.6f}", flush=True)

    def write(avg, saved):
        all_pos, all_wrap, all_w = saved
        if not talks:
            return
        with open_hdf(hdf_file, "a") as f:
            append_hdf(f, avg)
            Configs.create(all_pos, configs.geometry, wrap=all_wrap).to_hdf(
                f.require_group("configs"))
            w = all_w.detach().cpu().numpy()
            if "weights" in f:
                f["weights"][...] = w
            else:
                f.create_dataset("weights", data=w)
            f.attrs["esigma"] = float(esigma)

    # with a file every block reaches it before the next one starts
    depth = 0 if hdf_file is not None else max(pipeline_depth, 1)
    pending = collections.deque()
    for b in range(block0, block0 + nblocks):
        t0 = time.perf_counter()
        with trace(profile_dir if b == block0 else None):
            positions, wrap, weights, avg = block_fn(params, positions, wrap, weights, generator,
                                                     e_trial, e_est, esigma)
        ring, nhist, e_trial, e_est = popctrl(ring, nhist, avg["energytotal"], avg["weight"])
        avg = dict(avg)
        avg["e_trial"], avg["e_est"] = e_trial, e_est
        if (b + 1) % branchtime == 0:
            u_branch = torch.rand((), generator=generator, device=generator.device,
                                  dtype=dtype).to(device)
            positions, wrap, weights = branch_fn(positions, wrap, weights, u_branch)
        saved = None
        if checkpoint is not None or hdf_file is not None:
            saved = whole(positions, wrap, weights) if mesh is not None else (
                positions.clone(), wrap.clone(), weights.clone())
        if checkpoint is not None:
            checkpoint.update(configs=Configs.create(saved[0], configs.geometry, wrap=saved[1]),
                              weights=saved[2], e_trial=e_trial, e_est=e_est, esigma=esigma,
                              block=b)
        pending.append((avg, b, t0))
        if len(pending) > depth:
            finish(*pending.popleft())
            if hdf_file is not None:
                write(block_data[-1], saved)
    while pending:
        finish(*pending.popleft())
    positions, wrap, weights = whole(positions, wrap, weights)
    return block_data, Configs.create(positions, configs.geometry, wrap=wrap), weights

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
        nconf): the T-move quadrature rotations and uniforms.

A `streams` dict with those keys replaces the draws, so tests can feed the
port and the JAX package the same numbers. The comb takes its one uniform,
`u_branch`, as an argument.

`rundmc` is the pipelined path of the JAX package's `rundmc`: propagation, population
control and branching keep their state on the device, and a block's
averages are copied to the host only after `pipeline_depth` later blocks
have been queued. Not ported: `mesh=`, the checkpoint file with restart
(they need h5py) and `profile_dir`.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..configs import Configs
from ..models.orbitals import plain_orbitals
from ..observables.ecp import rotations_from_quaternions
from ..ops.move_sweep import build_fused_sweep, limdrift_umrigar, sweep_plain
from ..ops.tmove_sweep import build_fused_tmove_sweep, tmove_sweep_plain
from .vmc import vmc as vmc_run

__all__ = ["limdrift_umrigar", "compute_S", "branch", "draw_dmc_streams", "make_dmc_block",
           "make_popctrl_update", "rundmc"]


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


def branch(positions, wrap, weights, u_branch):
    """Stochastic comb (systematic resampling) on the walkers' device:
    nconf teeth spaced sum(w) / nconf apart, the first at u_branch times
    the spacing. Returns (positions, wrap, weights), every weight reset to
    the mean."""
    nconf = weights.shape[0]
    cum = torch.cumsum(weights, dim=0)
    spacing = cum[-1] / nconf
    pts = u_branch * spacing + torch.arange(nconf, device=weights.device,
                                            dtype=weights.dtype) * spacing
    idx = torch.clamp(torch.searchsorted(cum, pts), 0, nconf - 1)
    return positions[idx], wrap[idx], torch.ones_like(weights) * torch.mean(weights)


def draw_dmc_streams(generator, nsteps, nelec, nconf, tstep, device, dtype, tmoves=True):
    """One block's random numbers (see the module docstring)."""
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
    return streams


def _weighted_mean(x, w):
    wb = w.reshape(w.shape + (1,) * (x.ndim - 1))
    return torch.sum(wb * x, dim=0) / torch.sum(w, dim=0)


def make_dmc_block(wf, energy_acc, geometry, tstep, nsteps, tdamp=None, tmoves=True,
                   accumulators=None, fused=True):
    """(block, branch) of a DMC run.

    block(params, positions, wrap, weights, generator, e_trial, e_est,
          esigma, streams=None) -> (positions, wrap, weights, averages):
    nsteps propagation steps; averages are 0-d tensors on the walkers'
    device, weight-averaged over walkers and averaged over steps:
    "acceptance", "weight", "energy{key}" and f"{name}{key}" for every
    further accumulator.

    tdamp=None uses each walker's effective-time-step ratio
    r2_accepted / r2_proposed; a float fixes it. tmoves=False leaves the
    T-move sweep out (the locality approximation). fused=True takes the
    CUDA kernels when the wavefunction passes their gates (their wrappers
    run the plain versions for CPU tensors); fused=False always runs the
    plain sweeps and evaluates the orbitals without K3 and K6
    (models/orbitals.py:plain_orbitals). The ECP energy's kernel K2 is the
    accumulator's own choice (ECPAccumulator(fused=)).
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

    def block(params, positions, wrap, weights, generator, e_trial, e_est, esigma,
              streams=None):
        with orbitals():
            return run(params, positions, wrap, weights, generator, e_trial, e_est, esigma,
                       streams)

    def run(params, positions, wrap, weights, generator, e_trial, e_est, esigma, streams):
        nconf = positions.shape[0]
        if streams is None:
            streams = draw_dmc_streams(generator, nsteps, nelec, nconf, tstep, positions.device,
                                       positions.dtype, tmoves=do_tmoves)
        state = wf.recompute(params, positions)
        edat0 = energy_acc(wf, params, state, positions, streams["erot0"])
        S_old = compute_S(e_trial, e_est, esigma, edat0["total"], edat0["grad2"], tstep, nelec)
        records = []
        for step in range(nsteps):
            if do_tmoves:
                positions, wrap, state = tmove(params, positions, wrap, state,
                                               streams["tqrot"][step], streams["u_sel"][step],
                                               streams["u_acc"][step])
            positions, wrap, state, (acc, r2p, r2a) = sweep(
                params, positions, wrap, state, streams["gauss"][step], streams["unif"][step])
            edat = energy_acc(wf, params, state, positions, streams["erot"][step])
            S_new = compute_S(e_trial, e_est, esigma, edat["total"], edat["grad2"], tstep, nelec)
            # effective time step: the accepted share of the proposed
            # squared displacement
            step_tdamp = r2a / torch.clamp(r2p, min=1e-30) if tdamp is None else tdamp
            weights = weights * torch.exp(tstep * step_tdamp * 0.5 * (S_new + S_old))
            S_old = S_new
            out = {"acceptance": acc / nelec}
            for k, v in edat.items():
                out[f"energy{k}"] = _weighted_mean(v, weights)
            for name, a in accumulators.items():
                # weight-averaged mixed estimator
                for k, v in a(wf, params, state, positions, streams["erot"][step]).items():
                    out[f"{name}{k}"] = _weighted_mean(v, weights)
            out["weight"] = torch.mean(weights)
            records.append(out)
        avg = {k: torch.mean(torch.stack([r[k] for r in records]), dim=0) for k in records[0]}
        return positions, wrap, weights, avg

    return block, branch


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


def rundmc(wf, params, configs: Configs, nblocks: int = 100, nsteps_per_block: int = 10,
           tstep: float = 0.02, accumulators: Optional[dict] = None, energy_acc=None,
           generator: Optional[torch.Generator] = None, verbose: bool = False,
           feedback: float = 1.0, warmup_vmc_blocks: int = 5, branchtime: int = 1,
           ewin: int = 25, pipeline_depth: int = 4):
    """Run DMC where `configs` live; returns (list of per-block dicts of
    floats, final Configs, final weights).

    A VMC warm-up of `warmup_vmc_blocks` blocks (10 steps, tstep 0.5)
    equilibrates the walkers; the local energies after it give the first
    e_est, e_trial and the clipping width esigma. Then, per block: the
    propagation block, the population-control update and, every
    `branchtime` blocks, the comb. Each block dict carries the block's
    averages plus "e_trial", "e_est", "block" and "block time" (the host
    time between this block's copy to the host and the previous one's).
    """
    if energy_acc is None:
        raise ValueError("energy_acc (EnergyAccumulator) is required")
    device, dtype = configs.positions.device, configs.positions.dtype
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(time.time() * 1e6) % (2**31))
    nconf, nelec = configs.positions.shape[:2]

    # VMC warm-up, then e_trial from the walkers' local energies
    _, configs = vmc_run(wf, params, configs, nblocks=warmup_vmc_blocks, nsteps_per_block=10,
                         tstep=0.5, accumulators={"energy": energy_acc}, generator=generator)
    positions, wrap = configs.positions, configs.wrap
    quat = torch.randn((nelec, nconf, 4), generator=generator, device=generator.device,
                       dtype=dtype)
    eloc = energy_acc(wf, params, wf.recompute(params, positions), positions,
                      rotations_from_quaternions(quat).to(device))["total"]
    e_est = torch.mean(eloc)
    esigma = torch.std(eloc, unbiased=False)
    e_trial = e_est
    weights = torch.ones(nconf, dtype=dtype, device=device)

    block_fn, branch_fn = make_dmc_block(wf, energy_acc, configs.geometry, tstep,
                                         nsteps_per_block, accumulators=accumulators)
    popctrl = make_popctrl_update(feedback, ewin)
    ring = torch.zeros(ewin, dtype=dtype, device=device)
    ring[0] = e_est
    nhist = torch.ones((), dtype=torch.int64, device=device)

    block_data = []
    last_flush = [None]

    def finish(avg_dev, b, t0):
        keys = sorted(avg_dev)
        values = torch.stack([avg_dev[k].to(dtype) for k in keys]).cpu().tolist()
        avg = dict(zip(keys, values))
        now = time.perf_counter()
        avg["block time"] = now - (last_flush[0] if last_flush[0] is not None else t0)
        last_flush[0] = now
        avg["block"] = b
        block_data.append(avg)
        if verbose:
            print(f"dmc block {b}: E={avg['energytotal']:.6f} w={avg['weight']:.4f} "
                  f"e_trial={avg['e_trial']:.6f}", flush=True)

    pending = collections.deque()
    for b in range(nblocks):
        t0 = time.perf_counter()
        positions, wrap, weights, avg = block_fn(params, positions, wrap, weights, generator,
                                                 e_trial, e_est, esigma)
        ring, nhist, e_trial, e_est = popctrl(ring, nhist, avg["energytotal"], avg["weight"])
        avg = dict(avg)
        avg["e_trial"], avg["e_est"] = e_trial, e_est
        if (b + 1) % branchtime == 0:
            u_branch = torch.rand((), generator=generator, device=generator.device,
                                  dtype=dtype).to(device)
            positions, wrap, weights = branch_fn(positions, wrap, weights, u_branch)
        pending.append((avg, b, t0))
        if len(pending) > max(pipeline_depth, 1):
            finish(*pending.popleft())
    while pending:
        finish(*pending.popleft())
    return block_data, Configs.create(positions, configs.geometry, wrap=wrap), weights

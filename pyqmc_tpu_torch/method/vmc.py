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
port and the JAX package the same numbers. The checkpoint file and restart
of the JAX driver need h5py and are not ported yet.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..configs import Configs
from ..models.orbitals import plain_orbitals
from ..observables.ecp import rotations_from_quaternions
from ..ops.move_sweep import build_fused_sweep, sweep_plain


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
                   fused=True, accumulate_every=1):
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
        return positions, wrap, avg

    return block


def vmc(wf, params, configs: Configs, nblocks: int = 10, nsteps_per_block: int = 10,
        tstep: float = 0.5, accumulators: Optional[dict] = None,
        generator: Optional[torch.Generator] = None, block_fn=None, verbose: bool = False,
        accumulate_every: int = 1):
    """Run VMC; returns (list of per-block dicts, final Configs): a 0-d
    average becomes a float, an array-valued one (the SR accumulator's dp,
    dpidpj, a density matrix, ...) a numpy array, as the JAX package's vmc
    returns them. The accumulators run every `accumulate_every` steps.

    Blocks are pipelined: block b's averages are fetched (one copy to the
    host of all of them, flattened and concatenated) after block b+1 has
    been queued, so the host round trip
    hides behind device work. "block time" is the host time from the
    block's start until `block_fn` returned, taken before the next block
    starts; the device may still be finishing the block's last kernels.
    """
    if generator is None:
        generator = torch.Generator(device=configs.positions.device)
        generator.manual_seed(int(time.time() * 1e6) % (2**31))
    if block_fn is None:
        block_fn = make_vmc_block(wf, accumulators, configs.geometry, tstep=tstep,
                                  nsteps=nsteps_per_block, accumulate_every=accumulate_every)
    positions = configs.positions.clone()
    wrap = configs.wrap.clone()
    block_data = []
    pending = None

    def flush(entry):
        b, avg_dev, seconds = entry
        avg = averages_to_host(avg_dev, configs.positions.dtype)
        avg["block"] = b
        avg["block time"] = seconds
        block_data.append(avg)
        if verbose:
            tot = avg.get("energytotal")
            print(f"block {b}: acc={avg['acceptance']:.3f}"
                  + (f" E={tot:.6f}" if tot is not None else ""), flush=True)

    for b in range(nblocks):
        t0 = time.perf_counter()
        positions, wrap, avg = block_fn(params, positions, wrap, generator)
        seconds = time.perf_counter() - t0
        if pending is not None:
            flush(pending)
        pending = (b, avg, seconds)
    if pending is not None:
        flush(pending)
    return block_data, Configs.create(positions, configs.geometry, wrap=wrap)

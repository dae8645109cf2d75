"""Variational Monte Carlo driver (counterpart of pyqmc_tpu/method/vmc.py).

A block is a Python loop over steps; each step is one Metropolis sweep over
all electrons (the CUDA kernel of ops/move_sweep.py on the GPU when the
wavefunction passes its gate, else the plain sweep) followed by the
accumulators. All random numbers of a block are drawn at its start from a
torch.Generator, in one batch per kind:

  gauss (nsteps, nelec, nconf, 3), scaled by sqrt(tstep);
  unif  (nsteps, nelec, nconf);
  rot   (nsteps, nelec, nconf, 3, 3), ECP quadrature rotations from normal
        quaternions.

A `streams` dict with those keys replaces the draws, so tests can feed the
port and the JAX package the same numbers. The checkpoint file and restart
of the JAX driver need h5py and are not ported yet.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from ..configs import Configs
from ..observables.ecp import rotations_from_quaternions
from ..ops.move_sweep import build_fused_sweep, sweep_plain


def draw_streams(generator, nsteps, nelec, nconf, tstep, device, dtype):
    """One block's random numbers (see the module docstring)."""
    gdev = generator.device
    gauss = torch.randn((nsteps, nelec, nconf, 3), generator=generator, device=gdev, dtype=dtype)
    unif = torch.rand((nsteps, nelec, nconf), generator=generator, device=gdev, dtype=dtype)
    quat = torch.randn((nsteps, nelec, nconf, 4), generator=generator, device=gdev, dtype=dtype)
    return {
        "gauss": (gauss * float(np.sqrt(tstep))).to(device),
        "unif": unif.to(device),
        "rot": rotations_from_quaternions(quat).to(device),
    }


def make_vmc_block(wf, accumulators, geometry, tstep=0.5, nsteps=10, drift_cutoff=1.0,
                   fused=True):
    """Returns block(params, positions, wrap, generator, streams=None)
    -> (positions, wrap, averages), averages being 0-d tensors on the
    walkers' device: "acceptance" (per electron move) and
    f"{name}{key}" for every accumulator output.

    fused=True takes the CUDA sweep kernel when the wavefunction passes its
    gate (its wrapper runs the plain sweep for CPU tensors); fused=False
    always runs the plain sweep.
    """
    accumulators = accumulators or {}
    sweep = build_fused_sweep(wf, geometry, tstep, drift_cutoff) if fused else None
    if sweep is None:
        sweep = functools.partial(sweep_plain, wf, geometry, tstep, drift_cutoff)

    def block(params, positions, wrap, generator, streams=None):
        nconf, nelec = positions.shape[:2]
        state = wf.recompute(params, positions)
        if streams is None:
            streams = draw_streams(generator, nsteps, nelec, nconf, tstep, positions.device,
                                   positions.dtype)
        records = []
        for step in range(nsteps):
            positions, wrap, state, acc = sweep(params, positions, wrap, state,
                                                streams["gauss"][step], streams["unif"][step])
            out = {"acceptance": acc / nelec}
            for name, a in accumulators.items():
                for k, v in a.avg(wf, params, state, positions, streams["rot"][step]).items():
                    out[name + k] = v
            records.append(out)
        avg = {k: torch.mean(torch.stack([r[k] for r in records])) for k in records[0]}
        return positions, wrap, avg

    return block


def vmc(wf, params, configs: Configs, nblocks: int = 10, nsteps_per_block: int = 10,
        tstep: float = 0.5, accumulators: Optional[dict] = None,
        generator: Optional[torch.Generator] = None, block_fn=None, verbose: bool = False):
    """Run VMC; returns (list of per-block dicts of floats, final Configs).

    Blocks are pipelined: block b's averages are fetched (one stacked copy
    to the host) after block b+1 has been queued, so the host round trip
    hides behind device work. "block time" is the host time from the
    block's start until `block_fn` returned, taken before the next block
    starts; the device may still be finishing the block's last kernels.
    """
    if generator is None:
        generator = torch.Generator(device=configs.positions.device)
        generator.manual_seed(int(time.time() * 1e6) % (2**31))
    if block_fn is None:
        block_fn = make_vmc_block(wf, accumulators, configs.geometry, tstep=tstep,
                                  nsteps=nsteps_per_block)
    positions = configs.positions.clone()
    wrap = configs.wrap.clone()
    block_data = []
    pending = None

    def flush(entry):
        b, avg_dev, seconds = entry
        keys = sorted(avg_dev)
        values = torch.stack([avg_dev[k] for k in keys]).cpu().tolist()
        avg = dict(zip(keys, values))
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

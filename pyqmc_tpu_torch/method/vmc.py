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


def downselects(accumulators):
    """Whether an accumulator's ECP evaluates a subset of its quadrature
    points, and so reads the u_sel stream."""
    ecps = (getattr(a, "ecp_acc", a) for a in accumulators.values())
    return any(getattr(e, "nselect", None) is not None for e in ecps)


def make_vmc_block(wf, accumulators, geometry, tstep=0.5, nsteps=10, drift_cutoff=1.0,
                   fused=True):
    """Returns block(params, positions, wrap, generator, streams=None)
    -> (positions, wrap, averages), averages being 0-d tensors on the
    walkers' device: "acceptance" (per electron move) and
    f"{name}{key}" for every accumulator output.

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

    def block(params, positions, wrap, generator, streams=None):
        with orbitals():
            return run(params, positions, wrap, generator, streams)

    def run(params, positions, wrap, generator, streams):
        nconf, nelec = positions.shape[:2]
        state = wf.recompute(params, positions)
        if streams is None:
            streams = draw_streams(generator, nsteps, nelec, nconf, tstep, positions.device,
                                   positions.dtype, downselect)
        records = []
        for step in range(nsteps):
            positions, wrap, state, acc = sweep(params, positions, wrap, state,
                                                streams["gauss"][step], streams["unif"][step])
            out = {"acceptance": acc / nelec}
            for name, a in accumulators.items():
                u_sel = streams["u_sel"][step] if "u_sel" in streams else None
                for k, v in a.avg(wf, params, state, positions, streams["rot"][step],
                                  u_sel).items():
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

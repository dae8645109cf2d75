"""Faults planted under the timed path, for the tests and `control.py`:
in `planted(name)` the program's drivers run with one fault, on the CPU
and on the card alike, and the comparison has to call the run not
correct.

- state_unchanged: every step's move sweep returns the walkers and the
  wavefunction's state it was given (its acceptance as computed).
- half_the_batch: the program's block runs on the first half of the
  walkers alone, on that half of the block's streams; the rest keep their
  positions (and weights), and the block's averages are the half's.
- half_the_mean: every walker moves, but the block's energy averages are
  means over the first half of the walkers alone.
- answer_altered: every local energy x 1.01 where it is produced.
- comb_unchanged (DMC): the comb returns the walkers and weights it was
  given.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_the_batch", "half_the_mean", "answer_altered",
          "comb_unchanged")


def _walker_half(streams, h):
    """The first h walkers of a block's streams: the walker axis is 1 in
    the streams of the block's start (names ending in 0), else 2."""
    return {k: v.narrow(1 if k.endswith("0") else 2, 0, h).contiguous()
            for k, v in streams.items()}


def _frozen(build):
    def build_frozen(*args, **kwargs):
        sweep = build(*args, **kwargs)
        if sweep is None:
            return None

        def frozen(params, positions, wrap, state, gauss, unif):
            out = sweep(params, positions, wrap, state, gauss, unif)
            return (positions, wrap, state) + tuple(out[3:])

        return frozen

    return build_frozen


def _half_vmc(make):
    def make_half(wf, accumulators, geometry, tstep=0.5, nsteps=10, *args, **kwargs):
        from pyqmc_tpu_torch.method import vmc as program

        block = make(wf, accumulators, geometry, tstep, nsteps, *args, **kwargs)
        downselect = program.downselects(accumulators)

        def half(params, positions, wrap, generator, streams=None):
            n, nelec = positions.shape[:2]
            h = n // 2
            streams = program.draw_streams(generator, nsteps, nelec, n, tstep, positions.device,
                                           positions.dtype, downselect)
            pos, wr, avg = block(params, positions[:h], wrap[:h], generator,
                                 _walker_half(streams, h))
            return torch.cat([pos, positions[h:]]), torch.cat([wr, wrap[h:]]), avg

        return half

    return make_half


def _still_comb(make):
    def make_still(*args, **kwargs):
        block, _ = make(*args, **kwargs)
        return block, lambda positions, wrap, weights, u_branch: (positions, wrap, weights)

    return make_still


def _half_dmc(make):
    def make_half(wf, energy_acc, geometry, tstep, nsteps, *args, **kwargs):
        from pyqmc_tpu_torch.method import dmc as program

        block, branch = make(wf, energy_acc, geometry, tstep, nsteps, *args, **kwargs)
        ecp = getattr(energy_acc, "ecp_acc", None)
        tmoves = kwargs.get("tmoves", True) and ecp is not None and ecp.active
        downselect = program.downselects({"energy": energy_acc})

        def half(params, positions, wrap, weights, generator, e_trial, e_est, esigma,
                 streams=None):
            n, nelec = positions.shape[:2]
            h = n // 2
            streams = program.draw_dmc_streams(generator, nsteps, nelec, n, tstep,
                                               positions.device, positions.dtype, tmoves=tmoves,
                                               downselect=downselect)
            pos, wr, w, avg = block(params, positions[:h], wrap[:h], weights[:h], generator,
                                    e_trial, e_est, esigma, _walker_half(streams, h))
            return (torch.cat([pos, positions[h:]]), torch.cat([wr, wrap[h:]]),
                    torch.cat([w, weights[h:]]), avg)

        return half, branch

    return make_half


def _half_mean(avg):
    def half_mean(self, *args, **kwargs):
        return {k: torch.mean(v[:v.shape[0] // 2], dim=0)
                for k, v in self(*args, **kwargs).items()}

    return half_mean


def _half_sum(weighted_sum):
    def half_sum(x, w):
        h = w.shape[0] // 2
        return 2.0 * weighted_sum(x[:h], w[:h])

    return half_sum


def _altered(call):
    def altered(self, *args, **kwargs):
        out = call(self, *args, **kwargs)
        out["total"] = out["total"] * 1.01
        return out

    return altered


def _patches(name):
    """[(module, attribute, wrap)] of a fault."""
    from pyqmc_tpu_torch.method import dmc, vmc
    from pyqmc_tpu_torch.observables import accumulators

    if name == "state_unchanged":
        return [(vmc, "build_fused_sweep", _frozen), (dmc, "build_fused_sweep", _frozen)]
    if name == "half_the_batch":
        return [(vmc, "make_vmc_block", _half_vmc), (dmc, "make_dmc_block", _half_dmc)]
    if name == "half_the_mean":
        return [(accumulators.EnergyAccumulator, "avg", _half_mean),
                (dmc, "_weighted_sum", _half_sum)]
    if name == "answer_altered":
        return [(accumulators.EnergyAccumulator, "__call__", _altered)]
    if name == "comb_unchanged":
        return [(dmc, "make_dmc_block", _still_comb)]
    raise KeyError(f"no fault {name!r}; the faults are {', '.join(FAULTS)}")


@contextlib.contextmanager
def planted(name):
    """The program with the fault `name` planted, restored on the way out."""
    patches = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in _patches(name)]
    for (owner, attr, original), (_, _, wrap) in zip(patches, _patches(name)):
        setattr(owner, attr, wrap(original))
    try:
        yield
    finally:
        for owner, attr, original in patches:
            setattr(owner, attr, original)

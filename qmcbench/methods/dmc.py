"""DMC traffic: the program's `rundmc` (`pyqmc_tpu_torch.method.dmc`) with
T-moves, resumed from the `checkpoint=` contents its set-up pass leaves.

Traffic keys: nconf, tstep, nsteps_per_block, branchtime, warmup_vmc_blocks
(the set-up pass's VMC warm-up), sample, trace_blocks.

`rundmc` builds its block with `make_dmc_block` and takes no block of the
caller's, so while the window runs the harness puts a recording wrapper in
that name's place (`recording`): the program's own block and comb run
inside it unchanged; it keeps, of the last block, the generator's state,
the sample's walkers and weights and the population-control scalars at its
start, the weights of every step (the ones the block's weighted sums take,
through `_weighted_sum`), and the comb's walkers, weights and u_branch on
the way in and its walkers and weights on the way out.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from .. import checks, harness
from ..reference import molecule_sj as reference
from ..reference import population


class Recorder:
    """Makes the recording wrapper of `make_dmc_block` (module docstring)."""

    def __init__(self, sample):
        self.sample = sample
        self.start = self.end = self.comb = None
        self.step_weights = []

    def wrap(self, make_dmc_block):
        def recording_make(*args, **kwargs):
            block, branch = make_dmc_block(*args, **kwargs)

            def rblock(params, positions, wrap, weights, generator, e_trial, e_est, esigma,
                       streams=None):
                s = self.sample
                self.start = {"gen_state": generator.get_state(), "R": positions[s],
                              "w": weights[s], "scalars": (e_trial, e_est, esigma)}
                self.step_weights, self.comb = [], None
                out = block(params, positions, wrap, weights, generator, e_trial, e_est, esigma,
                            streams)
                self.end = {"weights": out[2][s], "avg": out[3]}
                return out

            def rbranch(positions, wrap, weights, u_branch):
                out = branch(positions, wrap, weights, u_branch)
                self.comb = {"R": positions, "w": weights, "u": u_branch, "R_out": out[0],
                             "w_out": out[2]}
                return out

            return rblock, rbranch

        return recording_make

    def weighted_sum(self, original):
        def recording_sum(x, w):
            if not self.step_weights or self.step_weights[-1] is not w:
                self.step_weights.append(w)
            return original(x, w)

        return recording_sum


@contextlib.contextmanager
def recording(recorder):
    from pyqmc_tpu_torch.method import dmc as program_dmc

    originals = program_dmc.make_dmc_block, program_dmc._weighted_sum
    program_dmc.make_dmc_block = recorder.wrap(originals[0])
    program_dmc._weighted_sum = recorder.weighted_sum(originals[1])
    try:
        yield
    finally:
        program_dmc.make_dmc_block, program_dmc._weighted_sum = originals


def draw_streams(gen_state, device, nsteps, nelec, nconf, tstep, dtype, downselect):
    """The block's streams as the program draws them from a generator in
    `gen_state`, in its order: gauss, unif, the quaternions of erot and
    erot0, then those of tqrot, u_sel and u_acc (the T-moves'), and where
    the energy's ECP downselects its esel and esel0; each in one call at
    the whole population's shape; then the comb's u_branch."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=device, dtype=dtype)
    uniform = lambda *shape: torch.rand(shape, generator=gen, device=device, dtype=dtype)
    out = {"gauss": normal(nsteps, nelec, nconf, 3) * float(np.sqrt(tstep)),
           "unif": uniform(nsteps, nelec, nconf),
           "erot": normal(nsteps, nelec, nconf, 4), "erot0": normal(nelec, nconf, 4),
           "tqrot": normal(nsteps, nelec, nconf, 4)}
    out["u_sel"] = uniform(nsteps, nelec, nconf)
    out["u_acc"] = uniform(nsteps, nelec, nconf)
    if downselect:
        out["esel"] = uniform(nsteps, nelec, nconf)
        out["esel0"] = uniform(nelec, nconf)
    out["u_branch"] = uniform()
    return out


class Run:
    def __init__(self, system, traffic, seed):
        self.system, self.traffic = system, traffic
        self.nconf = traffic["nconf"]
        self.nsteps = traffic["nsteps_per_block"]
        self.tstep = traffic["tstep"]
        dev = system.device
        self.gen = harness.generator(seed, harness.STREAM_RUN, dev)
        self.sample = harness.sample_walkers(self.nconf, traffic["sample"], seed, dev)
        self.log = harness.EnergyLog(self.sample, self.nsteps + 1)
        system.energy.log = self.log
        self.recorder = Recorder(self.sample)
        self.checkpoint = {}

    def blocks(self, nblocks, warmup=0):
        from pyqmc_tpu_torch.method.dmc import rundmc

        return rundmc(self.system.wf, self.system.params, self.system.configs, nblocks=nblocks,
                      nsteps_per_block=self.nsteps, tstep=self.tstep,
                      energy_acc=self.system.energy, generator=self.gen,
                      warmup_vmc_blocks=warmup, branchtime=self.traffic["branchtime"],
                      checkpoint=self.checkpoint)[0]

    def setup(self, timed=True):
        """The VMC warm-up and one DMC block; returns the seconds of one
        warm resumed block (none where not `timed`)."""
        self.blocks(1, warmup=self.traffic["warmup_vmc_blocks"])
        if not timed:
            return None
        checks.sync(self.system.device)
        t0 = time.perf_counter()
        self.blocks(1)
        checks.sync(self.system.device)
        return time.perf_counter() - t0

    def window(self, nblocks):
        self.log.on = True
        with recording(self.recorder):
            data = self.blocks(nblocks)
        self.log.on = False
        return data

    def walker_steps(self, nblocks):
        return self.nconf * self.nsteps * nblocks

    def release(self):
        self.checkpoint = None
        self.system.release()

    def streams(self, dtype):
        st = draw_streams(self.recorder.start["gen_state"], self.system.device, self.nsteps,
                          self.system.nelec, self.nconf, self.tstep, self.system.dtype,
                          self.system.config["ecp"]["downselect"])
        s = self.sample
        self.u_branch = float(st.pop("u_branch"))
        out = {k: v[..., s, :] if k in ("gauss", "erot", "erot0", "tqrot") else v[..., s]
               for k, v in st.items()}
        out = {k: v.to(dtype) for k, v in out.items()}
        for k in ("erot", "erot0", "tqrot"):
            out[k] = reference.rotations(out[k])
        return out

    def follow(self, dtype=torch.float64, tf32=False):
        """The reference's (positions, energies, weights) of the sample
        through the last block from its start, on the program's
        population-control scalars."""
        start = self.recorder.start
        e_trial, e_est, esigma = (float(v) for v in start["scalars"])
        wf = self.system.reference_wf(self.system.device, dtype)
        if dtype == torch.float64:
            self.disp = wf.displacement
        with checks.precision(tf32):
            return reference.dmc_block(wf, start["R"].to(dtype), start["w"].to(dtype),
                                       self.streams(dtype), self.tstep, e_trial, e_est, esigma)

    def population_numbers(self, control=False):
        """The comb and the block's averages over the whole population: the
        program's against float64 reductions of the program's own inputs to
        them (the comb's weights before it and u_branch redrawn from the
        block's generator state; every step's energies and weights); with
        `control` float32 reductions in the program's place."""
        comb, rec = self.recorder.comb, self.recorder
        if comb is None:
            return {"comb_apart": np.inf, "comb_weight_gap": np.inf, "average_gap": np.inf}
        keep, mean = population.comb(comb["w"], self.u_branch)
        whole = list(self.log.whole)[1:]
        full = self.log.covers(self.nconf) and all(w.shape[0] == self.nconf
                                                   for w in rec.step_weights)
        ref_avg = population.dmc_averages(whole, rec.step_weights) if full else None
        if control:
            keep32, mean32 = population.comb(comb["w"], self.u_branch, torch.float32)
            R_out, w_out = comb["R"][keep32], torch.full_like(comb["w"], float(mean32))
            avg = population.dmc_averages(whole, rec.step_weights, torch.float32) if full else {}
        else:
            R_out, w_out = comb["R_out"], comb["w_out"]
            avg = {k: float(v) for k, v in rec.end["avg"].items()}
        if abs(float(comb["u"]) - self.u_branch) > 0:
            print(f"qmcbench: the comb took u_branch {float(comb['u'])!r}, the block's generator "
                  f"gives {self.u_branch!r}", file=sys.stderr)
        return {"comb_apart": checks.comb_apart(comb["R"], R_out, keep, self.disp),
                "comb_weight_gap": checks.comb_weight_gap(w_out, mean),
                "average_gap": checks.average_gap(avg, ref_avg)}

    def check(self, control=False):
        """{number: value} of the last block against the float64 reference;
        with `control` the reference in float32 with TF32 matmuls stands in
        the program's place over the sample."""
        ref_pos, ref_e, ref_w = self.follow()
        if control:
            pos, energies, w = self.follow(torch.float32, tf32=True)
            start_pos = [self.recorder.start["R"]]
        else:
            calls = list(self.log.calls)
            start_pos = [calls[0][0]]
            pos = [c[0] for c in calls[1:]]
            energies = [c[1] for c in calls]
            w = self.recorder.end["weights"]
        disp = self.disp
        agree = ~torch.stack([checks.apart(a, b, disp) for a, b in zip(pos, ref_pos)]).any(dim=0)
        gap_args = (start_pos + pos, energies, [self.recorder.start["R"]] + ref_pos, ref_e)
        print(f"qmcbench: {checks.worst_walker(*gap_args, disp)}", file=sys.stderr)
        return {"walkers_apart": checks.walkers_apart(pos[-1], ref_pos[-1], disp),
                "energy_gap": checks.energy_gap(*gap_args, disp),
                "energy_gap_p99": checks.energy_gap_p99(*gap_args, disp),
                "weight_gap": checks.weight_gap(w, ref_w, agree),
                **self.population_numbers(control)}

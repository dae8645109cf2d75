"""VMC traffic: equilibrate, then time whole blocks of the program's `vmc`
(`pyqmc_tpu_torch.method.vmc`) with a block from its `make_vmc_block`.

Traffic keys: nconf, tstep, nsteps_per_block, equilibration_blocks, sample
(walkers the reference follows), trace_blocks (blocks of a traced window).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import checks, harness
from ..reference import molecule_sj as reference
from ..reference import population


class Recorder:
    """block_fn of `vmc`: runs the program's block and keeps, of the last
    one, the generator's state and the sample's walkers at its start, and
    the sample's walkers and the averages at its end."""

    def __init__(self, block, sample):
        self.block, self.sample = block, sample
        self.start = self.end = None

    def __call__(self, params, positions, wrap, generator, streams=None):
        self.start = {"gen_state": generator.get_state(), "R": positions[self.sample]}
        out = self.block(params, positions, wrap, generator, streams)
        self.end = {"R": out[0][self.sample], "avg": out[2]}
        return out


def draw_streams(gen_state, device, nsteps, nelec, nconf, tstep, dtype, downselect):
    """The block's streams as the program draws them from a generator in
    `gen_state`: gauss, unif, the quaternions of the ECP rotations and,
    where the ECP downselects, its selection uniforms u_sel; each in one
    call at the whole population's shape (quaternions, not rotations: the
    reference forms its own)."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    gauss = torch.randn((nsteps, nelec, nconf, 3), generator=gen, device=device, dtype=dtype)
    unif = torch.rand((nsteps, nelec, nconf), generator=gen, device=device, dtype=dtype)
    quat = torch.randn((nsteps, nelec, nconf, 4), generator=gen, device=device, dtype=dtype)
    out = {"gauss": gauss * float(np.sqrt(tstep)), "unif": unif, "quat": quat}
    if downselect:
        out["u_sel"] = torch.rand((nsteps, nelec, nconf), generator=gen, device=device, dtype=dtype)
    return out


class Run:
    """One cell's program state from set-up to the check."""

    def __init__(self, system, traffic, seed):
        from pyqmc_tpu_torch.method.vmc import make_vmc_block

        self.system, self.traffic = system, traffic
        self.nconf = traffic["nconf"]
        self.nsteps = traffic["nsteps_per_block"]
        self.tstep = traffic["tstep"]
        dev = system.device
        self.gen = harness.generator(seed, harness.STREAM_RUN, dev)
        self.sample = harness.sample_walkers(self.nconf, traffic["sample"], seed, dev)
        self.log = harness.EnergyLog(self.sample, self.nsteps)
        system.energy.log = self.log
        block = make_vmc_block(system.wf, {"energy": system.energy}, system.configs.geometry,
                               tstep=self.tstep, nsteps=self.nsteps)
        self.recorder = Recorder(block, self.sample)
        self.configs = system.configs

    def blocks(self, nblocks):
        from pyqmc_tpu_torch.method.vmc import vmc

        data, self.configs = vmc(self.system.wf, self.system.params, self.configs,
                                 nblocks=nblocks, nsteps_per_block=self.nsteps, tstep=self.tstep,
                                 generator=self.gen, block_fn=self.recorder)
        return data

    def setup(self, timed=True):
        """Equilibrate; returns the seconds of one warm block (none where
        not `timed`)."""
        self.blocks(self.traffic["equilibration_blocks"])
        if not timed:
            return None
        checks.sync(self.system.device)
        t0 = time.perf_counter()
        self.blocks(1)
        checks.sync(self.system.device)
        return time.perf_counter() - t0

    def window(self, nblocks):
        self.log.on = True
        data = self.blocks(nblocks)
        self.log.on = False
        return data

    def walker_steps(self, nblocks):
        return self.nconf * self.nsteps * nblocks

    def release(self):
        """Drop the program's walkers and caches; keep the records."""
        self.configs = None
        self.system.release()

    def streams(self, dtype):
        """The last block's streams for the sample, in `dtype`."""
        st = draw_streams(self.recorder.start["gen_state"], self.system.device, self.nsteps,
                          self.system.nelec, self.nconf, self.tstep, self.system.dtype,
                          self.system.config["ecp"]["downselect"])
        s = self.sample
        out = {k: (v[:, :, s] if v.dim() == 3 else v[:, :, s, :]).to(dtype) for k, v in st.items()}
        out["rot"] = reference.rotations(out.pop("quat"))
        return out

    def follow(self, dtype=torch.float64, tf32=False):
        """The reference's positions of the sample through the last block,
        in `dtype`, with TF32 matmuls where `tf32`."""
        wf = self.system.reference_wf(self.system.device, dtype)
        if dtype == torch.float64:
            self.disp = wf.displacement
        with checks.precision(tf32):
            return reference.vmc_block(wf, self.recorder.start["R"].to(dtype), self.streams(dtype),
                                       self.tstep)

    def energies(self, positions, dtype=torch.float64, tf32=False):
        """The reference's local energies at `positions` (per step) at the
        last `energy_steps` steps of the block (all where not given)."""
        wf = self.system.reference_wf(self.system.device, dtype)
        first = self.nsteps - self.traffic.get("energy_steps", self.nsteps)
        with checks.precision(tf32):
            return reference.energies_at(wf, [R.to(dtype) for R in positions],
                                         self.streams(dtype), range(first, self.nsteps))

    def check(self, control=False):
        """{number: value} of the last block against the float64 reference:
        the chains' ends, the local energies at the program's own positions,
        and the block's averages against a float64 reduction of the
        program's per-walker energies. With `control` the reference in
        float32 with TF32 matmuls stands in the program's place over the
        sample, and a float32 reduction in the program's averages' place."""
        ref_pos = self.follow()
        whole, covered = list(self.log.whole), self.log.covers(self.nconf)
        if control:
            pos = self.follow(torch.float32, tf32=True)
            energies = self.energies(pos, torch.float32, tf32=True)
            avg = population.vmc_averages(whole, torch.float32) if covered else {}
        else:
            calls = list(self.log.calls)
            pos, energies = [c[0] for c in calls], [c[1] for c in calls]
            avg = {k: float(v) for k, v in self.recorder.end["avg"].items()}
        ref_e = self.energies(pos)
        print(f"qmcbench: {checks.worst_walker(pos, energies, pos, ref_e)}", file=sys.stderr)
        return {"walkers_apart": checks.walkers_apart(pos[-1], ref_pos[-1], self.disp),
                "energy_gap": checks.energy_gap(pos, energies, pos, ref_e),
                "energy_gap_p99": checks.energy_gap_p99(pos, energies, pos, ref_e),
                "average_gap": checks.average_gap(
                    avg, population.vmc_averages(whole) if covered else None)}

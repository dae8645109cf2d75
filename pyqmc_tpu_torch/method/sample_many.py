"""Sampling the mixture rho = sum_i |psi_i|^2 of several wavefunctions
(counterpart of pyqmc_tpu/method/sample_many.py).

One block advances every wavefunction's state through one Metropolis chain
on rho and accumulates the normalized overlap matrix N_ij = < conj(a_i) a_j
/ rho > and each state's weighted energy; the amplitudes a_i = phase_i
e^{log|psi_i| - m} are shifted by the walker's largest log|psi_i|. Each
further accumulator is evaluated for every state with the importance
weights w_i = |a_i|^2 / rho (the reference's AdaptSingleAccumulator):
"{name}{i}_{key}_num" and "state{i}_den" give <O>_i = num / den.

The sweep has no kernel in the JAX package and is plain here too; on the
GPU its float32 orbital values run on K3 (models/orbitals.py). All random
numbers of a block are drawn at its start from a torch.Generator:

  gauss (nsteps, nelec, nconf, 3), scaled by sqrt(tstep), and unif (nsteps,
        nelec, nconf), as method/vmc.py draws them;
  rot   (nsteps, nwf, nelec, nconf, 3, 3), each state's energy's ECP
        rotations, where the energy has an ECP, and u_sel (nsteps, nwf,
        nelec, nconf) where that ECP downselects;
  arot, asel: the same for the further accumulators where one has an ECP
        (one set per state, shared by the accumulators, as the JAX block
        gives every accumulator of a state one key);
  draws {name: [per state {key: (nsteps, ...)}]}, the numbers of the
        accumulators that draw their own (observables/accumulators.py).

A `streams` dict with those keys replaces the draws, so tests can feed the
port and the JAX package the same numbers.

With a walker mesh (parallel/mesh.py) each rank runs the chain of its
slice of the walkers on its own generator (vmc.shard_generators) and the
block averages are means over the mesh, as in method/vmc.py.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..configs import Configs
from ..models.multiply import default_move_begin, default_move_finish
from ..observables.ecp import rotations_from_quaternions
from ..ops.move_sweep import limdrift
from ..parallel.mesh import check_divides, gather_walkers, mean_over, shard_walkers
from .vmc import accumulator_draws, averages_to_host, downselects, shard_generators, step_draws


def amplitudes(wfs, params_list, states):
    """(a (nwf, nconf), rho (nconf,)): a_i = phase_i e^{log|psi_i| - m},
    m the walker's largest log|psi_i|, and rho = sum_i |a_i|^2."""
    values = [wf.value(p, s) for wf, p, s in zip(wfs, params_list, states)]
    las = torch.stack([la for _, la in values])
    phases = torch.stack([ph for ph, _ in values])
    a = phases * torch.exp(las - torch.amax(las, dim=0, keepdim=True))
    return a, torch.sum(torch.abs(a) ** 2, dim=0)


def draw_overlap_streams(generator, nsteps, nwf, nelec, nconf, tstep, device, dtype,
                         energy_acc=None, accumulators=None):
    """One overlap block's random numbers (see the module docstring)."""
    gdev = generator.device
    accumulators = accumulators or {}

    def rotations(*shape):
        quat = torch.randn(shape + (4,), generator=generator, device=gdev, dtype=dtype)
        return rotations_from_quaternions(quat).to(device)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=gdev, dtype=dtype).to(device)

    gauss = torch.randn((nsteps, nelec, nconf, 3), generator=generator, device=gdev, dtype=dtype)
    streams = {"gauss": (gauss * float(np.sqrt(tstep))).to(device),
               "unif": uniform(nsteps, nelec, nconf)}
    energy = {"energy": energy_acc} if energy_acc is not None else {}
    for rot, sel, accs in (("rot", "u_sel", energy), ("arot", "asel", accumulators)):
        if any(getattr(a, "ecp_acc", None) is not None for a in accs.values()):
            streams[rot] = rotations(nsteps, nwf, nelec, nconf)
            if downselects(accs):
                streams[sel] = uniform(nsteps, nwf, nelec, nconf)
    draws = {}
    for name in accumulators:
        per_state = [accumulator_draws({name: accumulators[name]}, generator, nsteps, nconf,
                                       device, dtype) for _ in range(nwf)]
        if per_state[0]:
            draws[name] = [d[name] for d in per_state]
    if draws:
        streams["draws"] = draws
    return streams


def make_overlap_block(wfs, geometry, tstep=0.5, nsteps=10, energy_acc=None, accumulators=None,
                       mesh=None):
    """Returns block(params_list, positions, wrap, generator, streams=None) ->
    (positions, wrap, averages): tensors on the walkers' device, the means
    over the block's steps of "acceptance", "overlap" (nwf, nwf), with
    energy_acc "energy{i}_num" and "energy{i}_den", and for every further
    accumulator "{name}{i}_{key}_num" and "state{i}_den" (the module
    docstring). mesh: each rank passes its walkers and the caller's
    generator; the block draws from the rank's generator and its averages
    are the means over the mesh."""
    accumulators = accumulators or {}
    nwf = len(wfs)
    nelec = wfs[0].nelec

    def sweep(params_list, positions, wrap, states, gauss_step, unif_step):
        positions, wrap = positions.clone(), wrap.clone()
        acc = torch.zeros((), dtype=positions.dtype, device=positions.device)
        for e in range(nelec):
            epos = positions[:, e, :]
            a, rho = amplitudes(wfs, params_list, states)
            wnorm = torch.abs(a) ** 2 / rho
            begins = [default_move_begin(wf, p, s, e, epos)
                      for wf, p, s in zip(wfs, params_list, states)]
            drift = limdrift(sum(wnorm[i][:, None] * begins[i][0].real for i in range(nwf)))
            gauss = gauss_step[e]
            newpos, wrapdelta = geometry.enforce(epos + gauss + tstep * drift)
            finishes = [default_move_finish(wf, p, s, e, newpos, aux)
                        for wf, p, s, (_, aux) in zip(wfs, params_list, states, begins)]
            r2 = [torch.abs(r) ** 2 for _, r, _ in finishes]
            rho_ratio = sum(wnorm[i] * r2[i] for i in range(nwf))
            drift_new = limdrift(sum((wnorm[i] * r2[i] / rho_ratio)[:, None] * finishes[i][0].real
                                     for i in range(nwf)))
            forward = torch.sum(gauss * gauss, dim=-1)
            backward = torch.sum((gauss + tstep * (drift + drift_new)) ** 2, dim=-1)
            t_prob = torch.exp((forward - backward) / (2.0 * tstep))
            accept = rho_ratio * t_prob > unif_step[e]
            states = tuple(wf.updateinternals(p, s, e, newpos, accept, sv)
                           for wf, p, s, (_, _, sv) in zip(wfs, params_list, states, finishes))
            positions[:, e, :] = torch.where(accept[:, None], newpos, epos)
            wrap[:, e, :] = torch.where(accept[:, None], wrap[:, e, :] + wrapdelta, wrap[:, e, :])
            acc = acc + torch.mean(accept.to(positions.dtype))
        return positions, wrap, states, acc

    def block(params_list, positions, wrap, generator, streams=None):
        nconf = positions.shape[0]
        states = tuple(wf.recompute(p, positions) for wf, p in zip(wfs, params_list))
        if streams is None:
            if mesh is not None:
                generator = shard_generators(generator, mesh.size)[mesh.rank]
            streams = draw_overlap_streams(generator, nsteps, nwf, nelec, nconf, tstep,
                                           positions.device, positions.dtype, energy_acc,
                                           accumulators)
        draws = streams.get("draws", {})
        records = []
        for step in range(nsteps):
            positions, wrap, states, acc = sweep(params_list, positions, wrap, states,
                                                 streams["gauss"][step], streams["unif"][step])
            a, rho = amplitudes(wfs, params_list, states)
            w = torch.abs(a) ** 2 / rho
            out = {"acceptance": acc / nelec,
                   "overlap": torch.mean(a.conj()[:, None, :] * a[None, :, :] / rho, dim=-1)}
            for i, (wf, p, s) in enumerate(zip(wfs, params_list, states)):
                if energy_acc is not None:
                    rot = streams["rot"][step, i] if "rot" in streams else None
                    u_sel = streams["u_sel"][step, i] if "u_sel" in streams else None
                    el = energy_acc(wf, p, s, positions, rot, u_sel)["total"]
                    out[f"energy{i}_num"] = torch.mean(w[i] * el)
                    out[f"energy{i}_den"] = torch.mean(w[i])
                for name, acc_fn in accumulators.items():
                    rot = streams["arot"][step, i] if "arot" in streams else None
                    u_sel = streams["asel"][step, i] if "asel" in streams else None
                    kw = step_draws({name: draws[name][i]} if name in draws else {}, name, step)
                    for k, v in acc_fn(wf, p, s, positions, rot, u_sel, **kw).items():
                        wb = w[i].reshape(w[i].shape + (1,) * (v.ndim - 1))
                        out[f"{name}{i}_{k}_num"] = torch.mean(wb * v, dim=0)
                    out[f"state{i}_den"] = torch.mean(w[i])
            records.append(out)
        avg = {k: torch.mean(torch.stack([r[k] for r in records]), dim=0) for k in records[0]}
        if mesh is not None:
            avg = mean_over(mesh, avg)
        return positions, wrap, avg

    return block


def sample_overlap(wfs, params_list, configs: Configs, generator=None, nblocks=10, nsteps=10,
                   tstep=0.5, energy_acc=None, accumulators=None, mesh=None, block_fn=None):
    """Returns (list of per-block dicts, final Configs): each block's
    averages on the host (floats, numpy arrays for the overlap matrix and
    array-valued accumulator outputs), plus "block" and "block time" (the
    host time of the block's call). A prebuilt `block_fn`
    (make_overlap_block) is reused across calls, as optimize_ensemble
    does. mesh: every rank passes the whole population and a generator in
    the same state, each runs its slice (ValueError where the walkers do
    not divide evenly), and the returned Configs hold the whole
    population."""
    if generator is None:
        generator = torch.Generator(device=configs.positions.device)
        generator.manual_seed(int(time.time() * 1e6) % (2**31))
    if block_fn is None:
        block_fn = make_overlap_block(wfs, configs.geometry, tstep=tstep, nsteps=nsteps,
                                      energy_acc=energy_acc, accumulators=accumulators, mesh=mesh)
    if mesh is None:
        positions, wrap = configs.positions.clone(), configs.wrap.clone()
    else:
        check_divides(configs.positions.shape[0], mesh, "nconf")
        positions, wrap = shard_walkers(mesh, configs.positions, configs.wrap)
    data = []
    for b in range(nblocks):
        t0 = time.perf_counter()
        positions, wrap, avg = block_fn(tuple(params_list), positions, wrap, generator)
        out = averages_to_host(avg, positions.dtype)
        out["block"], out["block time"] = b, time.perf_counter() - t0
        data.append(out)
    if mesh is not None:
        positions, wrap = gather_walkers(mesh, positions, wrap)
    return data, Configs.create(positions, configs.geometry, wrap=wrap)

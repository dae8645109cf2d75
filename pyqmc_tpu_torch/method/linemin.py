"""Wavefunction optimization: the stochastic-reconfiguration direction and a
correlated-sampling line search along it (counterpart of
pyqmc_tpu/method/linemin.py).

Each iteration runs VMC with the SR accumulator (`vmc_blocks` blocks of
`vmc_steps_per_block` steps; on the GPU the sweep is K1 and the energy's
nonlocal ECP K2 where the wavefunction passes their gates), solves for the
SR step on the host in float64, and evaluates the energy of every step
length in `taus` on the walkers by correlated sampling: one rotation draw
(and, for a downselecting ECP, one selection draw) per iteration serves the
reference parameters and every candidate, so the estimates share their
noise and their differences are those of the parameters. The candidate of
lowest energy whose effective sample size passes the guard is taken.

Random numbers come from a torch.Generator where the JAX package takes a
key: iteration `it` draws from a generator folded from the caller's seed
and `it` (vmc.fold_generator, the JAX package's fold_in(key, it)), so a
run resumed at an iteration draws what the uninterrupted run drew there.
The iteration records carry the JAX package's keys. Complex parameters
(complex orbital coefficients) take SR's complex channel and the
LinearTransform's real and imaginary directions, and stay complex.

`hdf_file` appends each iteration's energy, energy_err, gnorm, tau and
parameter vector x to an HDF5 file and keeps the walkers there; a run on a
file that holds iterations resumes after the last of them (its x and
walkers). `checkpoint=` carries the same restart contents in a dict, for a
machine without h5py.

With a walker mesh (parallel/mesh.py) the SR VMC runs under it (its
averages, dp, dpH and dpidpj among them, are means over the mesh before
the solve), each rank evaluates the correlated energies of its slice of
the first `correlated_nconf` walkers on its slice of one rotation draw
made for all of them alike on every rank, and the log-amplitudes and
energies are gathered before the host forms the estimates. Rank 0 solves
the SR system and broadcasts the steps, so every rank takes the same
parameters, bit for bit.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..observables.ecp import rotations_from_quaternions
from ..observables.sr import StochasticReconfiguration
from ..configs import Configs
from ..parallel.mesh import gather_walkers, replicate, shard_walkers
from .hdftools import append_hdf, open_hdf
from .vmc import checkpoint_configs, downselects, fold_generator, make_vmc_block, vmc

SR_KEYS = ("total", "dp", "dpH", "dpidpj")
SR_KEYS_IMAG = ("total_im", "dpI", "dpHI", "dpidpjI")


def make_correlated_sampler(wf, energy_acc):
    """f(params, positions, rot, u_sel=None) -> (log|psi| (nconf,), local
    energy (nconf,)), both recomputed from scratch under `params`."""

    def f(params, positions, rot, u_sel=None):
        state = wf.recompute(params, positions)
        _, logabs = wf.value(params, state)
        return logabs, energy_acc(wf, params, state, positions, rot, u_sel)["total"]

    return f


def draw_ecp_streams(generator, nelec, nconf, device, dtype, downselect=False):
    """One set of ECP quadrature rotations (nelec, nconf, 3, 3) and, with
    `downselect`, selection uniforms (nelec, nconf) (else None)."""
    gdev = generator.device
    quat = torch.randn((nelec, nconf, 4), generator=generator, device=gdev, dtype=dtype)
    u_sel = None
    if downselect:
        u_sel = torch.rand((nelec, nconf), generator=generator, device=gdev,
                           dtype=dtype).to(device)
    return rotations_from_quaternions(quat).to(device), u_sel


def correlated_energies(sampler, params0, candidates, positions, rot, u_sel=None, mesh=None):
    """Correlated-sampling energies of candidate parameter sets on walkers
    drawn from |psi(params0)|^2, all evaluated with the same rotations
    (and selection uniforms). Returns (energies, ess) as float64 numpy:
    candidates whose weights have a low effective sample size give
    unreliable estimates, and the caller filters on ess.

    The log-amplitudes and energies reach the host in one copy; the
    weights exp(2 (la - la0)) are formed there in float64, after
    subtracting their maximum (which cancels in both the energy and the
    ess), so a far candidate cannot overflow them. With a mesh, each rank
    passes its walkers and draws, and the rows are gathered in rank order
    first, so every rank forms the same estimates from the same numbers."""
    la0, _ = sampler(params0, positions, rot, u_sel)
    rows = [la0]
    for cand in candidates:
        rows.extend(sampler(cand, positions, rot, u_sel))
    rows = torch.stack(rows)
    if mesh is not None:
        rows = gather_walkers(mesh, rows.T.contiguous()).T
    host = rows.to(torch.float64).cpu().numpy()
    la0, la, eloc = host[0], host[1::2], host[2::2]
    n = host.shape[1]
    d = 2.0 * (la - la0[None, :])
    w = np.exp(d - np.max(d, axis=1, keepdims=True))
    w = w / np.mean(w, axis=1, keepdims=True)
    energies = np.mean(w * eloc, axis=1) / np.mean(w, axis=1)
    ess = np.sum(w, axis=1) ** 2 / (np.sum(w * w, axis=1) * n)
    return energies, ess


def select_candidate(energies, ess, taus, ess_threshold=0.3, iteration=None):
    """The lowest-energy candidate whose effective sample size is above
    `ess_threshold`: (best index, taus). When every candidate fails the
    guard the line search has stalled: returns (None, the tau grid halved)
    and warns, so the next iteration proposes shorter steps."""
    masked = np.where(np.asarray(ess) > ess_threshold, energies, np.inf)
    if np.any(np.isfinite(masked)):
        return int(np.argmin(masked)), taus
    halved = [t / 2.0 for t in taus]
    logging.warning(
        "linemin%s: all %d correlated-sampling candidates rejected (ESS <= %.2f, max ESS "
        "%.3f); keeping parameters and halving the tau grid to %s",
        f" iteration {iteration}" if iteration is not None else "", len(energies),
        ess_threshold, float(np.max(ess)), halved)
    return None, halved


def update_tau_grid(taus, taus0, ok_streak, stalled, tau_recover=2):
    """After `tau_recover` iterations in a row without a stall, double a
    stall-halved grid back toward the original taus0 (element-wise
    capped). Returns (taus, ok_streak)."""
    if stalled:
        return taus, 0
    ok_streak += 1
    if ok_streak >= tau_recover and list(taus) != list(taus0):
        return [min(2.0 * t, t0) for t, t0 in zip(taus, taus0)], 0
    return taus, ok_streak


def read_checkpoint(hdf_file):
    """The restart contents of a line minimization's file (of either
    package): {"iterations": the iterations it holds, "x": the last
    parameter vector, "configs": its walkers as numpy arrays or None}; None
    where the file does not exist or holds no iteration."""
    if not os.path.exists(hdf_file):
        return None
    with open_hdf(hdf_file, "r") as f:
        if "x" not in f or len(f["x"]) == 0:
            return None
        cfg = None
        if "configs" in f:
            cfg = {k: np.asarray(f["configs"][k]) for k in ("positions", "wrap", "lattice")
                   if k in f["configs"]}
        return {"iterations": len(f["x"]), "x": np.asarray(f["x"])[-1], "configs": cfg}


def line_minimization(
    wf,
    params,
    configs,
    transform,
    energy_acc,
    generator: Optional[torch.Generator] = None,
    max_iterations: int = 20,
    taus: Sequence[float] = (0.0, 0.02, 0.05, 0.1, 0.2, 0.4),
    vmc_blocks: int = 10,
    vmc_steps_per_block: int = 10,
    vmc_tstep: float = 0.5,
    correlated_nconf: Optional[int] = None,
    tau_recover: int = 2,
    sr_eps: float = 1e-3,
    hdf_file: Optional[str] = None,
    verbose: bool = False,
    callback=None,
    checkpoint: Optional[dict] = None,
    mesh=None,
):
    """Optimize params; returns (params, configs, iteration records).

    Each record holds "iteration", "energy" and "energy_err" (the SR VMC's
    block mean and its standard error), "gnorm" (|g|), "tau" (the step
    taken; 0 on a stall), "stalled" and "line_energies" (the candidates'
    correlated energies). A stall halves the tau grid; after `tau_recover`
    iterations without one it is doubled back toward the original grid.
    `callback(record, info)`, where given, is called after each iteration
    with what the iteration saw: info holds "block_avg" (the SR averages,
    stacked over blocks), "steps", "params0" and "candidates" (the
    parameter sets of the line search), "positions", "rot" and "u_sel"
    (the correlated sampling's walkers and draws), "ess", and "seconds",
    the wall time of its parts: "vmc" (the SR VMC blocks, their averages
    on the host), "solve" (the SR solve and the candidates' parameters)
    and "correlated" (the correlated sampling, its energies on the
    host).

    hdf_file: append each iteration's row (energy, energy_err, gnorm, tau,
    x) and keep the walkers there; where the file holds iterations, resume
    at iteration len(x) from its last x (ValueError where its length is
    not the transform's parameter count) and its walkers (ValueError where
    their shape is not that of `configs`). checkpoint: a dict standing for
    the file's restart contents: empty, the run starts at iteration 0;
    holding contents (as line_minimization leaves them, or
    read_checkpoint's), it resumes from them. line_minimization leaves the
    contents after its last iteration in it.

    mesh: a walker mesh (parallel/mesh.py; the module docstring). Every rank
    passes the whole population, the same parameters and a generator in
    the same state; `correlated_nconf` must divide evenly over the ranks.
    The returned configs hold the whole population; the callback's
    positions and draws are the rank's; rank 0 alone writes `hdf_file`."""
    if generator is None:
        generator = torch.Generator(device=configs.positions.device)
        generator.manual_seed(int(time.time() * 1e6) % (2**31))
    nconf, nelec = configs.positions.shape[:2]
    if correlated_nconf is not None and not (0 < correlated_nconf <= nconf):
        raise ValueError(f"correlated_nconf={correlated_nconf} must be in [1, nconf={nconf}]")
    if mesh is not None and correlated_nconf is not None and correlated_nconf % mesh.size:
        raise ValueError(f"correlated_nconf={correlated_nconf} does not divide over the "
                         f"{mesh.size}-device mesh; pick a multiple of {mesh.size}")
    ncorr = nconf if correlated_nconf is None else correlated_nconf
    sr = StochasticReconfiguration(energy_acc, transform, eps=sr_eps)
    sampler = make_correlated_sampler(wf, energy_acc)
    block_fn = make_vmc_block(wf, {"pgrad": sr}, configs.geometry, tstep=vmc_tstep,
                              nsteps=vmc_steps_per_block, mesh=mesh)
    downselect = downselects({"energy": energy_acc})

    start_it = 0
    contents = read_checkpoint(hdf_file) if hdf_file is not None else checkpoint or None
    if contents is not None:
        where = f"linemin restart from {hdf_file}" if hdf_file is not None else "linemin restart"
        start_it = int(contents["iterations"])
        x = np.asarray(contents["x"])
        if x.shape[0] != transform.nparams:
            raise ValueError(f"{where}: checkpoint holds {x.shape[0]} parameters but the "
                             f"wavefunction/transform expects {transform.nparams}; the file "
                             "belongs to a different wavefunction")
        params = transform.deserialize(params, torch.as_tensor(x))
        if contents.get("configs") is not None:
            configs = checkpoint_configs(contents["configs"], configs, where)
        if verbose:
            print(f"linemin: resuming at iteration {start_it}", flush=True)

    talks = mesh is None or mesh.rank == 0

    def solve(taus, block_avg):
        """sr.delta_p; under a mesh rank 0 solves and broadcasts."""
        if mesh is None:
            return sr.delta_p(taus, block_avg)
        out = np.zeros((len(taus), transform.nparams + 1))
        if mesh.rank == 0:
            steps, gnorm = sr.delta_p(taus, block_avg)
            out[:, :-1], out[:, -1] = np.stack(steps), gnorm
        out = replicate(mesh, torch.as_tensor(out)).cpu().numpy()
        return list(out[:, :-1]), float(out[0, -1])

    taus = list(taus)
    taus0 = list(taus)
    ok_streak = 0
    records = []
    for it in range(start_it, max_iterations):
        gen_it = fold_generator(generator, it)
        t0 = time.perf_counter()
        data, configs = vmc(wf, params, configs, nblocks=vmc_blocks,
                            nsteps_per_block=vmc_steps_per_block, tstep=vmc_tstep,
                            accumulators={"pgrad": sr}, generator=gen_it, block_fn=block_fn,
                            mesh=mesh)
        t1 = time.perf_counter()
        keys = SR_KEYS + (SR_KEYS_IMAG if "pgraddpI" in data[0] else ())
        block_avg = {k: np.stack([d[f"pgrad{k}"] for d in data]) for k in keys}
        if not np.all(np.isfinite(block_avg["total"])):
            raise ValueError("NaN/inf energy during optimization; the wavefunction may have "
                             "collapsed")
        steps, gnorm = solve(taus, block_avg)
        p0 = transform.serialize(params).to(torch.float64).cpu().numpy()
        candidates = [transform.deserialize(params, p0 + s) for s in steps]
        t2 = time.perf_counter()
        rot, u_sel = draw_ecp_streams(gen_it, nelec, ncorr, configs.positions.device,
                                      configs.positions.dtype, downselect)
        positions = configs.positions[:ncorr]
        if mesh is not None:  # this rank's walkers and draws
            positions = shard_walkers(mesh, positions)
            rot = shard_walkers(mesh, rot.transpose(0, 1)).transpose(0, 1)
            u_sel = None if u_sel is None else shard_walkers(mesh, u_sel.T).T
        energies, ess = correlated_energies(sampler, params, candidates, positions, rot, u_sel,
                                            mesh=mesh)
        t3 = time.perf_counter()
        params0 = params
        best, taus = select_candidate(energies, ess, taus, iteration=it)
        stalled = best is None
        if stalled:
            chosen_tau = 0.0
        else:
            params = candidates[best]
            chosen_tau = taus[best]
        taus, ok_streak = update_tau_grid(taus, taus0, ok_streak, stalled, tau_recover)
        rec = {
            "iteration": it,
            "energy": float(np.mean(block_avg["total"])),
            "energy_err": float(np.std(block_avg["total"], ddof=1) / np.sqrt(len(data))),
            "gnorm": gnorm,
            "tau": chosen_tau,
            "stalled": stalled,
            "line_energies": energies,
        }
        records.append(rec)
        if callback is not None:
            callback(rec, {"block_avg": block_avg, "steps": steps, "params0": params0,
                           "candidates": candidates, "positions": positions, "rot": rot,
                           "u_sel": u_sel, "ess": ess,
                           "seconds": {"vmc": t1 - t0, "solve": t2 - t1, "correlated": t3 - t2}})
        if verbose and talks:
            print(f"linemin iter {it}: E={rec['energy']:.6f}({rec['energy_err']:.6f}) "
                  f"|g|={gnorm:.4f} tau={chosen_tau}", flush=True)
        if hdf_file is not None or checkpoint is not None:
            x = transform.serialize(params).detach().cpu().numpy()
        if hdf_file is not None and talks:
            with open_hdf(hdf_file, "a") as f:
                append_hdf(f, {"energy": rec["energy"], "energy_err": rec["energy_err"],
                               "gnorm": gnorm, "tau": chosen_tau, "x": x})
                configs.to_hdf(f.require_group("configs"))
        if checkpoint is not None:
            checkpoint.update(iterations=it + 1, x=x, configs=Configs.create(
                configs.positions.clone(), configs.geometry, wrap=configs.wrap.clone()))
    return params, configs, records

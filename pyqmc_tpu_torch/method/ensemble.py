"""Excited-state (ensemble) optimization with overlap penalties (counterpart
of pyqmc_tpu/method/ensemble.py). Each optimized state k minimizes

    Cost_k = E_k + lambda * sum_{j<k} |O_kj|^2

with every expectation taken over the mixture rho = sum_i |psi_i|^2
(method/sample_many.py). The energy gradient, the overlap gradients and the
SR metric of one state are walker means on the device; the (nparam,
nparam) solve runs on the host in float64 numpy. `hdf_file=` appends each
iteration's row (the iteration, the overlap matrix, each optimized
state's parameter vector x{k} and energy{k}) and keeps the walkers; a run
on a file that holds iterations resumes after the last.

With a walker mesh (parallel/mesh.py) the overlap sampling runs under it,
each rank evaluates the estimators on its slice of the walkers (the
energy's ECP draws made for all walkers alike on every rank, each taking
its slice), the estimators are means over the mesh, and rank 0 solves
each state's step and broadcasts it, so every rank holds the same
parameters, bit for bit.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..observables.ecp import rotations_from_quaternions
from ..parallel.mesh import mean_over, replicate, shard_walkers
from .hdftools import append_hdf, open_hdf
from .sample_many import amplitudes, make_overlap_block, sample_overlap
from .vmc import averages_to_host, checkpoint_configs, downselects, fold_generator


def make_state_gradient_fn(wfs, k, transform, energy_acc, mesh=None):
    """fn(params_list, positions, rot=None, u_sel=None) -> walker means (0-d
    tensors, (nparam,) and (nparam, nparam) arrays) of the penalty-SR
    ingredients of state k; rot (nelec, nconf, 3, 3) and u_sel (nelec,
    nconf) are the energy's ECP draws. mesh: each rank passes its walkers
    and draws, and the means are over the mesh."""

    def fn(params_list, positions, rot=None, u_sel=None):
        states = tuple(wf.recompute(p, positions) for wf, p in zip(wfs, params_list))
        a, rho = amplitudes(wfs, params_list, states)
        wk = torch.abs(a[k]) ** 2 / rho
        el = energy_acc(wfs[k], params_list[k], states[k], positions, rot, u_sel)["total"]
        dp, _ = transform.serialize_gradients_pair(wfs[k].pgradient(params_list[k], positions))
        dp = dp.to(wk.dtype)
        nconf = dp.shape[0]
        out = {"den": torch.mean(wk), "el_w": torch.mean(wk * el),
               "dp_el_w": (wk * el) @ dp / nconf, "dp_w": wk @ dp / nconf,
               "dpdp_w": (dp * wk[:, None]).T @ dp / nconf, "nkk": torch.mean(wk)}
        for j in range(len(wfs)):
            cross = (a[k].conj() * a[j] / rho).real
            out[f"n_{j}"] = torch.mean(cross)
            out[f"dp_n_{j}"] = cross @ dp / nconf
        return out if mesh is None else mean_over(mesh, out)

    return fn


def delta_p_state(k, est, taus, penalty, eps=1e-3, nlower=None):
    """The penalty-SR steps -tau S^-1 g, one per tau, and E_k, from the
    averaged estimators of make_state_gradient_fn (numpy, float64)."""
    est = {key: np.asarray(v, dtype=np.float64) for key, v in est.items()}
    den = est["den"]
    e_k = est["el_w"] / den
    g = 2.0 * (est["dp_el_w"] - e_k * est["dp_w"]) / den
    nkk = est["nkk"]
    for j in range(nlower if nlower is not None else k):
        n_kj = est[f"n_{j}"]
        njj = est.get(f"njj_{j}", None)
        o_kj = n_kj / np.sqrt(nkk * njj) if njj else n_kj / nkk
        d_o = (est[f"dp_n_{j}"] - n_kj * est["dp_w"] / nkk) / nkk
        g = g + 2.0 * penalty * o_kj * d_o
    dpm = est["dp_w"] / den
    S = est["dpdp_w"] / den - np.outer(dpm, dpm)
    step = np.linalg.solve(S + eps * np.eye(len(g)), g)
    return [-tau * step for tau in taus], e_k


def optimize_ensemble(wfs, params_list, transforms, configs, energy_acc, generator=None,
                      max_iterations=10, penalty=2.0, tau=0.1, nblocks=6, nsteps=10, tstep=0.5,
                      mesh=None, hdf_file=None, verbose=False):
    """Optimize every state against all lower states; transforms: one
    LinearTransform per state, None for a frozen one. Per iteration: an
    overlap sample of nblocks x nsteps (one block function for the whole
    run), then for each optimized state its estimators on the sample's
    walkers (the energy's ECP draws from `generator`) and one step.
    Returns (params_list, records), a record per iteration: "iteration",
    "overlap" (the blocks' mean) and "energy{k}" of each optimized state.

    hdf_file: append each iteration's row and keep the walkers there; where
    the file holds iterations, resume after the last: each optimized
    state's last x{k}, the walkers, and a generator folded from
    `generator`'s seed and the first iteration (vmc.fold_generator).

    mesh: a walker mesh (the module docstring); every rank passes the whole
    population, the same parameters and a generator in the same state;
    rank 0 alone writes `hdf_file`."""
    device, dtype = configs.positions.device, configs.positions.dtype
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(int(time.time() * 1e6) % (2**31))
    params_list = list(params_list)
    start_it = 0
    if hdf_file is not None and os.path.exists(hdf_file):
        with open_hdf(hdf_file, "r") as f:
            if "iteration" in f and len(f["iteration"]) > 0:
                start_it = int(np.asarray(f["iteration"])[-1]) + 1
                for k, t in enumerate(transforms):
                    if t is not None:
                        params_list[k] = t.deserialize(
                            params_list[k], torch.as_tensor(np.asarray(f[f"x{k}"])[-1]))
                if "configs" in f:
                    configs = checkpoint_configs(f["configs"], configs,
                                                 f"ensemble restart from {hdf_file}")
                generator = fold_generator(generator, start_it)
                if verbose:
                    print(f"ensemble: resuming at iteration {start_it} from {hdf_file}",
                          flush=True)
    block_fn = make_overlap_block(wfs, configs.geometry, tstep=tstep, nsteps=nsteps,
                                  energy_acc=energy_acc, mesh=mesh)
    grad_fns = [make_state_gradient_fn(wfs, k, t, energy_acc, mesh=mesh) if t is not None
                else None for k, t in enumerate(transforms)]
    ecp = getattr(energy_acc, "ecp_acc", None)
    nconf, nelec = configs.positions.shape[:2]
    talks = mesh is None or mesh.rank == 0
    if mesh is not None:
        device = mesh.device

    def solve(k, est):
        """(state k's step, E_k); under a mesh rank 0 solves and broadcasts."""
        if mesh is None:
            steps, e_k = delta_p_state(k, est, [tau], penalty)
            return steps[0], e_k
        out = np.zeros(transforms[k].nparams + 1)
        if mesh.rank == 0:
            steps, e_k = delta_p_state(k, est, [tau], penalty)
            out[:-1], out[-1] = steps[0], e_k
        out = replicate(mesh, torch.as_tensor(out)).cpu().numpy()
        return out[:-1], float(out[-1])

    records = []
    for it in range(start_it, max_iterations):
        data, configs = sample_overlap(wfs, params_list, configs, generator, nblocks=nblocks,
                                       block_fn=block_fn, mesh=mesh)
        overlap = np.mean([d["overlap"] for d in data], axis=0)
        rec = {"iteration": it, "overlap": overlap}
        positions = configs.positions if mesh is None else shard_walkers(mesh, configs.positions)
        for k, (t, gfn) in enumerate(zip(transforms, grad_fns)):
            if t is None:
                continue
            rot = u_sel = None
            if ecp is not None:
                quat = torch.randn((nelec, nconf, 4), generator=generator,
                                   device=generator.device, dtype=dtype)
                rot = rotations_from_quaternions(quat).to(device)
                if downselects({"energy": energy_acc}):
                    u_sel = torch.rand((nelec, nconf), generator=generator,
                                       device=generator.device, dtype=dtype).to(device)
                if mesh is not None:  # this rank's walkers' draws
                    rot = shard_walkers(mesh, rot.transpose(0, 1)).transpose(0, 1)
                    u_sel = None if u_sel is None else shard_walkers(mesh, u_sel.T).T
            est = averages_to_host(gfn(tuple(params_list), positions, rot, u_sel),
                                   torch.float64)
            # the normalized overlaps with lower states need N_jj too
            for j in range(k):
                est[f"njj_{j}"] = float(np.real(overlap[j, j]))
            step, e_k = solve(k, est)
            flat = t.serialize(params_list[k]).to(torch.float64).cpu() + torch.as_tensor(step)
            params_list[k] = t.deserialize(params_list[k], flat)
            rec[f"energy{k}"] = float(e_k)
        records.append(rec)
        if hdf_file is not None and talks:
            row = {"iteration": it, "overlap": overlap}
            for k, t in enumerate(transforms):
                if t is not None:
                    row[f"x{k}"] = t.serialize(params_list[k]).detach().cpu().numpy()
                    row[f"energy{k}"] = rec[f"energy{k}"]
            with open_hdf(hdf_file, "a") as f:
                append_hdf(f, row)
                configs.to_hdf(f.require_group("configs"))
        if verbose and talks:
            es = {kk: v for kk, v in rec.items() if kk.startswith("energy")}
            o01 = (abs(overlap[0, 1] / np.sqrt(abs(overlap[0, 0] * overlap[1, 1])))
                   if overlap.shape[0] > 1 else float("nan"))
            print(f"ensemble iter {it}: {es} |O01|={o01:.4f}", flush=True)
    return params_list, records

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (pyqmc_tpu_torch, never jax): ccECP/cc-pVDZ
H2O Slater-Jastrow VMC, 2048 walkers, 50-step blocks, with the energy
accumulator and its nonlocal ECP quadrature every step.

  0. the card's name and power limit (nvidia-smi); no CUDA device -> fail
  1. build the CUDA kernels from csrc/ (nvcc, sm_90a)
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes, from one state and one set of random streams:
       float64: sweep positions and every state leaf to 1e-9, acceptance
       exactly, ECP energy to rtol 1e-9;
       float32: ECP energy to rtol 1e-4; for the sweep, the walkers whose
       accept decisions differ are counted (<= 1%) and the walkers that
       agree must match to 1e-4 (positions, phases, log|det|, Jastrow U,
       orbital caches). In float32 the kernel and the plain version sum in
       other orders, so a move whose acceptance probability lies within
       rounding of its uniform can flip, after which that walker's chain
       differs; float64 leaves no such flips at this size. The inverses of
       agreeing walkers match to 1e-4 in norm, relative, times
       max(1, cond/100), cond being the largest condition number of the
       walker's orbital matrices along the sweep: the rounding error of an
       inverse updated in float32 grows with it, and it is large near a
       node.
     then each kernel's time beside its plain version's (CUDA events)
  3. the main path through the entry points: h2o_setup + vmc(), 4 blocks
     x 50 steps in float32 with the kernels; the launch counts must be 200
     sweeps and 200 ECP evaluations; energies finite; the mean total
     energy of the last two blocks in (-17.2, -16.8) Ha and the acceptance
     in (0.5, 0.75). These windows catch a missing ECP (+1 Ha) or a
     low-precision matmul bias; they are no bar for speed.
  4. one 50-step block with the kernels and one with the plain versions,
     timed in turns (plain, kernel, kernel, plain)
  5. one kernel-path block under torch.profiler: the device's busy time
     (the sum of its kernel and copy times), the launches per step, the
     kernels that take most device time and the port's kernels' device
     time per launch (phase 2's CUDA-event times include the wrappers'
     host work); the idle share against the traced block's wall time and
     against phase 4's untraced kernel block

Any failure raises, so the exit code is not 0. The line before the last is
a JSON object of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import subprocess
import time

import numpy as np
import torch

NCONF = 2048
NSTEPS = 50
TSTEP = 0.5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    return [t for s in state for t in leaves(s)]


def randomize_jastrow(params, seed):
    """Nonzero e-ion and perturbed e-e coefficients, so the kernels' Jastrow
    paths are all exercised (the defaults have acoeff = 0)."""
    rng = np.random.default_rng(seed)
    p = {k: dict(v) for k, v in params.items()}
    j = p["wf1"]
    j["acoeff"] = torch.as_tensor(rng.normal(scale=0.1, size=tuple(j["acoeff"].shape)),
                                  dtype=j["acoeff"].dtype, device=j["acoeff"].device)
    j["bcoeff"] = j["bcoeff"] + torch.as_tensor(
        rng.normal(scale=0.05, size=tuple(j["bcoeff"].shape)), dtype=j["bcoeff"].dtype,
        device=j["bcoeff"].device)
    return p


def compare_kernels(dtype):
    """Phase 2 for one dtype. Returns the measured numbers."""
    from pyqmc_tpu_torch.configs import Geometry
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.observables.energy import kinetic_energy
    from pyqmc_tpu_torch.ops.ecp_energy import build_fused_ecp_energy
    from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep

    mol, wf, params, configs, acc = h2o_setup(NCONF, device="cuda", dtype=dtype, seed=11)
    params = randomize_jastrow(params, 12)
    pos, wrap = configs.positions, configs.wrap
    state = wf.recompute(params, pos)
    gen = torch.Generator(device="cuda").manual_seed(13)
    streams = draw_streams(gen, 1, pos.shape[1], NCONF, TSTEP, pos.device, dtype)
    gauss, unif, rot = streams["gauss"][0], streams["unif"][0], streams["rot"][0]
    sweep = build_fused_sweep(wf, Geometry(), TSTEP)
    ecp = build_fused_ecp_energy(wf, acc["energy"].ecp_acc)
    check(sweep is not None and ecp is not None, "main path is outside the kernels' gates")

    pk, _, sk, acck = sweep.kernel(params, pos, wrap, state, gauss, unif)
    pp, _, sp, accp = sweep.plain(params, pos, wrap, state, gauss, unif)
    ek = ecp.kernel(params, pos, state, rot)
    ep = ecp.plain(params, pos, state, rot)
    torch.cuda.synchronize()
    res = {}
    scale = float(torch.mean(torch.abs(ep)))
    ecp_err = torch.abs(ek - ep)
    res["ecp_max_abs_err"] = float(torch.max(ecp_err))
    if dtype == torch.float64:
        # rtol 1e-9 with an absolute floor of 1e-9 of the mean magnitude for
        # walkers whose channels cancel to ~0
        check(bool(torch.all(ecp_err <= 1e-9 * (torch.abs(ep) + scale))),
              f"f64 ECP energy differs: max abs err {res['ecp_max_abs_err']:.3e}")
        check(float(acck) == float(accp), f"f64 acceptance {float(acck)} != {float(accp)}")
        worst = 0.0
        for a, b in zip([pk] + leaves(sk), [pp] + leaves(sp)):
            err = torch.abs(a - b)
            worst = max(worst, float(torch.max(err)))
            # 1e-9 absolute, and relative for inverse entries near a node
            check(bool(torch.all(err <= 1e-9 * (1 + torch.abs(b)))),
                  f"f64 sweep state differs: max abs err {float(torch.max(err)):.3e}")
        res["sweep_max_abs_err"] = worst
        res["acceptance"] = float(acck) / pos.shape[1]
        return res
    check(bool(torch.all(ecp_err <= 1e-4 * (torch.abs(ep) + scale))),
          f"f32 ECP energy differs: max abs err {res['ecp_max_abs_err']:.3e}")
    moved_k = torch.any(pk != pos, dim=-1)
    moved_p = torch.any(pp != pos, dim=-1)
    differ = torch.any(moved_k != moved_p, dim=1)  # (nconf,)
    ndiff = int(torch.sum(differ))
    res["walkers_with_flipped_accepts"] = ndiff
    check(ndiff <= 0.01 * NCONF, f"f32 sweep: {ndiff} walkers with differing accepts")
    agree = ~differ
    sl_k, j_k = sk
    sl_p, j_p = sp
    pairs = [(pk, pp), (sl_k.phase_up, sl_p.phase_up), (sl_k.phase_dn, sl_p.phase_dn),
             (sl_k.logdet_up, sl_p.logdet_up), (sl_k.logdet_dn, sl_p.logdet_dn), (j_k.u, j_p.u),
             (sl_k.mog_up, sl_p.mog_up), (sl_k.mog_dn, sl_p.mog_dn)]
    worst = 0.0
    for a, b in pairs:
        err = torch.abs(a - b)[agree]
        worst = max(worst, float(torch.max(err)))
        check(bool(torch.all(err <= 1e-4 * (1 + torch.abs(b[agree])))),
              f"f32 sweep: agreeing walkers differ by {float(torch.max(err)):.3e}")
    res["sweep_max_abs_err"] = worst
    # The inverses are updated move by move (Sherman-Morrison), so their
    # float32 error follows the largest condition number of the orbital
    # matrices along the sweep: after move k the first k electrons sit at
    # their new positions. Those matrices, and the exact final inverses,
    # come from float64 recomputes.
    p64 = {k: {kk: vv.double() for kk, vv in v.items()} for k, v in params.items()}
    conds = {"up": [], "dn": []}
    for k in range(pos.shape[1] + 1):
        sl_mid = wf.recompute(p64, torch.cat([pp[:, :k], pos[:, k:]], dim=1).double())[0]
        conds["up"].append(torch.linalg.cond(sl_mid.mog_up[:, :, 0, :]))
        conds["dn"].append(torch.linalg.cond(sl_mid.mog_dn[:, :, 0, :]))
    for spin, inv_k, inv_p, inv_x in [("up", sl_k.inv_up, sl_p.inv_up, sl_mid.inv_up),
                                      ("dn", sl_k.inv_dn, sl_p.inv_dn, sl_mid.inv_dn)]:
        cond = torch.amax(torch.stack(conds[spin]), dim=0)

        def nrel(a, b):
            return (torch.linalg.norm((a.double() - b.double()).flatten(1), dim=1)
                    / torch.linalg.norm(b.double().flatten(1), dim=1))

        rel = nrel(inv_k, inv_p)
        entry = torch.amax(torch.abs(inv_k - inv_p) / (1 + torch.abs(inv_p)), dim=(1, 2, 3))
        w = int(torch.argmax(torch.where(agree, entry, torch.zeros_like(entry))))
        res[f"inverse_{spin}"] = {
            "max_entry_err_over_1_plus_abs": float(entry[w]), "at_walker": w,
            "path_cond_there": float(cond[w]), "norm_rel_err_there": float(rel[w]),
            "kernel_err_vs_exact_there": float(nrel(inv_k, inv_x)[w]),
            "plain_err_vs_exact_there": float(nrel(inv_p, inv_x)[w]),
            "max_norm_rel_err_path_cond_le_100": float(torch.max(rel[agree & (cond <= 100)])),
            "max_norm_rel_err_over_path_cond": float(torch.max((rel / cond)[agree])),
            "walkers_path_cond_gt_100": int(torch.sum(cond > 100)),
            "median_path_cond": float(torch.median(cond))}
        bound = 1e-4 * torch.clamp(cond / 100, min=1.0)
        bad = agree & ~(rel <= bound)
        check(not bool(torch.any(bad)),
              f"f32 sweep: {int(torch.sum(bad))} agreeing walkers' {spin} inverses differ "
              f"beyond 1e-4 * max(1, cond/100): {json.dumps(res[f'inverse_{spin}'])}")

    # times at the main path's shapes, float32
    res["sweep_ms"] = cuda_ms(lambda: sweep.kernel(params, pos, wrap, state, gauss, unif), 20)
    res["sweep_plain_ms"] = cuda_ms(lambda: sweep.plain(params, pos, wrap, state, gauss, unif), 5)
    res["ecp_ms"] = cuda_ms(lambda: ecp.kernel(params, pos, state, rot), 20)
    res["ecp_plain_ms"] = cuda_ms(lambda: ecp.plain(params, pos, state, rot), 5)
    # the rest of a step, plain PyTorch on the main path
    res["kinetic_ms"] = cuda_ms(lambda: kinetic_energy(wf, params, state, pos), 5)
    res["coulomb_ms"] = cuda_ms(lambda: acc["energy"].coulomb.energy(pos), 5)
    return res


def traced_block(block_fn, params, pos, wrap, gen):
    """Runs one block under torch.profiler (device activity only).
    Returns (device busy us, device events, top 5 {name: ms}, the port's
    kernels {name: [launches, ms per launch]}, wall s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        block_fn(params, pos, wrap, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name, ours = {}, {}
    nkern = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            nkern += 1
            us = e.time_range.elapsed_us()
            per_name[e.name] = per_name.get(e.name, 0.0) + us
            if "pq::" in e.name:  # csrc/ kernels live in namespace pq
                name = e.name.split("pq::")[1].split("<")[0]
                n, tot = ours.get(name, (0, 0.0))
                ours[name] = (n + 1, tot + us)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    ours = {k: [n, tot / n / 1e3] for k, (n, tot) in ours.items()}
    return sum(per_name.values()), nkern, {k[:80]: v / 1e3 for k, v in top}, ours, wall


def main():
    t_start = time.perf_counter()
    # phase 0: the card (and the package: nothing is printed without both)
    check(torch.cuda.is_available(), "no CUDA device; the port's kernels run only on a GPU")
    from pyqmc_tpu_torch.ops import _build, ecp_energy, move_sweep

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # phase 1: build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"phase 1: built {so} in {time.perf_counter() - t0:.1f} s", flush=True)
    with open(so[:-3] + ".log") as f:
        for line in f:
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                print("  ptxas:", line.strip().replace("ptxas info    : ", ""), flush=True)

    # phase 2: kernels against their plain versions
    r64 = compare_kernels(torch.float64)
    print("phase 2 float64: " + json.dumps(r64), flush=True)
    r32 = compare_kernels(torch.float32)
    print("phase 2 float32: " + json.dumps(r32), flush=True)

    # phase 3: the main path through the entry points
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.vmc import vmc

    mol, wf, params, configs, acc = h2o_setup(NCONF, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    move_sweep.LAUNCHES.reset()
    ecp_energy.LAUNCHES.reset()
    t0 = time.perf_counter()
    blocks, configs = vmc(wf, params, configs, nblocks=4, nsteps_per_block=NSTEPS, tstep=TSTEP,
                          accumulators=acc, generator=gen)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = {"vmc_sweep": move_sweep.LAUNCHES.n, "ecp_energy": ecp_energy.LAUNCHES.n}
    for b in blocks:
        print(f"phase 3 block {b['block']}: E={b['energytotal']:.6f} ecp={b['energyecp']:.6f} "
              f"ke={b['energyke']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s",
              flush=True)
    check(launches == {"vmc_sweep": 4 * NSTEPS, "ecp_energy": 4 * NSTEPS},
          f"kernel launches on the main path: {launches}")
    for b in blocks:
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in block {b['block']}")
    e_last = float(np.mean([b["energytotal"] for b in blocks[-2:]]))
    a_last = float(np.mean([b["acceptance"] for b in blocks[-2:]]))
    check(-17.2 < e_last < -16.8, f"energy {e_last} outside (-17.2, -16.8) Ha")
    check(0.5 < a_last < 0.75, f"acceptance {a_last} outside (0.5, 0.75)")
    print(f"phase 3: launches {launches}, E(last 2 blocks)={e_last:.6f} Ha, acc={a_last:.4f}, "
          f"{t_main:.2f} s for 4 blocks", flush=True)

    # phase 4: one block with the kernels, one with the plain versions
    from pyqmc_tpu_torch.method.vmc import make_vmc_block
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator

    acc_plain = {"energy": EnergyAccumulator(mol, ecp_acc=ECPAccumulator(mol, fused=False))}
    fns = {"kernel": make_vmc_block(wf, acc, configs.geometry, TSTEP, NSTEPS, fused=True),
           "plain": make_vmc_block(wf, acc_plain, configs.geometry, TSTEP, NSTEPS, fused=False)}
    pos, wrap = configs.positions, configs.wrap
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pos, wrap, avg = fns[name](params, pos, wrap, gen)
        check(bool(torch.isfinite(avg["energytotal"])), f"non-finite {name} block energy")
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    tk, tp = float(np.mean(times["kernel"])), float(np.mean(times["plain"]))
    print(f"phase 4: 50-step block with kernels {tk:.4f} s ({NCONF * NSTEPS / tk:.1f} "
          f"walker-steps/s), plain {tp:.4f} s ({NCONF * NSTEPS / tp:.1f} walker-steps/s); "
          f"runs {json.dumps(times)}", flush=True)

    # phase 5: one traced kernel block; the device's busy time and idle share
    busy_us, nkern, top, ours, t_traced = traced_block(fns["kernel"], params, pos, wrap, gen)
    print(f"phase 5: traced kernel block {t_traced:.4f} s wall, device busy {busy_us / 1e6:.4f} s "
          f"({nkern} device events, {nkern / NSTEPS:.0f} per step); idle share "
          f"{1 - busy_us / 1e6 / t_traced:.4f} of the traced block, "
          f"{1 - busy_us / 1e6 / tk:.4f} of the untraced phase-4 block; the port's kernels "
          f"[launches, device ms per launch]: {json.dumps(ours)}; top device time (ms): "
          f"{json.dumps(top)}", flush=True)
    check(busy_us > 0, "the profiler recorded no device time")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = [
        {"name": "vmc_sweep", "route": "cuda", "source": "pyqmc_tpu_torch/csrc/vmc_sweep.cu",
         "replaces": "pyqmc_tpu/ops/move_pallas.py:278", "launches": launches["vmc_sweep"],
         "max_abs_err": r32["sweep_max_abs_err"], "ms": r32["sweep_ms"],
         "plain_ms": r32["sweep_plain_ms"]},
        {"name": "ecp_energy", "route": "cuda", "source": "pyqmc_tpu_torch/csrc/ecp_energy.cu",
         "replaces": "pyqmc_tpu/ops/move_pallas.py:1151", "launches": launches["ecp_energy"],
         "max_abs_err": r32["ecp_max_abs_err"], "ms": r32["ecp_ms"],
         "plain_ms": r32["ecp_plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Device time of one launch of K1 (csrc/vmc_sweep.cu), K2
(csrc/ecp_energy.cu), K4 (csrc/dmc_sweep.cu) and K5 (csrc/tmove_sweep.cu)
at ccECP H2O's shapes, 2048 walkers, float32, for the pyqmc_tpu_torch of a
given checkout, on one NVIDIA GPU; also each wrapper's time and the host
time of one H2O VMC and one DMC block.

    python tools/time_k1_k5.py [ROOT] [LABEL]

ROOT (default: this checkout) is the directory that holds the package; its
kernels are built from its own csrc/ into its own build/. The script packs
each kernel's arguments once and times 50 launches of the C entry point
back to back with CUDA events after a warm-up; so it times two checkouts
with one procedure, which is how a redesign is compared with its parent in
one call (run parent, change, change, parent). A checkout whose wrappers
have `pack` (the lane-group kernels) is packed by them, and its kernels'
lanes per walker (the sources' LANES) and shared bytes per block are
reported; kernels of older checkouts without `pack` (the
one-thread-per-walker K1, K4, K5 of commit 6a8d10c; K2 before its
lane-group redesign, with its transposed copies and scratch) are packed by
`old_pack`. The wrapper time is the same
procedure over calls of the wrapper's `kernel` (host packing and
unpacking included). The blocks are a 50-step VMC block
(make_vmc_block) and a 10-step DMC block with T-moves (make_dmc_block) of
a fresh h2o_setup(2048, seed 11), one warm-up then three timed by the host
clock, each ending in a synchronize. Inputs of the launches as
chip_smoke.py phase 2: h2o_setup(2048, seed 11), Jastrow coefficients
from seed 12, streams from seed 13; K1 and K2 at tstep 0.5, K4 and K5 at
0.02. Prints the card's name and power limit and one JSON line.
"""

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")
LABEL = sys.argv[2] if len(sys.argv) > 2 else ROOT
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

NCONF, REPS, TSTEP, DMC_TSTEP = 2048, 50, 0.5, 0.02
VMC_NSTEPS, DMC_NSTEPS, NBLOCKS = 50, 10, 3
SOURCES = {"vmc_sweep": "vmc_sweep.cu", "ecp_energy": "ecp_energy.cu",
           "dmc_sweep": "dmc_sweep.cu", "tmove_sweep": "tmove_sweep.cu"}


def source_lanes(name):
    """LANES of the kernel's source in ROOT, None where it has none."""
    with open(os.path.join(ROOT, "pyqmc_tpu_torch", "csrc", SOURCES[name])) as f:
        m = re.search(r"constexpr int LANES = (\d+);", f.read())
    return int(m.group(1)) if m else None


def cuda_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def shared_bytes(fn, lanes, itemsize):
    """Dynamic shared memory of one block of a lane-group launch: the
    staged tables and plan, then 128 / lanes walkers' rows, as
    csrc/lane_group.cuh (staged_bytes) and the kernels' sweep_smem /
    tmove_smem lay them out (H2O's blocks are far below the 227 KB that
    would cut the walkers per block); K2's from its module's mirror of
    ecp_smem (`block_shared`)."""
    if not hasattr(fn, "walkers"):  # K2
        return sys.modules[type(fn).__module__].block_shared(fn.tables, itemsize)[1]
    t, w = fn.tables, fn.walkers
    nmax, nelec = w.nmax(), t.nup + t.ndn
    nrows = 3 * nelec + t.nup ** 2 + t.ndn ** 2 + 4 + 4 * t.nup ** 2 + 4 * t.ndn ** 2 + 1
    base = (-(-(t.ntab * itemsize + 4 * len(t._meta)) // 16) * 16
            + -(-(4 * len(t.plan)) // 16) * 16)
    if hasattr(fn, "tau"):  # K5
        nq = t.nq_total
        row = (nrows + 11 * nelec + 6 * nq + max(nq, 2) * t.nprim + max(nq, 4) * t.nao
               + max(nq, 4) * nmax + nq * lanes + 2 * nmax)
    else:
        row = nrows + 4 * nelec + 2 * t.nprim + 4 * t.nao + 6 * nmax
    return base + (128 // lanes) * row * itemsize


def old_pack(fn, args):
    """(C entry, held tensors, arguments) of a wrapper without `pack`:
    K2 before its lane-group redesign (parent 6869c39), with the transposed
    copies and the wvec and partial scratch its `kernel` makes; the
    one-thread-per-walker K1, K4, K5 of commit 6a8d10c: walker-minor state,
    gauss and rotations, K5 with its global scratch."""
    from pyqmc_tpu_torch.ops.move_sweep import FusedSweep, _factor

    if not hasattr(fn, "walkers"):  # K2
        params, pos, state, rot = args
        nconf, nelec = pos.shape[:2]
        dtype, t = pos.dtype, fn.tables
        sl_params, sl = _factor(fn.wf, fn.sl_idx, params, state)
        j_params = _factor(fn.wf, fn.j_idx, params, state)[0] if fn.jastrow else None
        pos_t = pos.reshape(nconf, 3 * nelec).t().contiguous()
        invu = sl.inv_up.reshape(nconf, t.nup * t.nup).t().contiguous()
        invd = sl.inv_dn.reshape(nconf, t.ndn * t.ndn).t().contiguous()
        rot_t = rot.reshape(nelec, nconf, 9).permute(0, 2, 1).reshape(9 * nelec, nconf)
        rot_t = rot_t.to(dtype).contiguous()
        tab, meta = t.pack(sl_params, j_params, pos.device, dtype)
        wvec = torch.empty((t.nao, nelec * nconf), dtype=dtype, device=pos.device)
        partial = torch.empty((nelec, nconf), dtype=dtype, device=pos.device)
        out = torch.empty(nconf, dtype=dtype, device=pos.device)
        held = (pos_t, invu, invd, rot_t, tab, meta, wvec, partial, out)
        return "pq_ecp_energy", held, (
            pos_t.data_ptr(), invu.data_ptr(), invd.data_ptr(), rot_t.data_ptr(),
            wvec.data_ptr(), partial.data_ptr(), out.data_ptr(), tab.data_ptr(), tab.numel(),
            meta.data_ptr(), meta.numel(), nelec, nconf)
    params, pos, _, state, *streams = args
    nconf, nelec = pos.shape[:2]
    dtype = pos.dtype
    sl_params, sl, j_params, js = fn.walkers.split(params, state)
    state_in, _ = fn.walkers.pack(pos, sl, js)
    tab, meta = fn.tables.pack(sl_params, j_params, pos.device, dtype)
    state_out = torch.empty_like(state_in)
    if isinstance(fn, FusedSweep):
        gauss, unif = streams
        gauss_t = gauss.permute(0, 2, 1).reshape(3 * nelec, nconf).contiguous()
        unif_t = unif.contiguous()
        dmc = fn.mode == "dmc"
        sums = torch.empty((3 if dmc else 1, nconf), dtype=dtype, device=pos.device)
        args = (state_in.data_ptr(), state_out.data_ptr(), gauss_t.data_ptr(), unif_t.data_ptr(),
                sums.data_ptr(), tab.data_ptr(), tab.numel(), meta.data_ptr(), meta.numel(),
                nconf, state_in.shape[0], fn.walkers.nmax(), fn.tstep)
        if not dmc:
            args += (fn.drift_cutoff,)
        return ("pq_dmc_sweep" if dmc else "pq_vmc_sweep",
                (state_in, gauss_t, unif_t, tab, meta, state_out, sums), args)
    rot, u_sel, u_acc = streams
    rot_t = rot.reshape(nelec, nconf, 9).permute(0, 2, 1).reshape(9 * nelec, nconf)
    rot_t = rot_t.to(dtype).contiguous()
    u_sel, u_acc = u_sel.contiguous(), u_acc.contiguous()
    scratch = torch.empty((2 * fn.tables.nq_total, nconf), dtype=dtype, device=pos.device)
    args = (state_in.data_ptr(), state_out.data_ptr(), rot_t.data_ptr(), u_sel.data_ptr(),
            u_acc.data_ptr(), scratch.data_ptr(), tab.data_ptr(), tab.numel(), meta.data_ptr(),
            meta.numel(), nconf, state_in.shape[0], fn.walkers.nmax(), fn.tau)
    return ("pq_tmove_sweep", (state_in, rot_t, u_sel, u_acc, tab, meta, state_out, scratch),
            args)


def time_blocks():
    """Host seconds of NBLOCKS VMC and DMC blocks of H2O with the kernels,
    after one warm-up block each."""
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.dmc import make_dmc_block
    from pyqmc_tpu_torch.method.vmc import make_vmc_block

    mol, wf, params, configs, acc = h2o_setup(NCONF, device="cuda", dtype=torch.float32,
                                              seed=11)
    gen = torch.Generator(device="cuda").manual_seed(14)
    vmc_block = make_vmc_block(wf, acc, configs.geometry, TSTEP, VMC_NSTEPS)
    dmc_block, _ = make_dmc_block(wf, acc["energy"], configs.geometry, DMC_TSTEP, DMC_NSTEPS)
    walk = {"pos": configs.positions, "wrap": configs.wrap,
            "w": torch.ones(NCONF, dtype=torch.float32, device="cuda")}
    e = {}

    def vmc():
        walk["pos"], walk["wrap"], avg = vmc_block(params, walk["pos"], walk["wrap"], gen)
        e["vmc"] = float(avg["energytotal"])

    def dmc():
        walk["pos"], walk["wrap"], walk["w"], avg = dmc_block(
            params, walk["pos"], walk["wrap"], walk["w"], gen, e["vmc"], e["vmc"], 0.5)

    out = {}
    for name, run in (("vmc_block_s", vmc), ("dmc_block_s", dmc)):
        run()
        times = []
        for _ in range(NBLOCKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[name] = times
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_k1_k5: no CUDA device")
    from pyqmc_tpu_torch.configs import Geometry
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.ops import _build
    from pyqmc_tpu_torch.ops.ecp_energy import build_fused_ecp_energy
    from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep
    from pyqmc_tpu_torch.ops.tmove_sweep import build_fused_tmove_sweep

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dtype = torch.float32
    for cu, so in _build.build().items():
        if cu in SOURCES.values():
            with open(so[:-3] + ".log") as f:
                for line in f:
                    if "Compiling entry function" in line or "registers" in line or "spill" in line:
                        print("  ptxas:", line.strip().replace("ptxas info    : ", ""))
    _build.library()
    mol, wf, params, configs, acc = h2o_setup(NCONF, device="cuda", dtype=dtype, seed=11)
    rng = np.random.default_rng(12)
    j = params["wf1"]
    j["acoeff"] = torch.as_tensor(rng.normal(scale=0.1, size=tuple(j["acoeff"].shape)),
                                  dtype=dtype, device="cuda")
    j["bcoeff"] = j["bcoeff"] + torch.as_tensor(
        rng.normal(scale=0.05, size=tuple(j["bcoeff"].shape)), dtype=dtype, device="cuda")
    pos = configs.positions
    nelec = pos.shape[1]
    state = wf.recompute(params, pos)
    gen = torch.Generator(device="cuda").manual_seed(13)
    st = draw_streams(gen, 1, nelec, NCONF, TSTEP, pos.device, dtype)
    dst = draw_dmc_streams(gen, 1, nelec, NCONF, DMC_TSTEP, pos.device, dtype)
    ecp_acc = acc["energy"].ecp_acc
    walk = (params, pos, configs.wrap, state)
    calls = {
        "vmc_sweep": (build_fused_sweep(wf, Geometry(), TSTEP),
                      (*walk, st["gauss"][0], st["unif"][0])),
        "ecp_energy": (build_fused_ecp_energy(wf, ecp_acc), (params, pos, state, st["rot"][0])),
        "dmc_sweep": (build_fused_sweep(wf, Geometry(), DMC_TSTEP, mode="dmc"),
                      (*walk, dst["gauss"][0], dst["unif"][0])),
        "tmove_sweep": (build_fused_tmove_sweep(wf, Geometry(), ecp_acc, DMC_TSTEP),
                        (*walk, dst["tqrot"][0], dst["u_sel"][0], dst["u_acc"][0])),
    }
    out = {"label": LABEL, "card": card}
    for name, (fn, fargs) in calls.items():
        if hasattr(fn, "pack"):
            entry, outs, held, args = fn.pack(*fargs)
            lanes = source_lanes(name)
            res = {"lanes": lanes, "shared_bytes_per_block": shared_bytes(fn, lanes, 4)}
        else:
            entry, held, args = old_pack(fn, fargs)
            res = {}
        res["device_ms"] = cuda_ms(lambda: _build.launch(entry, dtype, *args), REPS)
        res["wrapper_ms"] = cuda_ms(lambda: fn.kernel(*fargs), REPS)
        out[name] = res
        del held
    out["blocks"] = time_blocks()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

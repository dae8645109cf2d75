#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's four paths (pyqmc_tpu_torch, never jax), float32: on
ccECP/cc-pVDZ H2O Slater-Jastrow, 2048 walkers, with the energy
accumulator and its nonlocal ECP quadrature every step, VMC in 50-step
blocks and fixed-node DMC with T-moves (`rundmc`) in 10-step blocks; and
on the 2x2x2 diamond-C supercell (`diamond_setup`, 500 walkers, 64
electrons, k-point Slater-Jastrow, Ewald, downselected ECP) periodic VMC
and periodic fixed-node DMC with T-moves, both in 10-step blocks.

  0. the card's name and power limit (nvidia-smi); no CUDA device -> fail
  1. build the CUDA kernels from csrc/ (one nvcc per source, side by side)
  2. each of the four kernels against its plain PyTorch version on the
     card, at the main path's shapes, from one state and one set of random
     streams:
       float64: positions and every state leaf to 1e-9, the same moves
       accepted, r2p / r2a of the dmc sweep to 1e-9, ECP energy to rtol
       1e-9;
       float32: ECP energy to rtol 1e-4; for the sweeps, the walkers whose
       accept decisions differ are counted (<= 1%) and the walkers that
       agree must match to 1e-4 (positions, phases, log|det|, Jastrow U,
       orbital caches, r2p, r2a). In float32 the kernel and the plain
       version sum in other orders, so a move whose acceptance probability
       lies within rounding of its uniform, a proposal within rounding of
       the node (dmc sweep) or a selection uniform within rounding of a
       cumulative probability (T-move sweep) can flip, after which that
       walker's chain differs; float64 leaves no such flips at this size.
       The inverses of agreeing walkers match to 1e-4 in norm, relative,
       times max(1, cond/100), cond being the largest condition number of
       the walker's orbital matrices along the sweep: the rounding error
       of an inverse updated in float32 grows with it, and it is large
       near a node.
     The vmc sweep and the ECP energy run at tstep 0.5, the dmc sweep and
     the T-move sweep at tstep 0.02, and the T-move sweep once more at
     tau 0.5, where a sizeable share of walkers takes a T-move (printed).
     Then each kernel's time beside its plain version's (CUDA events) and
     its bound: the larger of its bytes over 3.35 TB/s and its float32
     operations over 67 TFLOP/s, both counted from this run's shapes and
     accepted moves (`kernel_bounds`); for K1, K2, K4 and K5, the kernels
     redesigned for this card (a group of lanes per walker), also the
     device time of one launch from CUDA events over 50 launches of the C
     entry point back to back, the wrapper's time the same way, and the
     bound's share of the device time (`redesigned_times`).
     Last, the float64 blocks: one 10-step VMC block (K1, K2) and one
     10-step DMC block with T-moves (K4, K5, K2) of 512 walkers, each run
     through make_vmc_block / make_dmc_block with the kernels and with
     fused=False (and a plain ECP energy) on the same streams: positions,
     the state leaves after every step (a probe accumulator keeps them),
     every energy and the weights agree to 1e-9 (absolute, and relative
     for large entries), the acceptances exactly (at 512 walkers the
     means of accepted moves are exact in both summation orders). This
     holds the kernels over a whole chain.
  3. the VMC path through the entry points: h2o_setup + vmc(), 4 blocks
     x 50 steps with the kernels; the launch counts must be 200 sweeps and
     200 ECP evaluations; energies finite; the mean total energy of the
     last two blocks in (-17.2, -16.8) Ha and the acceptance in
     (0.5, 0.75). These windows catch a missing ECP (+1 Ha) or a
     low-precision matmul bias; they are no bar for speed. The energy
     must repeat the lane-group kernels' chain (H2O_VMC_E) within 1e-4
     Ha: the H2O draws do not change. It must also lie within 3 combined
     standard errors of the chain of the one-thread-per-walker kernels
     (H2O_VMC_E_ONE_THREAD): the standard error of the pinned mean is the
     scatter of the blocks after the first (reblock_by2's first level)
     over the square root of the blocks it averages, the same for the
     earlier chain, so the combined one is sqrt(2) times it.
  4. one 50-step VMC block with the kernels and one with the plain
     versions, timed in turns (plain, kernel, kernel, plain)
  5. one kernel-path VMC block under torch.profiler: the device's busy
     time (the sum of its kernel and copy times), the launches per step,
     the kernels that take most device time and the port's kernels' device
     time per launch (phase 2's CUDA-event times include the wrappers'
     host work); the idle share against the traced block's wall time and
     against phase 4's untraced kernel block
  6. the DMC path through the entry points: h2o_setup (default device) +
     rundmc(), 6 blocks x 10 steps at tstep 0.02 after 5 VMC warm-up
     blocks. Launch counts: 60 dmc sweeps, 60 T-move sweeps, 50 vmc sweeps
     (the warm-up) and 50 + 1 + 6 * 11 = 117 ECP evaluations (warm-up
     steps, the energy that sets e_trial, and per block its first energy
     plus one per step). Every energy and weight finite; block mean weight
     in (0.5, 2); acceptance above 0.9; the mean total energy of the last
     three blocks in (-17.6, -16.9) Ha and not above the warm-up VMC
     energy by more than 0.05 Ha. These windows catch a missing ECP, a
     broken branching weight or a sign error in the T-moves. The energy
     must repeat H2O_DMC_E within 1e-4 Ha and lie within 3 combined
     standard errors of H2O_DMC_E_ONE_THREAD, as in phase 3.
  7. one 10-step DMC block with the kernels and one with the plain
     versions, timed in turns, then one kernel-path DMC block under
     torch.profiler as in phase 5
  8. the periodic kernels against their plain versions at the diamond
     supercell's shapes, float64 and float32, with the tolerances of phase
     2: K7 in both modes (the periodic sweep; wrap counts too, and in the
     dmc mode r2p and r2a, at tstep 0.02 and at tstep 0.5, where half of
     the walkers get unif = 0 so that their rejections are the node's;
     the moves that wrapped and the node rejections are printed; the
     diamond's 32 x 32
     orbital matrices reach path condition numbers of 1e6, so in float32
     the leaves other than the inverses are held to the plain version in
     float64 from the same inputs: over the walkers whose decisions agree
     in all three runs, each leaf's largest error of the kernel against it
     must be at most 3 times the plain float32 version's plus 1e-5, and
     the walkers where the kernel is farther than that are counted; the
     inverses keep phase 2's 1e-4 x max(1, cond/100) gate), K6 (AO
     values, gradients, laplacians at one kinetic-energy chunk, 16,000
     points) and K3 (MOs at
     one ECP chunk, 252,000 points; and at H2O's 23 AOs on its ECP
     points); K3 and K6 to 1e-9 (f64) and 1e-4 (f32) of their entries plus
     the largest entry's magnitude (sums of 489 terms). Times and bounds as
     in phase 2; for K3 (at 252,000 points and at the T-move quadrature's
     48,000) and K7 (both modes), the kernels redesigned for this card,
     also the device time of one launch from CUDA events over 50 launches
     of the C entry point back to back, the wrapper's time the same way,
     and the bound's share of the device time (`redesigned_times`).
  9. the periodic VMC path through the entry points: diamond_setup(500) on
     the default device + vmc(), 8 blocks x 10 steps; launch counts per
     block exactly 10 K7, 20 K6 and 40 K3 (1, 2 and 4 per step); the energy
     per primitive cell of the last 4 blocks within max(5 x combined SEM,
     0.02 Ha) of the JAX package's CPU reference (tools/
     diamond_jax_reference.py) and the acceptance within 0.05 of its
     acceptance
  10. one periodic 10-step block with the kernels and one with the plain
     versions (make_vmc_block(fused=False): the plain sweep, the orbitals
     without K3 and K6), timed in turns,
     then one kernel block under torch.profiler as in phase 5
  11. the periodic DMC path through the entry points: diamond_setup(500)
     on the default device + rundmc(), 5 blocks x 10 steps at tstep 0.02
     after 4 VMC warm-up blocks. Launch counts exactly: 40 K7-vmc (the
     warm-up), 10 K7-dmc per block, none of K1, K2, K4, K5 (the T-move
     sweep stays plain on a lattice, as in the JAX package), K6 and K3 as
     each energy issues them (2 and 4) and K3 once per electron per
     T-move sweep (the dense quadrature's ratios). Every energy and weight
     finite; each block's mean weight within a factor of 2 of the weight
     that its e_trial and its energy predict (`predicted_weights`: the
     weights rise while e_trial lags the energy's fall from the warm-up
     VMC's, beyond 2 in the JAX package's runs on this schedule, so the
     fixed window (0.5, 2) of phase 6 would reject the reference itself);
     acceptance above 0.9; the energy per primitive cell of the last 3
     blocks within max(5 x combined SEM, 0.02 Ha) of the JAX package's CPU
     reference on the same schedule (tools/diamond_dmc_jax_reference.py)
     and not above the warm-up VMC energy per cell by more than 0.02 Ha
  12. the T-move sweep of one step alone (CUDA events), then one periodic
     10-step DMC block with the plain versions (make_dmc_block(fused=False))
     and one with the kernels, timed in turns, then one kernel block under
     torch.profiler as in phase 5

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
DMC_TSTEP = 0.02
DMC_NSTEPS = 10
DMC_NBLOCKS = 6
DMC_WARMUP = 5
TMOVE_BIG_TAU = 0.5
DIAMOND_NCONF = 500
DIAMOND_NSTEPS = 10
DIAMOND_NBLOCKS = 8
DIAMOND_NLAST = 4  # blocks averaged for the energy check
DIAMOND_NCELL = 8  # primitive cells in the 2x2x2 supercell
# tools/diamond_jax_reference.py on the CPU, float64 (see PERF.md)
DIAMOND_REF = {"e_cell": -10.182775221948061, "sem": 0.007186578622671951,
               "acceptance": 0.6213392469618056}  # 128 walkers, 36 x 10 steps after 4 blocks
PBC_DMC_BIG_TSTEP = 0.5
DIAMOND_DMC_WARMUP = 4  # rundmc's VMC warm-up blocks (10 steps at tstep 0.5)
DIAMOND_DMC_NBLOCKS = 5
DIAMOND_DMC_NLAST = 3  # blocks averaged for the energy check
# tools/diamond_dmc_jax_reference.py 32 6 5 4 3 3 on the CPU, float64, the
# same schedule: 6 runs of 32 walkers, E/cell of the last 3 blocks, its
# standard error over the runs, and each block's mean weight (geometric
# mean over the runs; printed, not checked) (see PERF.md)
DIAMOND_DMC_REF = {"e_cell": -10.910391419065506, "sem": 0.04079764409454735,
                   "e_vmc_cell": -10.153945381096266, "acceptance": 0.9872368706597223,
                   "weights": [1.4012, 2.8029, 4.4290, 5.6434, 6.4479]}
# H2O energies (phase 3: E of the last 2 VMC blocks; phase 6: E of the last
# 3 DMC blocks). With the one-thread-per-walker K1, K4 and K5 the float32
# chains gave these bits on every card; the lane-group kernels sum in other
# orders, so the chains left them, and the energies must lie within 3
# combined standard errors of them:
H2O_VMC_E_ONE_THREAD = -16.987856
H2O_DMC_E_ONE_THREAD = -17.221627
# and the lane-group kernels' chains, to 1e-4 Ha (bit for bit so far), so
# that work on other paths cannot move them unnoticed:
H2O_VMC_E = -16.987946
H2O_DMC_E = -17.221626
BLOCK_CHECK_NCONF = 512  # walkers of phase 2's float64 blocks (a power of 2: exact means)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores, data sheet


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


def cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree.to(dtype)


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


# --- the kernels' bounds --------------------------------------------------------

def kernel_bounds(wf, ecp_acc, nconf, accepted, itemsize=4):
    """{kernel: (bytes, operations)} of one launch at `nconf` walkers.

    Bytes: every input read once and every output written once (state
    columns, random streams, tables, per-walker results); scratch that a
    kernel writes and reads back itself is not counted. Operations: the
    floating-point operations of the arithmetic in csrc/ (an add, multiply,
    divide, compare-and-select, sqrt, exp or log counts one; a
    multiply-add two), for the primitives, channels and bases this system
    has. The work that depends on the data is counted from this run:
    `accepted` {kernel: accepted moves in the compared launch}; a rejected
    move skips the Sherman-Morrison and cache update, a walker that stays
    skips the T-move's last AO pass.
    """
    slater, jastrow = wf.wfs
    nup, ndn = slater.nup, slater.ndn
    nelec, n = nup + ndn, max(nup, ndn)
    spec = slater.orbitals.spec

    def ao_ops(grad, sink_per_row):
        total = 0
        for g in spec.groups:
            l = g.l
            comps = [(i, j, l - i - j) for i in range(l, -1, -1) for j in range(l - i, -1, -1)]
            nc, ns = len(comps), 2 * l + 1
            nonzero = sum(1 for c in comps for x in c if x > 0)
            for coef in g.coef:
                prims = int(np.count_nonzero(coef))
                ops = 8 + prims * (6 if grad else 4) + 3 * l + 3 * nc + 2 * nc * ns
                if grad:
                    ops += 5 * nc + 5 * nonzero + 6 * nc * ns
                total += ops + ns * sink_per_row
        return total

    basis_ops = {("polypade", False): 12, ("polypade", True): 22,
                 ("cutoffcusp", False): 15, ("cutoffcusp", True): 20}

    def jastrow_ops(grad):
        per_term = 2 + (7 if grad else 0)
        a = sum(basis_ops[(b.kind, grad)] + per_term for b in jastrow.a_basis)
        b = sum(basis_ops[(b.kind, grad)] + per_term for b in jastrow.b_basis)
        return jastrow.natom * (9 + a) + (nelec - 1) * (9 + b)

    legendre_ops = {0: 0, 1: 0, 2: 3, 3: 5, 4: 7, 5: 10, 6: 12}

    def quad_ops(per_point):
        """One electron's quadrature: per atom the radial channels, per
        point the rotation, position, cos(theta), projectors and `per_point`."""
        total = 0
        for a, naip in zip(ecp_acc.nl_atoms, ecp_acc.atom_naip):
            chans = a.nonlocal_channels
            total += 9 + sum(2 + sum(6 + abs(p - 2) for p in ch.powers) for ch in chans)
            total += naip * (15 + 6 + 6 + 1 + sum(legendre_ops[ch.l] + 2 for ch in chans)
                             + per_point)
        return total

    update_ops = 2 * n * n + n * (3 * (n - 1) + 1) + 4 + 1  # Sherman-Morrison, phase, U
    nq = ecp_acc.nq_total
    nao = spec.nao
    rows = 3 * nelec + nup * nup + ndn * ndn + 4 + 4 * nup * nup + 4 * ndn * ndn + 1
    tab_bytes = wf_tables_bytes(wf, ecp_acc, itemsize)
    out = {}
    for name, dmc in (("vmc_sweep", False), ("dmc_sweep", True)):
        move = (8 * n + 3 + 2 * (jastrow_ops(True) + 3) + 2 * (14 if dmc else 10) + 6
                + ao_ops(True, 8 * n) + 8 * n + 3 + 3 + 3 + 5 + 9 + 5 + 4 + 2 + 1
                + (13 if dmc else 0))
        ops = nconf * nelec * move + accepted[name] * update_ops
        rows_io = 2 * rows + 3 * nelec + nelec + (3 if dmc else 1)
        out[name] = (rows_io * nconf * itemsize + tab_bytes, ops)
    point = ao_ops(False, 2) + jastrow_ops(False) + 3 + 2
    per_electron = 2 * nao * n + jastrow_ops(False) + quad_ops(point) + 1
    out["ecp_energy"] = ((3 * nelec + nup * nup + ndn * ndn + 9 * nelec + 1) * nconf * itemsize
                         + wf_tables_bytes(wf, ecp_acc, itemsize), nconf * nelec * per_electron)
    point = ao_ops(False, 2 * n) + 2 * n + jastrow_ops(False) + 3 + 1 + 3
    per_electron = jastrow_ops(False) + quad_ops(point) + 1 + 1 + 5 * nq
    moved = (5 * nq + 3 + 9 + 21 + jastrow_ops(False) + ao_ops(True, 8 * n) + update_ops + 2)
    out["tmove_sweep"] = ((2 * rows + 9 * nelec + 2 * nelec) * nconf * itemsize + tab_bytes,
                          nconf * nelec * per_electron + accepted["tmove_sweep"] * moved)
    return out


def wf_tables_bytes(wf, ecp_acc, itemsize):
    from pyqmc_tpu_torch.ops.move_sweep import SJTables

    t = SJTables(*wf.wfs, ecp_acc=ecp_acc)
    return t.ntab * itemsize + 4 * len(t._meta)


def bound_ms(nbytes, ops):
    """(the least milliseconds the card could take, what bounds it)."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# --- phase 2: kernels against their plain versions ------------------------------

def path_conds(wf, params, pos, pos_new):
    """Per walker and spin, the largest condition number of the orbital
    matrices along a sweep from pos to pos_new (after move k the first k
    electrons sit at their new positions), from float64 orbital values (the
    value rows of the state's orbital cache); and the exact (float64) state
    at pos_new."""
    p64 = cast_tree(params, torch.float64)
    slater = wf.wfs[0]
    nup = slater.nup
    conds = {"up": [], "dn": []}
    for k in range(pos.shape[1] + 1):
        x = torch.cat([pos_new[:, :k], pos[:, k:]], dim=1).double()
        mo_up, mo_dn = slater.orbitals.eval(p64["wf0"], x, 0)
        conds["up"].append(torch.linalg.cond(mo_up[:, :nup]))
        conds["dn"].append(torch.linalg.cond(mo_dn[:, nup:]))
    sl_mid = wf.recompute(p64, pos_new.double())[0]
    return {k: torch.amax(torch.stack(v), dim=0).reshape(-1) for k, v in conds.items()}, sl_mid


def compare_sweeps(label, dtype, wf, params, pos, out_k, out_p, extras=(), exact=None):
    """One sweep's kernel output against its plain version's: (positions,
    state) pairs, plus `extras`, per-walker tensors as (name, kernel,
    plain). Returns the measured numbers; raises on disagreement.

    exact: the plain version's float64 output from the same inputs as
    (positions, state, [each extra]), or None. Given it, the float32
    leaves other than the inverses are held to
    it instead of to 1e-4 of the plain float32 version: over the walkers
    whose decisions agree in all three runs, each leaf's largest error
    (over 1 + |exact|) of the kernel must be at most 3 times the plain
    version's plus 1e-5; the walkers where the kernel's own error exceeds
    that bound are counted. The inverses are held to 1e-4 x max(1,
    cond/100) either way."""
    (pk, sk), (pp, sp) = out_k, out_p
    moved_k = torch.any(pk != pos, dim=-1)
    moved_p = torch.any(pp != pos, dim=-1)
    differ = torch.any(moved_k != moved_p, dim=1)  # (nconf,)
    ndiff = int(torch.sum(differ))
    res = {"accepted_moves": int(torch.sum(moved_k)),
           "walkers_moved": int(torch.sum(torch.any(moved_k, dim=1))),
           "walkers_with_flipped_accepts": ndiff}
    if dtype == torch.float64:
        check(ndiff == 0, f"f64 {label}: {ndiff} walkers with differing accepts")
        worst = 0.0
        for a, b in zip([pk] + leaves(sk) + [e[1] for e in extras],
                        [pp] + leaves(sp) + [e[2] for e in extras]):
            err = torch.abs(a - b)
            worst = max(worst, float(torch.max(err)))
            # 1e-9 absolute, and relative for inverse entries near a node
            check(bool(torch.all(err <= 1e-9 * (1 + torch.abs(b)))),
                  f"f64 {label}: state differs, max abs err {float(torch.max(err)):.3e}")
        res["max_abs_err"] = worst
        return res
    check(ndiff <= 0.01 * pos.shape[0], f"f32 {label}: {ndiff} walkers with differing accepts")
    agree = ~differ
    # The inverses are updated move by move (Sherman-Morrison), so their
    # float32 error follows the largest condition number of the orbital
    # matrices along the sweep. Those matrices, and the exact final
    # inverses, come from float64 recomputes.
    conds, sl_mid = path_conds(wf, params, pos, pp)
    cond_w = torch.maximum(conds["up"], conds["dn"])
    sl_k, j_k = sk
    sl_p, j_p = sp
    names = ["positions", "phase_up", "phase_dn", "logdet_up", "logdet_dn", "u", "mog_up",
             "mog_dn"] + [e[0] for e in extras]
    pairs = [(pk, pp), (sl_k.phase_up, sl_p.phase_up), (sl_k.phase_dn, sl_p.phase_dn),
             (sl_k.logdet_up, sl_p.logdet_up), (sl_k.logdet_dn, sl_p.logdet_dn), (j_k.u, j_p.u),
             (sl_k.mog_up, sl_p.mog_up), (sl_k.mog_dn, sl_p.mog_dn)]
    pairs += [(e[1], e[2]) for e in extras]
    if exact is not None:
        px, sx, extras_x = exact
        sl_x, j_x = sx
        xs = [px, sl_x.phase_up, sl_x.phase_dn, sl_x.logdet_up, sl_x.logdet_dn, j_x.u,
              sl_x.mog_up, sl_x.mog_dn] + list(extras_x)
        agree3 = agree & ~torch.any(torch.any(px != pos.double(), dim=-1) != moved_k, dim=1)
        res["walkers_agreeing_with_float64"] = int(torch.sum(agree3))
    nconf = pos.shape[0]
    worst = 0.0
    for i, (name, (a, b)) in enumerate(zip(names, pairs)):
        err = (torch.abs(a - b).reshape(nconf, -1).double()
               / (1 + torch.abs(b).reshape(nconf, -1).double())).amax(dim=1)
        err = torch.where(agree, err, torch.zeros_like(err))
        worst = max(worst, float(torch.max(torch.abs(a - b)[agree])))
        if exact is None:
            check(bool(torch.all(err <= 1e-4)),
                  f"f32 {label}: agreeing walkers' {name} differ by {float(torch.max(err)):.3e}")
            continue

        def vs_exact(v):
            x = xs[i].double().reshape(nconf, -1)
            e = (torch.abs(v.double().reshape(nconf, -1) - x) / (1 + torch.abs(x))).amax(dim=1)
            return torch.where(agree3, e, torch.zeros_like(e))

        ek, ep = vs_exact(a), vs_exact(b)
        w = int(torch.argmax(err))
        res[name] = {"max_err_over_1_plus_abs": float(err[w]), "path_cond_there": float(cond_w[w]),
                     "kernel_max_err_vs_float64": float(torch.max(ek)),
                     "plain_max_err_vs_float64": float(torch.max(ep)),
                     "walkers_kernel_err_above_3_plain_plus_1e-5": int(torch.sum(
                         ek > 3 * ep + 1e-5))}
        check(res[name]["kernel_max_err_vs_float64"]
              <= 3 * res[name]["plain_max_err_vs_float64"] + 1e-5,
              f"f32 {label}: agreeing walkers' {name} farther from float64 than 3 x the plain "
              f"version's error + 1e-5: {json.dumps(res[name])}")
    res["max_abs_err"] = worst
    for spin, inv_k, inv_p, inv_x in [("up", sl_k.inv_up, sl_p.inv_up, sl_mid.inv_up),
                                      ("dn", sl_k.inv_dn, sl_p.inv_dn, sl_mid.inv_dn)]:
        cond = conds[spin]

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
            "max_norm_rel_err_path_cond_le_100": (
                float(torch.max(rel[agree & (cond <= 100)]))
                if bool(torch.any(agree & (cond <= 100))) else None),
            "max_norm_rel_err_over_path_cond": float(torch.max((rel / cond)[agree])),
            "walkers_path_cond_gt_100": int(torch.sum(cond > 100)),
            "median_path_cond": float(torch.median(cond))}
        bound = 1e-4 * torch.clamp(cond / 100, min=1.0)
        bad = agree & ~(rel <= bound)
        check(not bool(torch.any(bad)),
              f"f32 {label}: {int(torch.sum(bad))} agreeing walkers' {spin} inverses differ "
              f"beyond 1e-4 * max(1, cond/100): {json.dumps(res[f'inverse_{spin}'])}")
    return res


def compare_kernels(dtype):
    """Phase 2 for one dtype: all four kernels. Returns the measured numbers."""
    from pyqmc_tpu_torch.configs import Geometry
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.observables.energy import kinetic_energy
    from pyqmc_tpu_torch.ops.ecp_energy import build_fused_ecp_energy
    from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep
    from pyqmc_tpu_torch.ops.tmove_sweep import build_fused_tmove_sweep

    mol, wf, params, configs, acc = h2o_setup(NCONF, device="cuda", dtype=dtype, seed=11)
    params = randomize_jastrow(params, 12)
    pos, wrap = configs.positions, configs.wrap
    nelec = pos.shape[1]
    state = wf.recompute(params, pos)
    gen = torch.Generator(device="cuda").manual_seed(13)
    streams = draw_streams(gen, 1, nelec, NCONF, TSTEP, pos.device, dtype)
    gauss, unif, rot = streams["gauss"][0], streams["unif"][0], streams["rot"][0]
    dstreams = draw_dmc_streams(gen, 1, nelec, NCONF, DMC_TSTEP, pos.device, dtype)
    dgauss, dunif = dstreams["gauss"][0], dstreams["unif"][0]
    tqrot, u_sel, u_acc = dstreams["tqrot"][0], dstreams["u_sel"][0], dstreams["u_acc"][0]
    ecp_acc = acc["energy"].ecp_acc
    sweep = build_fused_sweep(wf, Geometry(), TSTEP)
    dsweep = build_fused_sweep(wf, Geometry(), DMC_TSTEP, mode="dmc")
    tmove = build_fused_tmove_sweep(wf, Geometry(), ecp_acc, DMC_TSTEP)
    tmove_big = build_fused_tmove_sweep(wf, Geometry(), ecp_acc, TMOVE_BIG_TAU)
    ecp = build_fused_ecp_energy(wf, ecp_acc)
    check(None not in (sweep, dsweep, tmove, tmove_big, ecp),
          "main path is outside the kernels' gates")
    res = {}

    # K2, the ECP energy
    ek = ecp.kernel(params, pos, state, rot)
    ep = ecp.plain(params, pos, state, rot)
    torch.cuda.synchronize()
    scale = float(torch.mean(torch.abs(ep)))
    ecp_err = torch.abs(ek - ep)
    res["ecp_energy"] = {"max_abs_err": float(torch.max(ecp_err))}
    # rtol with an absolute floor at the mean magnitude for walkers whose
    # channels cancel to ~0
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    check(bool(torch.all(ecp_err <= tol * (torch.abs(ep) + scale))),
          f"{dtype} ECP energy differs: max abs err {res['ecp_energy']['max_abs_err']:.3e}")

    # K1, the vmc sweep
    pk, _, sk, acck = sweep.kernel(params, pos, wrap, state, gauss, unif)
    pp, _, sp, accp = sweep.plain(params, pos, wrap, state, gauss, unif)
    res["vmc_sweep"] = compare_sweeps("vmc sweep", dtype, wf, params, pos, (pk, sk), (pp, sp))
    res["vmc_sweep"]["acceptance"] = float(acck) / nelec
    if dtype == torch.float64:
        check(float(acck) == float(accp), f"f64 vmc acceptance {float(acck)} != {float(accp)}")

    # K4, the dmc sweep
    pk, _, sk, (acck, r2pk, r2ak) = dsweep.kernel(params, pos, wrap, state, dgauss, dunif)
    pp, _, sp, (accp, r2pp, r2ap) = dsweep.plain(params, pos, wrap, state, dgauss, dunif)
    res["dmc_sweep"] = compare_sweeps("dmc sweep", dtype, wf, params, pos, (pk, sk), (pp, sp),
                                      extras=[("r2p", r2pk, r2pp), ("r2a", r2ak, r2ap)])
    res["dmc_sweep"]["acceptance"] = float(acck) / nelec
    res["dmc_sweep"]["mean_tdamp"] = float(torch.mean(r2ak / r2pk))
    if dtype == torch.float64:
        check(float(acck) == float(accp), f"f64 dmc acceptance {float(acck)} != {float(accp)}")

    # K5, the T-move sweep, at the main path's tau and at a large one
    for name, fn in (("tmove_sweep", tmove), ("tmove_sweep_big_tau", tmove_big)):
        pk, _, sk = fn.kernel(params, pos, wrap, state, tqrot, u_sel, u_acc)
        pp, _, sp = fn.plain(params, pos, wrap, state, tqrot, u_sel, u_acc)
        res[name] = compare_sweeps(f"T-move sweep tau={fn.tau}", dtype, wf, params, pos,
                                   (pk, sk), (pp, sp))
        res[name]["tau"] = fn.tau
        res[name]["share_of_walkers_taking_a_tmove"] = res[name]["walkers_moved"] / NCONF
    check(res["tmove_sweep_big_tau"]["walkers_moved"] >= 0.02 * NCONF,
          f"only {res['tmove_sweep_big_tau']['walkers_moved']} walkers took a T-move at "
          f"tau {TMOVE_BIG_TAU}: the comparison would show nothing")
    if dtype == torch.float64:
        return res

    # times at the main path's shapes, float32
    calls = {
        "vmc_sweep": (sweep, (params, pos, wrap, state, gauss, unif)),
        "ecp_energy": (ecp, (params, pos, state, rot)),
        "dmc_sweep": (dsweep, (params, pos, wrap, state, dgauss, dunif)),
        "tmove_sweep": (tmove, (params, pos, wrap, state, tqrot, u_sel, u_acc)),
    }
    for name, (fn, args) in calls.items():
        res[name]["ms"] = cuda_ms(lambda: fn.kernel(*args), 20)
        res[name]["plain_ms"] = cuda_ms(lambda: fn.plain(*args), 5)
    accepted = {k: res[k]["accepted_moves"] for k in ("vmc_sweep", "dmc_sweep", "tmove_sweep")}
    for name, (nbytes, ops) in kernel_bounds(wf, ecp_acc, NCONF, accepted).items():
        ms, by = bound_ms(nbytes, ops)
        res[name].update({"bytes": nbytes, "operations": ops, "bound_ms": ms, "bound_by": by})
    res["redesigned"] = redesigned_times(wf, Geometry(), res, calls)
    # the rest of a step, plain PyTorch on the main path
    res["kinetic_ms"] = cuda_ms(lambda: kinetic_energy(wf, params, state, pos), 5)
    res["coulomb_ms"] = cuda_ms(lambda: acc["energy"].coulomb.energy(pos), 5)
    return res


class StateProbe:
    """An accumulator that keeps a copy of the state leaves after every
    step (make_vmc_block calls .avg, make_dmc_block the object itself); it
    adds no averages."""

    def __init__(self):
        self.steps = []

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        self.steps.append([t.clone() for t in leaves(state)])
        return {}

    __call__ = avg


def compare_blocks():
    """Phase 2's float64 blocks: a 10-step VMC block (K1, K2), then from its
    walkers a 10-step DMC block with T-moves (K4, K5, K2), each with the
    kernels and with the plain versions (fused=False and a plain ECP
    energy) on the same streams, BLOCK_CHECK_NCONF walkers. Returns the
    measured numbers; raises on disagreement."""
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams, make_dmc_block
    from pyqmc_tpu_torch.method.vmc import draw_streams, make_vmc_block
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
    from pyqmc_tpu_torch.ops import ecp_energy, move_sweep, tmove_sweep

    dtype, nconf, nsteps = torch.float64, BLOCK_CHECK_NCONF, 10
    mol, wf, params, configs, acc = h2o_setup(nconf, device="cuda", dtype=dtype, seed=11)
    params = randomize_jastrow(params, 12)
    nelec = configs.positions.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(19)
    energy = {True: acc["energy"],
              False: EnergyAccumulator(mol, ecp_acc=ECPAccumulator(mol, fused=False))}
    counters = {"vmc_sweep": move_sweep.LAUNCHES, "dmc_sweep": move_sweep.DMC_LAUNCHES,
                "tmove_sweep": tmove_sweep.LAUNCHES, "ecp_energy": ecp_energy.LAUNCHES}

    def both(label, run, launches):
        """run(fused, probe) -> (positions, wrap, [weights,] averages), with
        the kernels and plain; every output held to the other's."""
        out = {}
        for fused in (True, False):
            before = {k: c.n for k, c in counters.items()}
            probe = StateProbe()
            out[fused] = (run(fused, probe), probe.steps)
            n = {k: c.n - before[k] for k, c in counters.items()}
            want = launches if fused else {k: 0 for k in counters}
            check(n == {**{k: 0 for k in counters}, **want},
                  f"f64 {label} block ({'kernels' if fused else 'plain'}) launched {n}")
        (ko, ksteps), (po, psteps) = out[True], out[False]
        *kt, kavg = ko
        *pt, pavg = po
        check(torch.equal(kt[1], pt[1]), f"f64 {label} block: wrap counts differ")
        pairs = [(kt[0], pt[0])] + ([(kt[2], pt[2])] if len(kt) > 2 else [])
        pairs += [(a, b) for ka, pa in zip(ksteps, psteps) for a, b in zip(ka, pa)]
        pairs += [(kavg[k], pavg[k]) for k in sorted(kavg) if k != "acceptance"]
        worst = 0.0
        for a, b in pairs:
            err = torch.abs(a - b)
            worst = max(worst, float(torch.max(err)))
            check(bool(torch.all(err <= 1e-9 * (1 + torch.abs(b)))),
                  f"f64 {label} block: kernels and plain differ by {float(torch.max(err)):.3e}")
        check(float(kavg["acceptance"]) == float(pavg["acceptance"]),
              f"f64 {label} block acceptance {float(kavg['acceptance'])} != "
              f"{float(pavg['acceptance'])}")
        return ko, {"max_abs_err": worst, "steps": len(ksteps),
                    "acceptance": float(kavg["acceptance"]),
                    "energytotal": float(kavg["energytotal"])}

    res = {"walkers": nconf}
    vst = draw_streams(gen, nsteps, nelec, nconf, TSTEP, "cuda", dtype)

    def vmc_run(fused, probe):
        block = make_vmc_block(wf, {"energy": energy[fused], "probe": probe}, configs.geometry,
                               TSTEP, nsteps, fused=fused)
        return block(params, configs.positions, configs.wrap, gen, streams=vst)

    (pos, wrap, vavg), res["vmc_block"] = both(
        "VMC", vmc_run, {"vmc_sweep": nsteps, "ecp_energy": nsteps})
    dst = draw_dmc_streams(gen, nsteps, nelec, nconf, DMC_TSTEP, "cuda", dtype)
    e_trial = float(vavg["energytotal"])
    weights = torch.ones(nconf, dtype=dtype, device="cuda")

    def dmc_run(fused, probe):
        block, _ = make_dmc_block(wf, energy[fused], configs.geometry, DMC_TSTEP, nsteps,
                                  accumulators={"probe": probe}, fused=fused)
        return block(params, pos, wrap, weights, gen, e_trial, e_trial, 0.5, streams=dst)

    (dpos, _, _, _), res["dmc_block"] = both(
        "DMC", dmc_run, {"dmc_sweep": nsteps, "tmove_sweep": nsteps, "ecp_energy": nsteps + 1})
    res["dmc_block"]["walkers_moved_by_tmoves_or_drift"] = int(torch.sum(torch.any(
        (dpos != pos).reshape(nconf, -1), dim=1)))
    return res


# --- phase 8: the periodic kernels against their plain versions ------------------

def ao_shell_ops(spec, mode):
    """Floating-point operations of one point's AO evaluation in
    csrc/ao_shell.cuh:shell_one (mode 0 values, 1 with gradients, 2 with
    laplacians), counted as in kernel_bounds."""
    total = 0
    for g in spec.groups:
        l = g.l
        comps = [(i, j, l - i - j) for i in range(l, -1, -1) for j in range(l - i, -1, -1)]
        nc, ns = len(comps), 2 * l + 1
        nonzero = sum(1 for c in comps for x in c if x > 0)
        for coef in g.coef:
            prims = int(np.count_nonzero(coef))
            ops = 8 + prims * (4 + 2 * mode) + 3 * l + 3 * nc + 2 * nc * ns
            if mode >= 1:
                ops += 5 * nc + 5 * nonzero + 6 * nc * ns
            if mode >= 2:
                ops += 8 * nc + 6 * nonzero + 2 * nc * ns
            total += ops
    return total


def kernel_bounds_pbc(wf, geometry, nconf, accepted, m_value_mo, m_gto_eval, itemsize=4):
    """{kernel: (bytes, operations)} of one launch of K7 (both modes), K3
    and K6 at the diamond shapes: every input read once, every output
    written once; K7's Sherman-Morrison counted for this run's accepted
    moves, `accepted` {"pbc_sweep": n, "pbc_dmc_sweep": n}. The dmc mode
    adds per move Umrigar's drift limit in place of the cap (twice), the
    node test, and the squared displacement with its two sums; per walker
    it writes r2p and r2a."""
    from pyqmc_tpu_torch.ops.gto_kernels import GTOTables
    from pyqmc_tpu_torch.ops.move_sweep_pbc import PBCTables

    slater, jastrow = wf.wfs
    orb = slater.orbitals
    spec = orb._repl_spec
    nup, ndn = slater.nup, slater.ndn
    nelec, n, nao, ntot = nup + ndn, max(nup, ndn), spec.nao, nup + ndn
    g = GTOTables(spec)
    gtab = g._tab.size * itemsize + 4 * g._meta.size
    t = PBCTables(geometry, slater, jastrow, orb)
    ptab = t.ntab * itemsize + 4 * t._meta.size
    out = {}
    out["value_mo"] = ((3 + ntot) * m_value_mo * itemsize + nao * ntot * itemsize + gtab,
                       m_value_mo * (ao_shell_ops(spec, 0) + 2 * nao * ntot))
    out["gto_eval"] = ((3 + 5 * nao) * m_gto_eval * itemsize + gtab,
                       m_gto_eval * ao_shell_ops(spec, 2))
    basis_ops = {"polypade": 22, "cutoffcusp": 20}
    jas = (jastrow.natom * (9 + 9 + sum(basis_ops[b.kind] + 9 for b in jastrow.a_basis))
           + (nelec - 1) * (9 + 9 + sum(basis_ops[b.kind] + 9 for b in jastrow.b_basis)))
    move = (8 * n + 2 * jas + 2 * 10 + 27 * 4 + 9 + n * (5 + ao_shell_ops(spec, 1) / n
                                                         + 8 * nao) + 8 * n + 30)
    update = 2 * n * n + 3 * n * n + 4 * n + 6
    rows = 3 * nelec + nup * nup + ndn * ndn + 4 + 4 * nup * nup + 4 * ndn * ndn + 1
    for name, dmc in (("pbc_sweep", False), ("pbc_dmc_sweep", True)):
        # Umrigar's limit (15 per call, the cap 10), the node test, r2
        # (|gauss + tau drift_old|^2: 11) and its two sums
        extra = 2 * (15 - 10) + 1 + 11 + 2 if dmc else 0
        out[name] = ((2 * rows + 3 * nelec + nelec + 3 * nelec + (3 if dmc else 1)) * nconf
                     * itemsize + nao * ntot * itemsize + ptab,
                     int(nconf * nelec * (move + extra) + accepted[name] * update))
    return out


def all_plain(fn):
    """fn with the orbitals evaluated without K3 and K6: a plain version
    throughout."""
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals

    def run(*args):
        with plain_orbitals():
            return fn(*args)

    return run


def close_rel(label, k, p, tol):
    """|k - p| <= tol (|p| + max |p|) entrywise; returns the max abs error."""
    err = torch.abs(k - p)
    scale = float(torch.max(torch.abs(p)))
    check(bool(torch.all(err <= tol * (torch.abs(p) + scale))),
          f"{label}: max abs err {float(torch.max(err)):.3e} (max |plain| {scale:.3e})")
    return float(torch.max(err))


def compare_pbc_kernels(dtype):
    """Phase 8 for one dtype: K7, K6 and K3 at the diamond shapes, K3 at
    H2O's. Returns the measured numbers."""
    from pyqmc_tpu_torch.entry import diamond_setup, h2o_setup
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.observables.ecp import systematic_downselect
    from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep

    sup, wf, params, configs, acc = diamond_setup(DIAMOND_NCONF, device="cuda", dtype=dtype,
                                                  seed=21)
    params = randomize_jastrow(params, 22)
    pos, wrap = configs.positions, configs.wrap
    nelec = pos.shape[1]
    orb = wf.wfs[0].orbitals
    state = wf.recompute(params, pos)
    gen = torch.Generator(device="cuda").manual_seed(23)
    streams = draw_streams(gen, 1, nelec, DIAMOND_NCONF, TSTEP, pos.device, dtype,
                           downselect=True)
    gauss, unif = streams["gauss"][0], streams["unif"][0]
    sweep = build_fused_sweep(wf, configs.geometry, TSTEP)
    check(type(sweep).__name__ == "FusedSweepPBC", "the diamond wavefunction is outside K7's gate")
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    res = {}

    # K7, the periodic sweep
    sweep_plain = all_plain(sweep.plain)
    pk, wk, sk, acck = sweep.kernel(params, pos, wrap, state, gauss, unif)
    pp, wp, sp, accp = sweep_plain(params, pos, wrap, state, gauss, unif)
    exact = None
    if dtype == torch.float32:  # the plain version in float64 from the same inputs
        p64 = cast_tree(params, torch.float64)
        px, wx, sx, _ = sweep_plain(p64, pos.double(), wrap, wf.recompute(p64, pos.double()),
                                    gauss.double(), unif.double())
        exact = (px, sx, [wx])
    torch.cuda.synchronize()
    res["pbc_sweep"] = compare_sweeps("periodic sweep", dtype, wf, params, pos, (pk, sk), (pp, sp),
                                      extras=[("wrap", wk.to(dtype), wp.to(dtype))], exact=exact)
    res["pbc_sweep"]["acceptance"] = float(acck) / nelec
    res["pbc_sweep"]["walkers_with_a_wrap"] = int(torch.sum(torch.any(
        (wk != wrap).reshape(DIAMOND_NCONF, -1), dim=1)))
    if dtype == torch.float64:  # the same count of accepted moves (means summed in two orders)
        check(abs(float(acck) - float(accp)) * DIAMOND_NCONF < 0.5,
              f"f64 periodic acceptance {float(acck)} != {float(accp)}")

    # K7's dmc mode, at DMC's tstep and at a large one where moves wrap and
    # cross nodes often; there the first half of the walkers gets unif = 0,
    # so that every move of theirs that is rejected is rejected by the node
    for name, tau in (("pbc_dmc_sweep", DMC_TSTEP), ("pbc_dmc_sweep_big_tstep", PBC_DMC_BIG_TSTEP)):
        dsweep = build_fused_sweep(wf, configs.geometry, tau, mode="dmc")
        dst = draw_streams(gen, 1, nelec, DIAMOND_NCONF, tau, pos.device, dtype)
        dgauss, dunif = dst["gauss"][0], dst["unif"][0].clone()
        half = DIAMOND_NCONF // 2
        if tau != DMC_TSTEP:
            dunif[:, :half] = 0.0
        dplain = all_plain(dsweep.plain)
        pk, wk, sk, (acck, r2pk, r2ak) = dsweep.kernel(params, pos, wrap, state, dgauss, dunif)
        pp, wp, sp, (accp, r2pp, r2ap) = dplain(params, pos, wrap, state, dgauss, dunif)
        exact = None
        if dtype == torch.float32:
            p64 = cast_tree(params, torch.float64)
            px, wx, sx, (_, r2px, r2ax) = dplain(p64, pos.double(), wrap,
                                                 wf.recompute(p64, pos.double()),
                                                 dgauss.double(), dunif.double())
            exact = (px, sx, [wx, r2px, r2ax])
        torch.cuda.synchronize()
        res[name] = compare_sweeps(
            f"periodic dmc sweep tstep={tau}", dtype, wf, params, pos, (pk, sk), (pp, sp),
            extras=[("wrap", wk.to(dtype), wp.to(dtype)), ("r2p", r2pk, r2pp),
                    ("r2a", r2ak, r2ap)], exact=exact)
        moved = torch.any(pk != pos, dim=-1)
        res[name].update({
            "tstep": tau, "acceptance": float(acck) / nelec,
            "moves_wrapped": int(torch.sum(torch.any(wk != wrap, dim=-1))),
            "mean_tdamp": float(torch.mean(r2ak / r2pk))})
        if tau != DMC_TSTEP:
            res[name]["node_rejections_of_the_walkers_with_unif_0"] = int(
                torch.sum(~moved[:half]))
            check(res[name]["node_rejections_of_the_walkers_with_unif_0"] > 0
                  and res[name]["moves_wrapped"] > 0,
                  f"tstep {tau}: no node rejection or no wrap to compare: {json.dumps(res[name])}")
        if dtype == torch.float64:
            check(abs(float(acck) - float(accp)) * DIAMOND_NCONF < 0.5,
                  f"f64 periodic dmc acceptance {float(acck)} != {float(accp)}")
        if name == "pbc_dmc_sweep":
            dmc_call = (dsweep, dplain, (params, pos, wrap, state, dgauss, dunif))

    # K6 at one kinetic-energy chunk: 32 electrons x 500 walkers
    chunk = max(1, 16384 // DIAMOND_NCONF)
    X6, _ = orb._fold(pos[:, :chunk].reshape(-1, 3))
    ev2 = orb._eval2
    out_k, out_p = ev2.kernel(X6), ev2.plain(X6)
    res["gto_eval"] = {"points": X6.shape[0], "max_abs_err": max(
        close_rel(f"{dtype} K6 {name}", a, b, tol)
        for name, a, b in zip(("ao", "grad", "lap"), out_k, out_p))}

    # K3 at one ECP chunk: 21 electrons x 500 walkers x 24 selected points
    ecp = acc["energy"].ecp_acc
    k3 = 262144 // (DIAMOND_NCONF * ecp.nselect)
    aux, T = ecp.quadrature_geometry(pos[:, :k3].transpose(0, 1), streams["rot"][0][:k3])
    idx, _ = systematic_downselect(T, ecp.nselect, streams["u_sel"][0][:k3])
    aux = torch.gather(aux, 2, idx[..., None].expand(*idx.shape, 3)).reshape(-1, 3)
    X3, _ = orb._fold(aux)
    R = orb._folded_coeff(params["wf0"], dtype)
    vm = orb._value_mo
    res["value_mo"] = {"points": X3.shape[0], "max_abs_err": close_rel(
        f"{dtype} K3", vm.kernel_t(X3, R), vm.plain_t(X3, R), tol)}

    # K3 at H2O's 23 AOs, on its ECP points of all 8 electrons
    _, hwf, hparams, hconf, hacc = h2o_setup(NCONF, device="cuda", dtype=dtype, seed=11)
    hgen = torch.Generator(device="cuda").manual_seed(13)
    hst = draw_streams(hgen, 1, 8, NCONF, TSTEP, hconf.positions.device, dtype)
    hx, _ = hacc["energy"].ecp_acc.quadrature_geometry(hconf.positions.transpose(0, 1),
                                                       hst["rot"][0])
    hx = hx.reshape(-1, 3)
    hp = hparams["wf0"]
    hC = torch.cat([hp["mo_coeff_alpha"], hp["mo_coeff_beta"]], dim=1)
    hvm = hwf.wfs[0].orbitals._value_mo
    res["value_mo_h2o"] = {"points": hx.shape[0], "max_abs_err": close_rel(
        f"{dtype} K3 H2O", hvm.kernel_t(hx, hC), hvm.plain_t(hx, hC), tol)}
    if dtype == torch.float64:
        return res

    dsweep, dplain, dargs = dmc_call
    calls = {"pbc_sweep": (lambda: sweep.kernel(params, pos, wrap, state, gauss, unif),
                           lambda: sweep_plain(params, pos, wrap, state, gauss, unif), 5, 1),
             "pbc_dmc_sweep": (lambda: dsweep.kernel(*dargs), lambda: dplain(*dargs), 5, 1),
             "gto_eval": (lambda: ev2.kernel(X6), lambda: ev2.plain(X6), 10, 3),
             "value_mo": (lambda: vm.kernel_t(X3, R), lambda: vm.plain_t(X3, R), 10, 3),
             "value_mo_h2o": (lambda: hvm.kernel_t(hx, hC), lambda: hvm.plain_t(hx, hC), 20, 5)}
    for name, (kern, plain, nk, np_) in calls.items():
        res[name]["ms"] = cuda_ms(kern, nk)
        res[name]["plain_ms"] = cuda_ms(plain, np_)
    accepted = {k: res[k]["accepted_moves"] for k in ("pbc_sweep", "pbc_dmc_sweep")}
    bounds = kernel_bounds_pbc(wf, configs.geometry, DIAMOND_NCONF, accepted, X3.shape[0],
                               X6.shape[0])
    for name, (nbytes, ops) in bounds.items():
        ms, by = bound_ms(nbytes, ops)
        res[name].update({"bytes": nbytes, "operations": ops, "bound_ms": ms, "bound_by": by})
    # K3 at the T-move quadrature's size: one electron's 96 points per walker
    aux, _ = ecp.quadrature_geometry(pos[:, 0], streams["rot"][0][0])
    Xq, _ = orb._fold(aux.reshape(-1, 3))
    res["redesigned"] = redesigned_times(wf, configs.geometry, res, {
        "value_mo": (vm, (X3, R)), "value_mo_48000": (vm, (Xq, R)),
        "pbc_sweep": (sweep, (params, pos, wrap, state, gauss, unif)),
        "pbc_dmc_sweep": (dsweep, dargs)})
    # the rest of a periodic step, each piece alone (wrappers and plain ops)
    from pyqmc_tpu_torch.observables.energy import kinetic_energy

    res["kinetic_ms"] = cuda_ms(lambda: kinetic_energy(wf, params, state, pos), 3)
    res["ewald_ms"] = cuda_ms(lambda: acc["energy"].coulomb.energy(pos), 3)
    res["ecp_ms"] = cuda_ms(lambda: ecp(wf, params, state, pos, streams["rot"][0],
                                        streams["u_sel"][0]), 3)
    res["recompute_ms"] = cuda_ms(lambda: wf.recompute(params, pos), 3)
    nbytes = (3 + 8) * hx.shape[0] * 4 + 23 * 8 * 4
    ops = hx.shape[0] * (ao_shell_ops(hwf.wfs[0].orbitals.spec, 0) + 2 * 23 * 8)
    ms, by = bound_ms(nbytes, ops)
    res["value_mo_h2o"].update({"bytes": nbytes, "operations": ops, "bound_ms": ms, "bound_by": by})
    return res


def redesigned_times(wf, geometry, res, calls, reps=50):
    """The kernels redesigned for this card (K3 at 252,000 and 48,000
    points, K7 in both modes; K1, K2, K4, K5), `calls` {name: (wrapper, its
    arguments)}: the device time of one launch (CUDA events over `reps`
    launches of the C entry point, back to back after a warm-up, its
    arguments packed once), the wrapper's time (the same over wrapper
    calls, host packing included), the bound and its share of the device
    time. Returns {name: numbers}."""
    from pyqmc_tpu_torch.ops import _build

    out = {}
    for name, (fn, args) in calls.items():
        if name.startswith("value_mo"):
            _, held, largs = fn.pack(*args)
            entry, wrapper = "pq_value_mo", lambda: fn.kernel_t(*args)
            nbytes, ops = kernel_bounds_pbc(wf, geometry, DIAMOND_NCONF,
                                            {"pbc_sweep": 0, "pbc_dmc_sweep": 0},
                                            args[0].shape[0], 1)["value_mo"]
            bms, by = bound_ms(nbytes, ops)
            out[name] = {"points": args[0].shape[0]}
        else:
            entry, _, held, largs = fn.pack(*args)
            wrapper = lambda: fn.kernel(*args)
            bms, by = res[name]["bound_ms"], res[name]["bound_by"]
            out[name] = {}
        dev = cuda_ms(lambda: _build.launch(entry, torch.float32, *largs), reps)
        out[name].update({"device_ms": dev, "wrapper_ms": cuda_ms(wrapper, reps),
                          "bound_ms": bms, "bound_by": by, "bound_share": bms / dev})
        del held
    return out


# --- traces -----------------------------------------------------------------------

def traced(run):
    """Runs run() under torch.profiler (device activity only). Returns
    (device busy us, device events, top 5 {name: ms}, the port's kernels
    {name: [launches, ms per launch]}, wall s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
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
                name = e.name.split("pq::")[1].split("(")[0]
                n, tot = ours.get(name, (0, 0.0))
                ours[name] = (n + 1, tot + us)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    ours = {k: [n, tot / n / 1e3] for k, (n, tot) in ours.items()}
    return sum(per_name.values()), nkern, {k[:80]: v / 1e3 for k, v in top}, ours, wall


def report_trace(phase, what, nsteps, trace, untraced_s):
    busy_us, nkern, top, ours, t_traced = trace
    print(f"{phase}: traced {what} {t_traced:.4f} s wall, device busy {busy_us / 1e6:.4f} s "
          f"({nkern} device events, {nkern / nsteps:.0f} per step); idle share "
          f"{1 - busy_us / 1e6 / t_traced:.4f} of the traced block, "
          f"{1 - busy_us / 1e6 / untraced_s:.4f} of the untraced block; the port's kernels "
          f"[launches, device ms per launch]: {json.dumps(ours)}; top device time (ms): "
          f"{json.dumps(top)}", flush=True)
    check(busy_us > 0, "the profiler recorded no device time")
    return ours


def predicted_weights(blocks, e_trial0, tstep, nsteps):
    """Each DMC block's mean weight as its trial energy and its energy
    predict it. Per step the population's mean weight grows by exp(tstep
    (E_T - E)), E being the weighted mean local energy that the block
    records, and branching keeps it; so a block that starts at w holds w
    exp(k tstep (E_T - E)) after its k-th step. E_T is e_trial0 (the
    warm-up's mean local energy) in block 0 and the e_trial that rundmc
    reports for the block before in each later block. The effective time
    step (about 0.97 of tstep here) and the clipping of the branching
    exponent are left out: on the JAX package's runs the prediction is
    within 20% of the weights."""
    out, logw, e_t = [], 0.0, e_trial0
    for b in blocks:
        g = tstep * (e_t - b["energytotal"])
        out.append(float(np.exp(logw) * np.mean(np.exp(g * np.arange(1, nsteps + 1)))))
        logw += nsteps * g
        e_t = b["e_trial"]
    return out


def against_pins(phase, what, e, block_energies, nmean, pin, pin_one_thread):
    """The H2O chain's energy e, the mean of the last nmean of
    block_energies, against its pins: `pin` within 1e-4 Ha, and
    `pin_one_thread` within 3 combined standard errors. The standard error
    of e is the scatter of the blocks after the first (reblock_by2's first
    level) over sqrt(nmean); the earlier chain ran the same schedule, so
    its standard error is taken equal and the combined one is sqrt(2)
    times it."""
    from pyqmc_tpu_torch.reblock import reblock_by2

    _, n, _, se, _ = reblock_by2(np.asarray(block_energies[1:], dtype=float))[0]
    sem = se * np.sqrt(n) / np.sqrt(nmean)
    comb = float(np.sqrt(2) * sem)
    print(f"{phase}: H2O {what} E={e:.6f} Ha +- {sem:.6f} (blocks after the first); "
          f"pinned {pin:.6f}; one-thread-per-walker kernels' chain {pin_one_thread:.6f}, "
          f"{abs(e - pin_one_thread) / comb:.2f} combined standard errors ({comb:.6f}) away",
          flush=True)
    check(abs(e - pin_one_thread) <= 3 * comb,
          f"the H2O {what} energy {e} is more than 3 combined standard errors ({comb}) from "
          f"{pin_one_thread}, the one-thread-per-walker kernels' chain")
    check(abs(e - pin) <= 1e-4, f"the H2O {what} chain moved: E {e} against {pin}")


def timed_in_turns(fns, run, order=("plain", "kernel", "kernel", "plain")):
    """run(name, fn) for fn in `order`; returns mean seconds of each and
    the times."""
    times = {"kernel": [], "plain": []}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, fns[name])
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    return float(np.mean(times["kernel"])), float(np.mean(times["plain"])), times


def main():
    t_start = time.perf_counter()
    # phase 0: the card (and the package: nothing is printed without both)
    check(torch.cuda.is_available(), "no CUDA device; the port's kernels run only on a GPU")
    from pyqmc_tpu_torch.models.orbitals import plain_orbitals
    from pyqmc_tpu_torch.ops import _build, ecp_energy, gto_kernels, move_sweep, move_sweep_pbc
    from pyqmc_tpu_torch.ops import tmove_sweep

    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    counters = {"vmc_sweep": move_sweep.LAUNCHES, "ecp_energy": ecp_energy.LAUNCHES,
                "dmc_sweep": move_sweep.DMC_LAUNCHES, "tmove_sweep": tmove_sweep.LAUNCHES,
                "value_mo": gto_kernels.VALUE_MO_LAUNCHES,
                "gto_eval": gto_kernels.EVAL_GTO2_LAUNCHES, "pbc_sweep": move_sweep_pbc.LAUNCHES,
                "pbc_dmc_sweep": move_sweep_pbc.DMC_LAUNCHES}
    periodic = ("value_mo", "gto_eval", "pbc_sweep", "pbc_dmc_sweep")
    h2o_kernels = ("vmc_sweep", "ecp_energy", "dmc_sweep", "tmove_sweep")

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.n for k, c in counters.items()}

    # phase 1: build
    t0 = time.perf_counter()
    libs = _build.build()
    _build.library()
    print(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for so in libs.values():
        with open(so[:-3] + ".log") as f:
            for line in f:
                if "Compiling entry function" in line or "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip().replace("ptxas info    : ", ""), flush=True)

    print(f"phase 2 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 2: kernels against their plain versions (which evaluate their
    # MO values without K3; the four kernels call no orbital evaluator)
    with plain_orbitals():
        r64 = compare_kernels(torch.float64)
        print("phase 2 float64: " + json.dumps(r64), flush=True)
        r32 = compare_kernels(torch.float32)
        print("phase 2 float32: " + json.dumps(r32), flush=True)
    print(f"phase 2: K1, K2, K4 and K5, device (CUDA events over back-to-back launches) and "
          f"wrapper ms, bound and its share of the device time, {card}: "
          f"{json.dumps(r32['redesigned'])}", flush=True)
    print("phase 2 float64 blocks: " + json.dumps(compare_blocks()), flush=True)

    print(f"phase 3 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 3: the VMC path through the entry points
    from pyqmc_tpu_torch.entry import h2o_setup
    from pyqmc_tpu_torch.method.vmc import vmc

    mol, wf, params, configs, acc = h2o_setup(NCONF, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(7)
    reset_counts()
    t0 = time.perf_counter()
    blocks, configs = vmc(wf, params, configs, nblocks=4, nsteps_per_block=NSTEPS, tstep=TSTEP,
                          accumulators=acc, generator=gen)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = read_counts()
    for b in blocks:
        print(f"phase 3 block {b['block']}: E={b['energytotal']:.6f} ecp={b['energyecp']:.6f} "
              f"ke={b['energyke']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s",
              flush=True)
    check(launches == {"vmc_sweep": 4 * NSTEPS, "ecp_energy": 4 * NSTEPS, "dmc_sweep": 0,
                       "tmove_sweep": 0, **{k: 0 for k in periodic}},
          f"kernel launches on the VMC path: {launches}")
    for b in blocks:
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in block {b['block']}")
    e_last = float(np.mean([b["energytotal"] for b in blocks[-2:]]))
    a_last = float(np.mean([b["acceptance"] for b in blocks[-2:]]))
    check(-17.2 < e_last < -16.8, f"energy {e_last} outside (-17.2, -16.8) Ha")
    check(0.5 < a_last < 0.75, f"acceptance {a_last} outside (0.5, 0.75)")
    print(f"phase 3: launches {launches}, E(last 2 blocks)={e_last:.6f} Ha, acc={a_last:.4f}, "
          f"{t_main:.2f} s for 4 blocks", flush=True)
    against_pins("phase 3", "VMC", e_last, [b["energytotal"] for b in blocks], 2, H2O_VMC_E,
                 H2O_VMC_E_ONE_THREAD)

    print(f"phase 4 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 4: one VMC block with the kernels, one with the plain versions
    from pyqmc_tpu_torch.method.vmc import make_vmc_block
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator

    acc_plain = {"energy": EnergyAccumulator(mol, ecp_acc=ECPAccumulator(mol, fused=False))}
    fns = {"kernel": make_vmc_block(wf, acc, configs.geometry, TSTEP, NSTEPS, fused=True),
           "plain": make_vmc_block(wf, acc_plain, configs.geometry, TSTEP, NSTEPS, fused=False)}
    walk = {"pos": configs.positions, "wrap": configs.wrap}

    def vmc_block(name, fn):
        walk["pos"], walk["wrap"], avg = fn(params, walk["pos"], walk["wrap"], gen)
        check(bool(torch.isfinite(avg["energytotal"])), f"non-finite {name} VMC block energy")

    tk, tp, times = timed_in_turns(fns, vmc_block)
    print(f"phase 4: 50-step VMC block with kernels {tk:.4f} s ({NCONF * NSTEPS / tk:.1f} "
          f"walker-steps/s), plain {tp:.4f} s ({NCONF * NSTEPS / tp:.1f} walker-steps/s); "
          f"runs {json.dumps(times)}", flush=True)

    print(f"phase 5 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 5: one traced kernel VMC block; the device's busy time and idle share
    ours_vmc = report_trace("phase 5", "kernel VMC block", NSTEPS,
                            traced(lambda: vmc_block("traced", fns["kernel"])), tk)

    print(f"phase 6 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 6: the DMC path through the entry points, on the default device
    from pyqmc_tpu_torch.method.dmc import make_dmc_block, rundmc

    mol, wf, params, configs, acc = h2o_setup(NCONF, dtype=torch.float32)
    check(configs.positions.device.type == "cuda", "h2o_setup's default device is not the GPU")
    gen = torch.Generator(device="cuda").manual_seed(17)
    reset_counts()
    t0 = time.perf_counter()
    dblocks, dconfigs, weights = rundmc(
        wf, params, configs, nblocks=DMC_NBLOCKS, nsteps_per_block=DMC_NSTEPS, tstep=DMC_TSTEP,
        energy_acc=acc["energy"], generator=gen, warmup_vmc_blocks=DMC_WARMUP)
    torch.cuda.synchronize()
    t_dmc = time.perf_counter() - t0
    dlaunches = read_counts()
    for b in dblocks:
        print(f"phase 6 block {b['block']}: E={b['energytotal']:.6f} w={b['weight']:.5f} "
              f"e_trial={b['e_trial']:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
    nwarm = DMC_WARMUP * 10  # rundmc's warm-up blocks have 10 steps
    expect = {"vmc_sweep": nwarm, "dmc_sweep": DMC_NBLOCKS * DMC_NSTEPS,
              "tmove_sweep": DMC_NBLOCKS * DMC_NSTEPS,
              # warm-up steps, the energy that sets e_trial, and per block its
              # first energy plus one per step
              "ecp_energy": nwarm + 1 + DMC_NBLOCKS * (DMC_NSTEPS + 1),
              **{k: 0 for k in periodic}}
    check(dlaunches == expect, f"kernel launches on the DMC path: {dlaunches}, expected {expect}")
    for b in dblocks:
        check(all(np.isfinite(v) for v in b.values()), f"non-finite value in DMC block {b}")
        check(0.5 < b["weight"] < 2.0, f"block mean weight {b['weight']} outside (0.5, 2)")
        check(b["acceptance"] > 0.9, f"DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(weights))) and bool(torch.all(weights > 0)),
          "final weights are not finite and positive")
    check(dconfigs.positions.shape == (NCONF, 8, 3), "final walkers have the wrong shape")
    e_dmc = float(np.mean([b["energytotal"] for b in dblocks[-3:]]))
    # the energy window opens with the warm-up walkers' mean local energy:
    # after block 0, e_est is the mean of that energy and block 0's
    e_warm = 2 * dblocks[0]["e_est"] - dblocks[0]["energytotal"]
    check(-17.6 < e_dmc < -16.9, f"DMC energy {e_dmc} outside (-17.6, -16.9) Ha")
    check(e_dmc < e_warm + 0.05, f"DMC energy {e_dmc} above the warm-up VMC energy {e_warm}")
    print(f"phase 6: launches {dlaunches}, E(last 3 blocks)={e_dmc:.6f} Ha, warm-up VMC "
          f"E={e_warm:.6f} Ha, {t_dmc:.2f} s for {DMC_WARMUP} warm-up + {DMC_NBLOCKS} DMC blocks",
          flush=True)
    against_pins("phase 6", "DMC", e_dmc, [b["energytotal"] for b in dblocks], 3, H2O_DMC_E,
                 H2O_DMC_E_ONE_THREAD)

    print(f"phase 7 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 7: one DMC block with the kernels, one with the plain versions, one traced
    acc_plain = EnergyAccumulator(mol, ecp_acc=ECPAccumulator(mol, fused=False))
    dfns = {"kernel": make_dmc_block(wf, acc["energy"], dconfigs.geometry, DMC_TSTEP, DMC_NSTEPS,
                                     fused=True)[0],
            "plain": make_dmc_block(wf, acc_plain, dconfigs.geometry, DMC_TSTEP, DMC_NSTEPS,
                                    fused=False)[0]}
    last = dblocks[-1]
    walk = {"pos": dconfigs.positions, "wrap": dconfigs.wrap, "w": weights}

    def dmc_block(name, fn):
        walk["pos"], walk["wrap"], walk["w"], avg = fn(
            params, walk["pos"], walk["wrap"], walk["w"], gen, last["e_trial"], last["e_est"],
            0.5)
        check(bool(torch.isfinite(avg["energytotal"])), f"non-finite {name} DMC block energy")

    reset_counts()
    dtk, dtp, dtimes = timed_in_turns(dfns, dmc_block)
    check(read_counts() == {
        "vmc_sweep": 0, "dmc_sweep": 2 * DMC_NSTEPS, "tmove_sweep": 2 * DMC_NSTEPS,
        "ecp_energy": 2 * (DMC_NSTEPS + 1), **{k: 0 for k in periodic}},
          f"the plain DMC blocks launched kernels: {read_counts()}")
    print(f"phase 7: {DMC_NSTEPS}-step DMC block with kernels {dtk:.4f} s "
          f"({NCONF * DMC_NSTEPS / dtk:.1f} walker-steps/s), plain {dtp:.4f} s "
          f"({NCONF * DMC_NSTEPS / dtp:.1f} walker-steps/s); runs {json.dumps(dtimes)}",
          flush=True)
    ours_dmc = report_trace("phase 7", "kernel DMC block", DMC_NSTEPS,
                            traced(lambda: dmc_block("traced", dfns["kernel"])), dtk)

    print(f"phase 8 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 8: the periodic kernels against their plain versions
    p64 = compare_pbc_kernels(torch.float64)
    print("phase 8 float64: " + json.dumps(p64), flush=True)
    p32 = compare_pbc_kernels(torch.float32)
    print("phase 8 float32: " + json.dumps(p32), flush=True)
    print(f"phase 8: K3 and K7, device (CUDA events over back-to-back launches) and wrapper ms, "
          f"bound and its share of the device time, {card}: {json.dumps(p32['redesigned'])}",
          flush=True)

    print(f"phase 9 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 9: the periodic VMC path through the entry points, default device
    from pyqmc_tpu_torch.entry import diamond_setup

    sup, wf, params, configs, acc = diamond_setup(DIAMOND_NCONF, dtype=torch.float32)
    check(configs.positions.device.type == "cuda", "diamond_setup's default device is not the GPU")
    gen = torch.Generator(device="cuda").manual_seed(29)
    inner = make_vmc_block(wf, acc, configs.geometry, TSTEP, DIAMOND_NSTEPS)
    per_block = []

    def counted_block(*args):
        before = read_counts()
        out = inner(*args)
        per_block.append({k: v - before[k] for k, v in read_counts().items()})
        return out

    reset_counts()
    t0 = time.perf_counter()
    pblocks, pconfigs = vmc(wf, params, configs, nblocks=DIAMOND_NBLOCKS,
                            nsteps_per_block=DIAMOND_NSTEPS, tstep=TSTEP, accumulators=acc,
                            generator=gen, block_fn=counted_block)
    torch.cuda.synchronize()
    t_pbc = time.perf_counter() - t0
    plaunches = read_counts()
    # launches per step: one sweep, one K6 per kinetic-energy chunk of
    # 16384 // nconf electrons, one K3 per ECP chunk of 262144 // (nconf
    # nselect) electrons; 1, 2 and 4 at 500 walkers
    nelec, nsel = sum(sup.nelec), acc["energy"].ecp_acc.nselect
    per_step = {"pbc_sweep": 1, "gto_eval": -(-nelec // max(1, 16384 // DIAMOND_NCONF)),
                "value_mo": -(-nelec // max(1, 262144 // (DIAMOND_NCONF * nsel)))}
    check(DIAMOND_NCONF != 500 or per_step == {"pbc_sweep": 1, "gto_eval": 2, "value_mo": 4},
          f"expected launches per step {per_step}")
    for b, n in zip(pblocks, per_block):
        print(f"phase 9 block {b['block']}: E/cell={b['energytotal'] / DIAMOND_NCELL:.6f} "
              f"ecp/cell={b['energyecp'] / DIAMOND_NCELL:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s launches {json.dumps(n)}", flush=True)
        check(n == {k: DIAMOND_NSTEPS * per_step.get(k, 0) for k in counters},
              f"kernel launches in a periodic block: {n}")
        check(all(np.isfinite(v) for k, v in b.items() if k.startswith("energy")),
              f"non-finite energies in periodic block {b['block']}")
    e_cells = np.array([b["energytotal"] / DIAMOND_NCELL for b in pblocks[-DIAMOND_NLAST:]])
    e_pbc, sem_pbc = float(np.mean(e_cells)), float(np.std(e_cells, ddof=1) / np.sqrt(len(e_cells)))
    a_pbc = float(np.mean([b["acceptance"] for b in pblocks[-DIAMOND_NLAST:]]))
    ref = DIAMOND_REF
    window = max(5 * float(np.hypot(sem_pbc, ref["sem"])), 0.02)
    print(f"phase 9: launches {plaunches}, E/cell(last {DIAMOND_NLAST} blocks)={e_pbc:.6f} "
          f"+- {sem_pbc:.6f} Ha, acc={a_pbc:.4f}; JAX CPU reference {ref['e_cell']:.6f} "
          f"+- {ref['sem']:.6f} Ha, acc {ref['acceptance']:.4f}; window {window:.6f} Ha; "
          f"{t_pbc:.2f} s for {DIAMOND_NBLOCKS} blocks", flush=True)
    check(abs(e_pbc - ref["e_cell"]) <= window,
          f"periodic E/cell {e_pbc} off the JAX reference {ref['e_cell']} by more than {window}")
    check(abs(a_pbc - ref["acceptance"]) <= 0.05,
          f"periodic acceptance {a_pbc} off the JAX reference's {ref['acceptance']}")

    print(f"phase 10 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 10: a kernel and a plain periodic block in turns, then one traced
    pfns = {"kernel": inner,
            "plain": make_vmc_block(wf, acc, configs.geometry, TSTEP, DIAMOND_NSTEPS, fused=False)}
    walk = {"pos": pconfigs.positions, "wrap": pconfigs.wrap}

    def pbc_block(name, fn):
        walk["pos"], walk["wrap"], avg = fn(params, walk["pos"], walk["wrap"], gen)
        check(bool(torch.isfinite(avg["energytotal"])), f"non-finite {name} periodic block energy")

    reset_counts()
    ptk, ptp, ptimes = timed_in_turns(pfns, pbc_block)
    check(read_counts() == {k: 2 * DIAMOND_NSTEPS * per_step.get(k, 0) for k in counters},
          f"the periodic blocks' launches: {read_counts()} (the plain blocks must launch none)")
    print(f"phase 10: {DIAMOND_NSTEPS}-step periodic block with kernels {ptk:.4f} s "
          f"({DIAMOND_NCONF * DIAMOND_NSTEPS / ptk:.1f} walker-steps/s), plain {ptp:.4f} s "
          f"({DIAMOND_NCONF * DIAMOND_NSTEPS / ptp:.1f} walker-steps/s); runs {json.dumps(ptimes)}",
          flush=True)
    ours_pbc = report_trace("phase 10", "kernel periodic block", DIAMOND_NSTEPS,
                            traced(lambda: pbc_block("traced", inner)), ptk)

    print(f"phase 11 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 11: the periodic DMC path through the entry points, default device
    sup, wf, params, configs, acc = diamond_setup(DIAMOND_NCONF, dtype=torch.float32)
    check(configs.positions.device.type == "cuda", "diamond_setup's default device is not the GPU")
    nelec = sum(sup.nelec)
    gen = torch.Generator(device="cuda").manual_seed(31)
    reset_counts()
    t0 = time.perf_counter()
    qblocks, qconfigs, qweights = rundmc(
        wf, params, configs, nblocks=DIAMOND_DMC_NBLOCKS, nsteps_per_block=DMC_NSTEPS,
        tstep=DMC_TSTEP, energy_acc=acc["energy"], generator=gen,
        warmup_vmc_blocks=DIAMOND_DMC_WARMUP)
    torch.cuda.synchronize()
    t_qdmc = time.perf_counter() - t0
    qlaunches = read_counts()
    # an energy evaluation launches K6 once per kinetic chunk and K3 once
    # per ECP chunk (per_step of phase 9); the T-move sweep evaluates each
    # electron's dense quadrature with one K3 launch; per DMC block: the
    # first energy, then per step a T-move sweep, a K7-dmc sweep, an energy
    nwarm = DIAMOND_DMC_WARMUP * 10  # rundmc's warm-up blocks have 10 steps
    per_block = {"pbc_dmc_sweep": DMC_NSTEPS,
                 "gto_eval": (DMC_NSTEPS + 1) * per_step["gto_eval"],
                 "value_mo": (DMC_NSTEPS + 1) * per_step["value_mo"] + DMC_NSTEPS * nelec}
    qexpect = {k: 0 for k in counters}
    qexpect.update({
        "pbc_sweep": nwarm,
        "pbc_dmc_sweep": DIAMOND_DMC_NBLOCKS * per_block["pbc_dmc_sweep"],
        # warm-up steps, the energy that sets e_trial, the blocks
        "gto_eval": (nwarm + 1) * per_step["gto_eval"]
        + DIAMOND_DMC_NBLOCKS * per_block["gto_eval"],
        "value_mo": (nwarm + 1) * per_step["value_mo"]
        + DIAMOND_DMC_NBLOCKS * per_block["value_mo"]})
    for b in qblocks:
        print(f"phase 11 block {b['block']}: E/cell={b['energytotal'] / DIAMOND_NCELL:.6f} "
              f"ecp/cell={b['energyecp'] / DIAMOND_NCELL:.6f} w={b['weight']:.5f} "
              f"e_trial/cell={b['e_trial'] / DIAMOND_NCELL:.6f} acc={b['acceptance']:.4f} "
              f"host time {b['block time']:.3f} s", flush=True)
    check(qlaunches == qexpect,
          f"kernel launches on the periodic DMC path: {qlaunches}, expected {qexpect}")
    qref = DIAMOND_DMC_REF
    # The block mean weight follows e_trial's lag behind the energy, which
    # falls by 0.5-1 Ha per cell from the warm-up VMC's: the JAX package's
    # runs on this schedule reach block mean weights of 3.4-11.6. So
    # each block's weight is held, within a factor of 2, to the weight that
    # its e_trial and its energy predict (predicted_weights).
    e_qwarm_total = 2 * qblocks[0]["e_est"] - qblocks[0]["energytotal"]
    w_pred = predicted_weights(qblocks, e_qwarm_total, DMC_TSTEP, DMC_NSTEPS)
    for b, wp in zip(qblocks, w_pred):
        check(all(np.isfinite(v) for v in b.values()),
              f"non-finite value in periodic DMC block {b}")
        check(0.5 < b["weight"] / wp < 2.0,
              f"periodic block {b['block']} mean weight {b['weight']} not within a factor 2 of "
              f"the {wp} that its e_trial and energy predict")
        check(b["acceptance"] > 0.9, f"periodic DMC acceptance {b['acceptance']} not above 0.9")
    check(bool(torch.all(torch.isfinite(qweights))) and bool(torch.all(qweights > 0)),
          "final periodic weights are not finite and positive")
    check(qconfigs.positions.shape == (DIAMOND_NCONF, nelec, 3),
          "final periodic walkers have the wrong shape")
    q_cells = np.array([b["energytotal"] / DIAMOND_NCELL for b in qblocks[-DIAMOND_DMC_NLAST:]])
    e_q = float(np.mean(q_cells))
    a_q = float(np.mean([b["acceptance"] for b in qblocks[-DIAMOND_DMC_NLAST:]]))
    sem_q = float(np.std(q_cells, ddof=1) / np.sqrt(len(q_cells)))
    e_qwarm = e_qwarm_total / DIAMOND_NCELL
    qwindow = max(5 * float(np.hypot(sem_q, qref["sem"])), 0.02)
    print(f"phase 11: launches {qlaunches} ({json.dumps(per_block)} per block), "
          f"E/cell(last {DIAMOND_DMC_NLAST} blocks)={e_q:.6f} +- {sem_q:.6f} Ha, warm-up VMC "
          f"E/cell={e_qwarm:.6f} Ha, acc={a_q:.4f}, block weights "
          f"{[round(b['weight'], 4) for b in qblocks]}, predicted {[round(w, 4) for w in w_pred]}; "
          f"JAX CPU reference {qref['e_cell']:.6f} +- {qref['sem']:.6f} Ha (warm-up VMC "
          f"{qref['e_vmc_cell']:.6f}, acc {qref['acceptance']:.4f}, block weights "
          f"{[round(w, 4) for w in qref['weights']]}); "
          f"window {qwindow:.6f} Ha; {t_qdmc:.2f} s for {DIAMOND_DMC_WARMUP} warm-up + "
          f"{DIAMOND_DMC_NBLOCKS} DMC blocks", flush=True)
    check(abs(e_q - qref["e_cell"]) <= qwindow,
          f"periodic DMC E/cell {e_q} off the JAX reference {qref['e_cell']} by more than "
          f"{qwindow}")
    check(e_q < e_qwarm + 0.02,
          f"periodic DMC E/cell {e_q} above the warm-up VMC energy {e_qwarm} by more than 0.02 Ha")

    print(f"phase 12 starts at {time.perf_counter() - t_start:.1f} s", flush=True)
    # phase 12: a kernel and a plain periodic DMC block in turns, then one traced
    qlast = qblocks[-1]
    qfns = {"kernel": make_dmc_block(wf, acc["energy"], qconfigs.geometry, DMC_TSTEP, DMC_NSTEPS,
                                     fused=True)[0],
            "plain": make_dmc_block(wf, acc["energy"], qconfigs.geometry, DMC_TSTEP, DMC_NSTEPS,
                                    fused=False)[0]}
    walk = {"pos": qconfigs.positions, "wrap": qconfigs.wrap, "w": qweights}

    def qdmc_block(name, fn):
        walk["pos"], walk["wrap"], walk["w"], avg = fn(
            params, walk["pos"], walk["wrap"], walk["w"], gen, qlast["e_trial"], qlast["e_est"],
            0.5 * DIAMOND_NCELL)  # esigma: 0.5 Ha per primitive cell
        check(bool(torch.isfinite(avg["energytotal"])),
              f"non-finite {name} periodic DMC block energy")

    # the T-move sweep of one step alone (plain PyTorch with a K3 launch
    # per electron for its dense quadrature's ratios), CUDA events
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams
    from pyqmc_tpu_torch.ops.tmove_sweep import tmove_sweep_plain

    qst = draw_dmc_streams(gen, 1, nelec, DIAMOND_NCONF, DMC_TSTEP, walk["pos"].device,
                           torch.float32, downselect=True)
    qstate = wf.recompute(params, walk["pos"])
    k3 = counters["value_mo"].n
    tmove_ms = cuda_ms(lambda: tmove_sweep_plain(
        wf, qconfigs.geometry, acc["energy"].ecp_acc, DMC_TSTEP, params, walk["pos"],
        walk["wrap"], qstate, qst["tqrot"][0], qst["u_sel"][0], qst["u_acc"][0]), 1)
    check(counters["value_mo"].n - k3 == 2 * nelec,
          f"the T-move sweep launched K3 {counters['value_mo'].n - k3} times in 2 sweeps")
    # K3 at the T-move quadrature's size (one electron's 96 points per walker)
    orb = wf.wfs[0].orbitals
    aux, _ = acc["energy"].ecp_acc.quadrature_geometry(walk["pos"][:, 0], qst["tqrot"][0][0])
    Xq, _ = orb._fold(aux.reshape(-1, 3))
    Rq = orb._folded_coeff(params["wf0"], torch.float32)
    k3_ms = cuda_ms(lambda: orb._value_mo.kernel_t(Xq, Rq), 10)
    k3_bytes, k3_ops = kernel_bounds_pbc(wf, qconfigs.geometry, DIAMOND_NCONF,
                                         {"pbc_sweep": 0, "pbc_dmc_sweep": 0}, Xq.shape[0],
                                         1)["value_mo"]
    k3_bound, k3_by = bound_ms(k3_bytes, k3_ops)
    print(f"phase 12: the T-move sweep alone {tmove_ms:.2f} ms ({nelec} K3 launches); K3 at its "
          f"{Xq.shape[0]} points {k3_ms:.4f} ms (CUDA events), bound {k3_bound:.4f} ms ({k3_by})",
          flush=True)
    reset_counts()
    qtk, qtp, qtimes = timed_in_turns(qfns, qdmc_block, order=("plain", "kernel"))
    check(read_counts() == {k: per_block.get(k, 0) for k in counters},
          f"the periodic DMC blocks' launches: {read_counts()} (the plain blocks must launch none)")
    print(f"phase 12: {DMC_NSTEPS}-step periodic DMC block with kernels {qtk:.4f} s "
          f"({DIAMOND_NCONF * DMC_NSTEPS / qtk:.1f} walker-steps/s), plain {qtp:.4f} s "
          f"({DIAMOND_NCONF * DMC_NSTEPS / qtp:.1f} walker-steps/s); runs {json.dumps(qtimes)}",
          flush=True)
    ours_qdmc = report_trace("phase 12", "kernel periodic DMC block", DMC_NSTEPS,
                             traced(lambda: qdmc_block("traced", qfns["kernel"])), qtk)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)

    def device_ms(ours, *names):
        found = [ours[n][1] for n in ours if n.split("<")[0] in names]
        return sum(found) if found else None

    def pbc_device_ms(ours, dmc):
        """The periodic sweep's instance of one mode (template <T, DMC>)."""
        found = [v[1] for n, v in ours.items()
                 if n.startswith("pbc_sweep_kernel<") and n.rstrip(">").endswith(str(dmc).lower())]
        return sum(found) if found else None

    replaces = {"vmc_sweep": "pyqmc_tpu/ops/move_pallas.py:278",
                "ecp_energy": "pyqmc_tpu/ops/move_pallas.py:1151",
                "dmc_sweep": "pyqmc_tpu/ops/move_pallas.py:278",
                "tmove_sweep": "pyqmc_tpu/ops/move_pallas.py:727",
                "value_mo": "pyqmc_tpu/ops/gto_pallas.py:184",
                "gto_eval": "pyqmc_tpu/ops/gto_pallas.py:29",
                "pbc_sweep": "pyqmc_tpu/ops/move_pallas_pbc.py:206",
                "pbc_dmc_sweep": "pyqmc_tpu/ops/move_pallas_pbc.py:206 (dmc)"}
    kernels = []
    for name in h2o_kernels:
        on_vmc = name in ("vmc_sweep", "ecp_energy")
        n = (launches if on_vmc else dlaunches)[name]
        check(n > 0 and dlaunches[name] > 0, f"{name} was not launched on its path")
        r = r32[name]
        trace_names = {"vmc_sweep": ("sweep_kernel",), "dmc_sweep": ("sweep_kernel",),
                       "ecp_energy": ("ecp_energy_kernel",),
                       "tmove_sweep": ("tmove_sweep_kernel",)}[name]
        entry = {
            "name": name, "route": "cuda", "source": f"pyqmc_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name], "launches": n, "launches_dmc_path": dlaunches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "device_ms": device_ms(ours_vmc if on_vmc else ours_dmc, *trace_names)}
        red = r32["redesigned"].get(name)
        if red is not None:
            entry.update({"device_event_ms": red["device_ms"],
                          "wrapper_event_ms": red["wrapper_ms"],
                          "bound_share": red["bound_share"]})
        kernels.append(entry)
    for name in periodic:
        main_path = qlaunches if name == "pbc_dmc_sweep" else plaunches
        check(main_path[name] > 0 and qlaunches[name] > 0,
              f"{name} was not launched on its periodic path")
        r = p32[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"pyqmc_tpu_torch/csrc/{'pbc_sweep' if name == 'pbc_dmc_sweep' else name}.cu",
            "replaces": replaces[name],
            "launches": main_path[name],
            "launches_periodic_dmc_path": qlaunches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None}
        if name in ("pbc_sweep", "pbc_dmc_sweep"):
            entry["mode"] = "dmc" if name == "pbc_dmc_sweep" else "vmc"
            entry["device_ms"] = pbc_device_ms(ours_qdmc if name == "pbc_dmc_sweep" else ours_pbc,
                                               name == "pbc_dmc_sweep")
            if name == "pbc_dmc_sweep":
                big = p64["pbc_dmc_sweep_big_tstep"]
                entry.update({"max_abs_err_float64": p64[name]["max_abs_err"],
                              "max_abs_err_float64_big_tstep": big["max_abs_err"]})
        else:
            entry["device_ms"] = device_ms(ours_pbc, f"{name}_kernel")
            entry["device_ms_periodic_dmc"] = device_ms(ours_qdmc, f"{name}_kernel")
        red = p32["redesigned"].get(name)
        if red is not None:
            entry.update({"device_event_ms": red["device_ms"],
                          "wrapper_event_ms": red["wrapper_ms"], "bound_share": red["bound_share"]})
        if name == "value_mo":
            q = p32["redesigned"]["value_mo_48000"]
            entry.update({"points": red["points"], "points_tmove": q["points"],
                          "device_event_ms_tmove": q["device_ms"],
                          "wrapper_event_ms_tmove": q["wrapper_ms"], "bound_ms_tmove": q["bound_ms"],
                          "bound_share_tmove": q["bound_share"]})
            h = p32["value_mo_h2o"]
            entry.update({"h2o_ms": h["ms"], "h2o_plain_ms": h["plain_ms"],
                          "h2o_bound_ms": h["bound_ms"], "h2o_max_abs_err": h["max_abs_err"]})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

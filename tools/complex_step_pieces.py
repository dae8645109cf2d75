"""The pieces of a step on H2O with complex orbitals against the same with
real ones, on one GPU, float32, 2048 walkers (about a minute).

    python3 tools/complex_step_pieces.py

The wavefunction is chip_smoke.py phase 35's (the committed H2O
checkpoint's occupied MO coefficients times i plus uniform noise in [-0.1,
0.1), default_rng(7), times JastrowSpin), or the real one with the same
orbitals unrotated. For each: the plain sweep, the Slater and Jastrow
halves of one electron's move, the kinetic energy, the ECP energy,
`pgradient`, the SR averages and the block-start recompute, each by CUDA
events (chip_smoke.cuda_ms, 3 runs) and by the host clock; one traced
sweep (device busy time, device events). Then, for the complex one: the
host time of the sweep, the energy with its imaginary part, `pgradient`
and the SR averages after a synchronise; a 5-step SR VMC block and a
5-step energy VMC block; and the 5-step SR block under torch.profiler
(host and device activity), its operations by host time.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def setup(kind, mol, mf, rng):
    from pyqmc_tpu_torch.models.jastrow import JastrowSpin
    from pyqmc_tpu_torch.models.multiply import MultiplyWF
    from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu_torch.observables.transform import LinearTransform

    nup, ndn = mol.nelec
    ca, cb = mf.mo_coeff[0][:, :nup], mf.mo_coeff[1][:, :ndn]
    if kind == "complex":
        ca = ca * 1j + (rng.random(ca.shape) - 0.5) * 0.2
        cb = cb * 1j + (rng.random(cb.shape) - 0.5) * 0.2
    sl, jas = Slater(mol, None, DeterminantExpansion.single(nup, ndn), (ca, cb)), JastrowSpin(mol)
    wf = MultiplyWF(sl, jas)
    params = wf.make_params()
    lt = LinearTransform(params, {"wf0": {"det_coeff": False, "mo_coeff_alpha": True,
                                          "mo_coeff_beta": True},
                                  "wf1": {"acoeff": True, "bcoeff": True}})
    return sl, jas, wf, params, lt


def main():
    from torch.profiler import ProfilerActivity, profile

    from pyqmc_tpu_torch.configs import initial_guess
    from pyqmc_tpu_torch.method.vmc import draw_streams, make_vmc_block, vmc
    from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
    from pyqmc_tpu_torch.observables.energy import kinetic_energy
    from pyqmc_tpu_torch.observables.sr import StochasticReconfiguration
    from pyqmc_tpu_torch.ops import _build
    from pyqmc_tpu_torch.ops.move_sweep import sweep_plain
    from pyqmc_tpu_torch.system.io import load_npz

    _build.build()
    _build.library()
    print(cs.card_line(), flush=True)
    mol, mf = load_npz()
    rng = np.random.default_rng(7)
    energy = EnergyAccumulator(mol)
    for kind in ("real", "complex"):
        sl, jas, wf, params, lt = setup(kind, mol, mf, rng)
        gen = torch.Generator(device="cuda").manual_seed(1)
        cfg = initial_guess(mol, 2048, generator=torch.Generator().manual_seed(0))
        _, cfg = vmc(wf, params, cfg, nblocks=1, nsteps_per_block=5, generator=gen)
        pos = cfg.positions
        st = draw_streams(gen, 1, 8, 2048, 0.5, pos.device, torch.float32)
        state = wf.recompute(params, pos)
        sr = StochasticReconfiguration(energy, lt)
        e = 3
        _, aux_j = jas.move_begin(params["wf1"], state[1], e, pos[:, e])
        _, aux_s = sl.move_begin(params["wf0"], state[0], e, pos[:, e])
        pieces = {
            "sweep_plain": lambda: sweep_plain(wf, cfg.geometry, 0.5, 1.0, params, pos, cfg.wrap,
                                               state, st["gauss"][0], st["unif"][0]),
            "slater_move_begin": lambda: sl.move_begin(params["wf0"], state[0], e, pos[:, e]),
            "slater_move_finish": lambda: sl.move_finish(params["wf0"], state[0], e,
                                                         pos[:, e] + 0.1, aux_s),
            "jastrow_move_begin": lambda: jas.move_begin(params["wf1"], state[1], e, pos[:, e]),
            "jastrow_move_finish": lambda: jas.move_finish(params["wf1"], state[1], e,
                                                           pos[:, e] + 0.1, aux_j),
            "kinetic": lambda: kinetic_energy(wf, params, state, pos),
            "ecp": lambda: energy.ecp_acc(wf, params, state, pos, st["rot"][0]),
            "pgradient": lambda: wf.pgradient(params, pos),
            "sr_avg": lambda: sr.avg(wf, params, state, pos, st["rot"][0]),
            "recompute": lambda: wf.recompute(params, pos),
        }
        out = {}
        for k, fn in pieces.items():
            out[k] = round(cs.cuda_ms(fn, 3), 3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            out[k + "_host"] = round((time.perf_counter() - t0) * 1e3, 3)
        print(kind, "ms", json.dumps(out), flush=True)
        busy, nk, top, _, wall = cs.traced(pieces["sweep_plain"])
        print(kind, f"traced sweep: device busy {busy / 1e3:.3f} ms, {nk} device events, "
              f"{wall * 1e3:.2f} ms wall; top {json.dumps(top)}", flush=True)
        if kind != "complex":
            continue
        host = {"sweep": pieces["sweep_plain"],
                "energy_imag": lambda: energy(wf, params, state, pos, st["rot"][0],
                                              with_imag=True),
                "pgradient": pieces["pgradient"], "sr_avg": pieces["sr_avg"]}
        for k, fn in host.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            print(f"{k} {(time.perf_counter() - t0) * 1e3:.2f} ms wall", flush=True)
        blocks = {"SR": make_vmc_block(wf, {"pgrad": sr}, cfg.geometry, 0.5, 5),
                  "energy": make_vmc_block(wf, {"energy": energy}, cfg.geometry, 0.5, 5)}
        for k, blk in blocks.items():
            blk(params, pos, cfg.wrap, gen)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blk(params, pos, cfg.wrap, gen)
            torch.cuda.synchronize()
            print(f"{k} block of 5 steps {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            blocks["SR"](params, pos, cfg.wrap, gen)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=30), flush=True)


if __name__ == "__main__":
    main()

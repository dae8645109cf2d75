"""Device time of one launch of K3 (csrc/value_mo.cu) and of K7
(csrc/pbc_sweep.cu, both modes) at the diamond supercell's shapes, float32,
for the pyqmc_tpu_torch of a given checkout, on one NVIDIA GPU.

    python tools/time_k3_k7.py [ROOT] [LABEL]

ROOT (default: this checkout) is the directory that holds the package; its
kernels are built from its own csrc/ into its own build/. The script packs
each kernel's arguments once, the way the wrappers do (ops/gto_kernels.py,
ops/move_sweep_pbc.py), and times 50 launches of the C entry point back to
back with CUDA events after a warm-up; so it times two checkouts with one
procedure, which is how a redesign is compared with its parent in one call
(run parent, change, change, parent). Inputs as chip_smoke.py phase 8:
diamond_setup(500, seed 21), Jastrow coefficients from seed 22, streams
from seed 23; K3 at one ECP chunk (252,000 points) and at the T-move
quadrature of one electron (48,000 points), K7-vmc at tstep 0.5, K7-dmc at
tstep 0.02. Prints the card's name and power limit and one JSON line.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..")
LABEL = sys.argv[2] if len(sys.argv) > 2 else ROOT
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

NCONF, REPS = 500, 50


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("time_k3_k7: no CUDA device")
    from pyqmc_tpu_torch.entry import diamond_setup
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.observables.ecp import systematic_downselect
    from pyqmc_tpu_torch.ops import _build
    from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dtype = torch.float32
    for cu, so in _build.build().items():
        if cu in ("value_mo.cu", "pbc_sweep.cu"):
            with open(so[:-3] + ".log") as f:
                for line in f:
                    if "Compiling entry function" in line or "registers" in line or "spill" in line:
                        print("  ptxas:", line.strip().replace("ptxas info    : ", ""))
    _build.library()
    sup, wf, params, configs, acc = diamond_setup(NCONF, device="cuda", dtype=dtype, seed=21)
    rng = np.random.default_rng(22)
    j = params["wf1"]
    j["acoeff"] = torch.as_tensor(rng.normal(scale=0.1, size=tuple(j["acoeff"].shape)),
                                  dtype=dtype, device="cuda")
    pos, wrap = configs.positions, configs.wrap
    nelec = pos.shape[1]
    state = wf.recompute(params, pos)
    gen = torch.Generator(device="cuda").manual_seed(23)
    st = draw_streams(gen, 1, nelec, NCONF, 0.5, pos.device, dtype, downselect=True)
    orb = wf.wfs[0].orbitals
    ecp = acc["energy"].ecp_acc
    out = {"label": LABEL, "card": card}

    # K3: the arguments of pq_value_mo, packed as ValueMO.kernel_t packs them
    vm = orb._value_mo
    R = orb._folded_coeff(params["wf0"], dtype)
    k3 = 262144 // (NCONF * ecp.nselect)
    aux, T = ecp.quadrature_geometry(pos[:, :k3].transpose(0, 1), st["rot"][0][:k3])
    idx, _ = systematic_downselect(T, ecp.nselect, st["u_sel"][0][:k3])
    aux = torch.gather(aux, 2, idx[..., None].expand(*idx.shape, 3)).reshape(-1, 3)
    X3, _ = orb._fold(aux)
    auxq, _ = ecp.quadrature_geometry(pos[:, 0], st["rot"][0][0])
    Xq, _ = orb._fold(auxq.reshape(-1, 3))
    tab, meta, rows = vm.tables.get(pos.device, dtype)
    Cr = R[rows].contiguous()
    for name, X in (("value_mo_252000", X3), ("value_mo_48000", Xq)):
        Xc = X.contiguous()
        M, norb = Xc.shape[0], Cr.shape[1]
        res = torch.empty((norb, M), dtype=dtype, device="cuda")
        args = (Xc.data_ptr(), Cr.data_ptr(), res.data_ptr(), tab.data_ptr(), tab.numel(),
                meta.data_ptr(), meta.numel(), M, norb, vm.tables.nao)
        out[name] = {"points": M, "device_ms": cuda_ms(
            lambda: _build.launch("pq_value_mo", dtype, *args), REPS)}

    # K7: the arguments of pq_pbc_sweep / pq_pbc_dmc_sweep, packed by
    # FusedSweepPBC.pack
    for name, mode, tau in (("pbc_sweep", "vmc", 0.5), ("pbc_dmc_sweep", "dmc", 0.02)):
        sweep = build_fused_sweep(wf, configs.geometry, tau, mode=mode)
        s2 = draw_streams(gen, 1, nelec, NCONF, tau, pos.device, dtype)
        entry, (_, _, _, sums), held, args = sweep.pack(params, pos, configs.wrap, state,
                                                        s2["gauss"][0], s2["unif"][0])
        out[name] = {"device_ms": cuda_ms(lambda: _build.launch(entry, dtype, *args), REPS),
                     "acceptance": float(torch.mean(sums[0])) / nelec}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

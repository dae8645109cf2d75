"""Count the PyTorch operations that each piece of one periodic VMC or DMC
step runs: the host-side launches of the plain ops, counted on the CPU.

    python tools/torch_op_count.py [nconf]

Runs `entry.diamond_setup(nconf, device="cpu")` in float32 (default 500
walkers, the chip_smoke.py configuration) and counts, with a
TorchDispatchMode, the ATen calls of the kinetic energy, the Ewald sums,
the ECP energy, the block-start recompute and the periodic DMC step's
plain T-move sweep; prints the count and the six most frequent ops of
each. On the CPU K3 and K6 run their plain versions, whose ops are
counted in place of one launch each. The sweeps of K7 are left out: on
the card each is one kernel launch. On the card each counted call that
computes is one or more device launches, so these counts say where a
host-bound step spends its launches; they are not device times.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names[str(func)] = self.names.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def main(nconf=500):
    from pyqmc_tpu_torch.entry import diamond_setup
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams
    from pyqmc_tpu_torch.method.vmc import draw_streams
    from pyqmc_tpu_torch.observables.energy import kinetic_energy
    from pyqmc_tpu_torch.ops.tmove_sweep import tmove_sweep_plain

    sup, wf, params, configs, acc = diamond_setup(nconf, device="cpu", dtype=torch.float32)
    pos = configs.positions
    state = wf.recompute(params, pos)
    nelec = pos.shape[1]
    st = draw_streams(torch.Generator().manual_seed(1), 1, nelec, nconf, 0.5, pos.device,
                      torch.float32, downselect=True)
    energy = acc["energy"]
    dst = draw_dmc_streams(torch.Generator().manual_seed(2), 1, nelec, nconf, 0.02, pos.device,
                           torch.float32)
    pieces = [("kinetic", lambda: kinetic_energy(wf, params, state, pos)),
              ("ewald", lambda: energy.coulomb.energy(pos)),
              ("ecp", lambda: energy.ecp_acc(wf, params, state, pos, st["rot"][0],
                                             st["u_sel"][0])),
              ("recompute", lambda: wf.recompute(params, pos)),
              ("tmove sweep", lambda: tmove_sweep_plain(
                  wf, configs.geometry, energy.ecp_acc, 0.02, params, pos, configs.wrap, state,
                  dst["tqrot"][0], dst["u_sel"][0], dst["u_acc"][0]))]
    for name, fn in pieces:
        c = _Count()
        with c:
            fn()
        top = sorted(c.names.items(), key=lambda kv: -kv[1])[:6]
        print(f"{name}: {sum(c.names.values())} ops; most frequent {top}", flush=True)


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:]])

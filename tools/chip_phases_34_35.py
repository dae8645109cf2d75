"""Phases 34-35 of chip_smoke.py alone on one GPU: the VMC, DMC and
optimizer restarts and traces, and the complex-orbital optimization (about
1.5 minutes with the kernels' build).

    python3 tools/chip_phases_34_35.py

Builds the kernels, prints the card's name and power limit, runs the SCF of
H2O from phase 31's geometry string, then chip_smoke.restart_phases and
chip_smoke.complex_opt_phase (every gate as in the whole script), and
prints their seconds together and their launch counts as one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from pyqmc_tpu_torch.ops import (_build, ecp_energy, gto_kernels, move_sweep,  # noqa: E402
                                 move_sweep_pbc, tmove_sweep)


def main():
    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    _build.build()
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {"vmc_sweep": move_sweep.LAUNCHES, "ecp_energy": ecp_energy.LAUNCHES,
                "dmc_sweep": move_sweep.DMC_LAUNCHES, "tmove_sweep": tmove_sweep.LAUNCHES,
                "value_mo": gto_kernels.VALUE_MO_LAUNCHES,
                "gto_eval": gto_kernels.EVAL_GTO2_LAUNCHES, "pbc_sweep": move_sweep_pbc.LAUNCHES,
                "pbc_dmc_sweep": move_sweep_pbc.DMC_LAUNCHES}
    from pyqmc_tpu_torch.api import Molecule, run_scf

    t1 = time.perf_counter()
    mf = run_scf(Molecule(cs.H2O_ATOM, basis="ccecp-ccpvdz", ecp="ccecp"))
    print(f"scf {mf.e_tot:.9f} in {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    rs = cs.restart_phases(t0, card, counters)
    cx = cs.complex_opt_phase(t0, card, counters, mf)
    print(f"phases 34-35: {time.perf_counter() - t1:.1f} s", flush=True)
    print(json.dumps({**rs, **cx}), flush=True)


if __name__ == "__main__":
    main()

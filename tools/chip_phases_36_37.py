"""Phases 36-37 of chip_smoke.py alone on one GPU: the walker mesh (one rank
over NCCL, two ranks sharing the card over gloo) and the slab Ewald sum
(about 1.5 minutes with the kernels' build).

    python3 tools/chip_phases_36_37.py

Builds the kernels, prints the card's name and power limit, then runs
chip_smoke.mesh_phases and chip_smoke.ewald2d_phase (every gate as in the
whole script) and prints their seconds together and their launch counts as
one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from pyqmc_tpu_torch.ops import _build  # noqa: E402


def main():
    t0 = time.perf_counter()
    card = cs.card_line()
    print(card, flush=True)
    _build.build()
    _build.library()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    ms = cs.mesh_phases(t0, card, cs.kernel_counters())
    ew = cs.ewald2d_phase(t0, card)
    print(f"phases 36-37: {time.perf_counter() - t1:.1f} s; {card}", flush=True)
    print(json.dumps({**ms, **ew}), flush=True)


if __name__ == "__main__":
    main()

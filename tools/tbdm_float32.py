"""The same-spin and opposite-spin TBDM in float32 against float64, on the
same walkers and draws.

    python tools/tbdm_float32.py [nconf] [device]   # 2048 walkers on the CPU: about a minute

H2O (h2o_setup) in float64, 2 x 10 VMC steps from initial_guess, then
TBDMAccumulator over the first 8 MOs for spins (0, 0) and (0, 1), as
chip_smoke.py phase 27 builds them, on one draw of the auxiliary points,
three ways: float64; float32 (walkers, parameters and draws cast) on the
orbitals' default route, which on a CUDA device evaluates the float32
value-only orbitals on K3 and on the CPU runs K3's plain version; and
float32 inside plain_orbitals(). Prints, per spin pair and per pair of
ways, phase 27's error measure (the largest |x - y| over the walker's
largest |y|): its largest value and median over the walkers, and for the
same-spin pair the worst walker's smallest |ratio| of moving an electron
e1 to its auxiliary point r1 (the forced move on which every same-spin
ratio at r2 is taken).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pyqmc_tpu_torch.entry import h2o_setup  # noqa: E402
from pyqmc_tpu_torch.method.vmc import vmc  # noqa: E402
from pyqmc_tpu_torch.models.orbitals import plain_orbitals  # noqa: E402
from pyqmc_tpu_torch.observables.tbdm import TBDMAccumulator  # noqa: E402
from pyqmc_tpu_torch.system.io import load_npz  # noqa: E402

NCAS = 8


def cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def per_walker(x, y):
    """The largest |x - y| over the walker's largest |y|, per walker."""
    x, y = x.double().reshape(x.shape[0], -1), y.double().reshape(y.shape[0], -1)
    return (torch.amax(torch.abs(x - y), dim=1) / torch.amax(torch.abs(y), dim=1)).cpu().numpy()


def main(nconf=2048, device="cpu"):
    torch.set_num_threads(4)
    mol, wf, params, configs, acc = h2o_setup(nconf, device=device, dtype=torch.float64)
    _, configs = vmc(wf, params, configs, nblocks=2, nsteps_per_block=10, accumulators=acc,
                     generator=torch.Generator(device=device).manual_seed(27))
    x = configs.positions
    mo = load_npz()[1].mo_coeff[0][:, :NCAS]
    for spin, seed in (((0, 0), 303), ((0, 1), 302)):
        tb = TBDMAccumulator(mol, mo, spin=spin)
        draws = {k: v[0] for k, v in tb.draw(torch.Generator(device=device).manual_seed(seed), 1,
                                             nconf, device, torch.float64).items()}

        def tbdm(dtype):
            p, xd = cast(params, dtype), x.to(dtype)
            return tb(wf, p, wf.recompute(p, xd), xd, draws=cast(draws, dtype))["value"]

        ways = {"float64": tbdm(torch.float64), "float32": tbdm(torch.float32)}
        with plain_orbitals():
            ways["float32 plain_orbitals"] = tbdm(torch.float32)
        pairs = (("float32", "float32 plain_orbitals"), ("float32 plain_orbitals", "float64"),
                 ("float32", "float64"))
        errs = {f"{a} against {b}": per_walker(ways[a], ways[b]) for a, b in pairs}
        line = f"tbdm{spin[0]}{spin[1]}, {nconf} walkers on {device}: " + "; ".join(
            f"{k} max {v.max():.3e} median {np.median(v):.3e}" for k, v in errs.items())
        if spin == (0, 0):
            worst = int(np.argmax(errs["float32 against float32 plain_orbitals"]))
            st = wf.recompute(params, x)
            r1 = min(float(torch.abs(wf.testvalue(params, st, e, draws["r1"])[0][worst]))
                     for e in range(mol.nelec[0]))
            line += (f"; the worst walker of the first pair: smallest |ratio(e1 -> r1)| "
                     f"{r1:.3e}")
        print(line, flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[0]) if args else 2048, args[1] if len(args) > 1 else "cpu")

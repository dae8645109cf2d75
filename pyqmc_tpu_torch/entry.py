"""The port's main path, set up as a user would (counterpart of
`__graft_entry__._h2o_setup`): ccECP/cc-pVDZ H2O, 8 valence electrons and
23 AOs, Slater-Jastrow, with the energy accumulator and its dense nonlocal
ECP quadrature.

    mol, wf, params, configs, acc = h2o_setup(nconf=2048, device="cuda",
                                              dtype=torch.float32)
    blocks, configs = vmc(wf, params, configs, nblocks=4,
                          nsteps_per_block=50, accumulators=acc)
"""

from __future__ import annotations

import torch

from .configs import initial_guess
from .models.jastrow import JastrowSpin
from .models.multiply import MultiplyWF
from .models.slater import Slater
from .observables.accumulators import EnergyAccumulator
from .system.io import H2O_CCECP, load_npz
from .utils.dtypes import real_dtype


def h2o_setup(nconf, device="cpu", dtype=None, seed=0, path=H2O_CCECP):
    """(mol, wf, params, configs, accumulators) of the headline system, read
    from the committed SCF checkpoint. dtype defaults to float32 on a CUDA
    device and float64 elsewhere; walkers come from `seed`."""
    dtype = dtype or real_dtype(device)
    mol, mf = load_npz(path)
    wf = MultiplyWF(Slater.from_mean_field(mf), JastrowSpin(mol))
    params = wf.make_params(device, dtype)
    configs = initial_guess(mol, nconf, generator=torch.Generator().manual_seed(seed),
                            device=device, dtype=dtype)
    acc = {"energy": EnergyAccumulator(mol)}
    return mol, wf, params, configs, acc

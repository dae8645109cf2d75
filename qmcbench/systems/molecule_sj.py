"""A molecule's Slater-Jastrow system, built twice from one configuration
file: the program's objects (`pyqmc_tpu_torch`) for the timed window, and
the plain reference (`qmcbench.reference.molecule_sj`) that judges it.

Both sides get the same inputs: the system file, the Jastrow coefficients
drawn from the seed (`draw_jastrow`) and, per block, the same random
streams. The walkers start from `initial_guess` on a generator on the
walkers' device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bounds, harness
from ..reference import molecule_sj as reference


def draw_jastrow(config, natom, seed):
    """{acoeff (natom, na, 2), bcoeff (nb, 3)} numpy: every electron-ion
    coefficient normal with the configuration's `acoeff_scale`, every
    electron-electron one its cusp row plus normal noise of `bcoeff_scale`
    (so no factor of the Jastrow is trivially zero)."""
    j = config["jastrow"]
    rng = np.random.default_rng(np.random.SeedSequence([seed, harness.STREAM_JASTROW]))
    na, nb = len(j["ei_basis"]), len(j["ee_basis"])
    acoeff = rng.normal(scale=j["acoeff_scale"], size=(natom, na, 2))
    cusp = np.zeros((nb, 3))
    cusp[0] = j["cusp_row"]
    bcoeff = cusp + rng.normal(scale=j["bcoeff_scale"], size=(nb, 3))
    return {"acoeff": acoeff, "bcoeff": bcoeff}


class System:
    """wf, params, configs and energy accumulator of the program; the
    reference's wavefunction on demand (`reference_wf`)."""

    def __init__(self, config, nconf, seed, device, dtype):
        from pyqmc_tpu_torch.configs import initial_guess
        from pyqmc_tpu_torch.models.jastrow import JastrowSpin
        from pyqmc_tpu_torch.models.multiply import MultiplyWF
        from pyqmc_tpu_torch.models.slater import Slater
        from pyqmc_tpu_torch.system.io import load_npz

        self.config, self.device, self.dtype = config, torch.device(device), dtype
        self.path = harness.repo_path(config["data"])
        mol, mf = load_npz(self.path)
        self.mol = mol
        self.wf = MultiplyWF(Slater.from_mean_field(mf), JastrowSpin(mol))
        self.params = self.wf.make_params(device, dtype)
        self.jastrow = draw_jastrow(config, len(mol.atom_coords), seed)
        for k, v in self.jastrow.items():
            self.params["wf1"][k] = torch.as_tensor(v, dtype=dtype, device=device)
        gen = harness.generator(seed, harness.STREAM_WALKERS, device)
        self.configs = initial_guess(mol, nconf, generator=gen, device=device, dtype=dtype)
        self.energy = harness.recording_energy(mol)
        self.nelec = sum(mol.nelec)

    def release(self):
        """Drop the program's walkers and its cached device memory."""
        self.configs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def shapes(self):
        return bounds.Shapes(reference.load_system(self.path), self.config)

    def reference_wf(self, device, dtype=torch.float64):
        return reference.SlaterJastrow(reference.load_system(self.path), self.jastrow, device,
                                       dtype, bases=self.config["jastrow"])

"""A supercell's Slater-Jastrow system, built twice from one configuration
file: the program's objects (`pyqmc_tpu_torch`: the supercell, k-point
orbitals, the periodic Jastrow, Ewald and the downselected ECP) for the
timed window, and the plain reference (`qmcbench.reference.crystal_sj`).

Both sides get the same inputs: the primitive cell's file, the Jastrow
coefficients drawn from the seed and, per block, the same random streams.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import bounds, harness
from ..reference import crystal_sj as reference
from .molecule_sj import draw_jastrow


class System:
    def __init__(self, config, nconf, seed, device, dtype):
        from pyqmc_tpu_torch.configs import initial_guess
        from pyqmc_tpu_torch.models.jastrow import JastrowSpin
        from pyqmc_tpu_torch.models.multiply import MultiplyWF
        from pyqmc_tpu_torch.models.orbitals import KPointOrbitals
        from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
        from pyqmc_tpu_torch.models.func3d import BasisFn
        from pyqmc_tpu_torch.system.io import load_cell_npz
        from pyqmc_tpu_torch.system.supercell import get_supercell

        self.config, self.device, self.dtype = config, torch.device(device), dtype
        self.path = harness.repo_path(config["data"])
        cell, data = load_cell_npz(self.path)
        sup = get_supercell(cell, np.asarray(config["supercell"]))
        nocc = config["occupied_per_kpoint"]
        kpts = np.asarray(data["kpts"])
        blocks = [np.asarray(data["mo_coeff"][k])[:, :nocc] for k in range(len(kpts))]
        orb = KPointOrbitals(cell, kpts, (blocks, blocks), img_tol=config["img_tol"])
        norb = nocc * len(kpts)
        slater = Slater(sup, orbitals=orb, expansion=DeterminantExpansion.single(norb, norb))
        basis = lambda spec: [BasisFn(kind, p, rcut) for kind, p, rcut in spec]
        jastrow = JastrowSpin(sup, a_basis=basis(config["jastrow"]["ei_basis"]),
                              b_basis=basis(config["jastrow"]["ee_basis"]))
        self.wf = MultiplyWF(slater, jastrow)
        self.params = self.wf.make_params(device, dtype)
        self.jastrow = draw_jastrow(config, len(sup.atom_coords), seed)
        for k, v in self.jastrow.items():
            self.params["wf1"][k] = torch.as_tensor(v, dtype=dtype, device=device)
        gen = harness.generator(seed, harness.STREAM_WALKERS, device)
        self.configs = initial_guess(sup, nconf, generator=gen, device=device, dtype=dtype)
        self.energy = harness.recording_energy(sup)
        self.nelec = sum(sup.nelec)

    def release(self):
        self.configs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_system(self):
        c = self.config
        return reference.load_crystal(self.path, c["supercell"], c["occupied_per_kpoint"],
                                      c["img_tol"])

    def shapes(self):
        """The counts of the supercell, its orbitals over the replicated shells."""
        system = self.reference_system()
        system["shells"] = reference.replicated_shells(system)[0]
        return bounds.Shapes(system, self.config)

    def reference_wf(self, device, dtype=torch.float64):
        return reference.CrystalSJ(self.reference_system(), self.jastrow, device, dtype,
                                   bases=self.config["jastrow"], rmax=self.config["ecp"]["rmax"],
                                   nselect=self.config["ecp"]["nselect"])

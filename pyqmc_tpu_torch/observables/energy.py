"""Local-energy pieces: kinetic and open-boundary Coulomb (counterpart of
pyqmc_tpu/observables/energy.py). Plain PyTorch: at the main path's basis
size the JAX package runs no kernel here either."""

import numpy as np
import torch

from ..utils.constants import DeviceConstants


def kinetic_energy(wf, params, state, positions):
    """(-1/2 sum_e lap_e psi / psi, sum_e |grad_e psi / psi|^2), each (nconf,)."""
    lap = grad2 = 0.0
    for e in range(positions.shape[1]):
        g, l = wf.gradient_laplacian(params, state, e, positions[:, e, :])
        lap = lap + l
        grad2 = grad2 + torch.sum(g * g, dim=-1)
    return -0.5 * lap, grad2


class OpenCoulomb:
    """Electron-electron, electron-ion and ion-ion energies, open boundary."""

    def __init__(self, mol):
        self.atom_coords = np.asarray(mol.atom_coords)
        self.atom_charges = np.asarray(mol.atom_charges, dtype=np.float64)
        self.ii = mol.nuclear_repulsion()
        self._const = DeviceConstants(atoms=self.atom_coords, charges=self.atom_charges)

    def energy(self, positions):
        """(ee, ei, ii), each (nconf,)."""
        nconf, nelec = positions.shape[:2]
        dev, dtype = positions.device, positions.dtype
        d = positions[:, :, None, :] - positions[:, None, :, :]
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        iu = torch.triu_indices(nelec, nelec, offset=1, device=dev)
        ee = torch.sum(1.0 / r[:, iu[0], iu[1]], dim=-1)
        c = self._const.get(dev, dtype)
        atoms, charges = c["atoms"], c["charges"]
        dei = positions[:, :, None, :] - atoms[None, None]
        rei = torch.sqrt(torch.sum(dei * dei, dim=-1))
        ei = -torch.sum(charges[None, None, :] / rei, dim=(1, 2))
        return ee, ei, torch.full((nconf,), self.ii, dtype=dtype, device=dev)

"""Local-energy pieces: kinetic and open-boundary Coulomb (counterpart of
pyqmc_tpu/observables/energy.py). The kinetic energy is batched over chunks
of electrons, as the JAX package vmaps it: one gradient-laplacian
evaluation per chunk, so the orbitals of a chunk's electrons at every
walker are one point set (K6's launch on the periodic path)."""

import numpy as np
import torch

from ..utils.constants import DeviceConstants


def kinetic_energy(wf, params, state, positions, echunk="auto"):
    """(-1/2 sum_e lap_e psi / psi, sum_e |grad_e psi / psi|^2), each (nconf,).

    echunk electrons per evaluation; "auto" bounds a chunk at 16384
    (electron, walker) points (observables/energy.py:14-90)."""
    from ..models.multiply import default_gradient_laplacian_many

    nconf, nelec = positions.shape[:2]
    if echunk == "auto":
        echunk = max(1, 16384 // max(nconf, 1))
    lap = grad2 = 0.0
    for c0 in range(0, nelec, echunk):
        es = tuple(range(c0, min(c0 + echunk, nelec)))
        g, l = default_gradient_laplacian_many(wf, params, state, es, positions[:, c0:c0 + len(es)])
        lap = lap + torch.sum(l, dim=1)
        grad2 = grad2 + torch.sum(g * g, dim=(1, 2))
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

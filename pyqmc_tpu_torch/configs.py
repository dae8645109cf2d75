"""Walker state (counterpart of pyqmc_tpu/configs.py, open boundary).

`Configs` holds positions (nconf, nelec, 3) and integer wrap counts;
`Geometry` describes the boundary. Periodic lattices come with the periodic
slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


class Geometry:
    """Open-boundary geometry: `enforce` is the identity."""

    def __init__(self, lattice=None):
        if lattice is not None:
            raise NotImplementedError("periodic geometries are not ported yet")
        self.lattice = None

    @property
    def periodic(self) -> bool:
        return False

    def enforce(self, epos):
        """Fold epos into the cell; returns (wrapped, wrap delta)."""
        return epos, torch.zeros(epos.shape, dtype=torch.int32, device=epos.device)


@dataclasses.dataclass
class Configs:
    """Walker ensemble: positions (nconf, nelec, 3) and integer wrap counts."""

    positions: torch.Tensor
    wrap: torch.Tensor
    geometry: Geometry

    @staticmethod
    def create(positions, geometry: Optional[Geometry] = None, wrap=None):
        geometry = geometry or Geometry()
        if wrap is None:
            wrap = torch.zeros(positions.shape, dtype=torch.int32, device=positions.device)
        return Configs(positions=positions, wrap=wrap, geometry=geometry)


def initial_guess(mol, nconfig, r=1.0, generator: Optional[torch.Generator] = None,
                  device="cpu", dtype=torch.float64):
    """Place electrons near nuclei in proportion to their (effective) charge,
    plus Gaussian noise of width r (reference method/mc.py:25-73).

    The noise is drawn in float64 on the generator's device (CPU by
    default), so a seed gives the same walkers on every device.
    """
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    coords = np.asarray(mol.atom_coords)
    charges = np.asarray(mol.atom_charges, dtype=int)
    nup, ndn = mol.nelec
    centers = []
    for spin_count in (nup, ndn):
        remaining = charges.copy().astype(float)
        for _ in range(spin_count):
            i = int(np.argmax(remaining))
            centers.append(coords[i])
            remaining[i] -= 1.0
    centers = torch.as_tensor(np.stack(centers, axis=0), dtype=torch.float64,
                              device=generator.device)
    noise = torch.randn((nconfig, centers.shape[0], 3), generator=generator,
                        dtype=torch.float64, device=generator.device) * r
    positions = (centers[None] + noise).to(device=device, dtype=dtype)
    return Configs.create(positions, Geometry())

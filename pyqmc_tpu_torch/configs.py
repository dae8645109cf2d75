"""Walker state (counterpart of pyqmc_tpu/configs.py).

`Configs` holds positions (nconf, nelec, 3) and integer wrap counts;
`Geometry` describes the boundary: open, or a periodic lattice whose
minimal image and wrap it provides.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .ops import distances as _dist
from .ops.pbc import enforce_pbc
from .utils.constants import DeviceConstants
from .utils.dtypes import real_dtype, resolve_device


class Geometry:
    """Open boundary, or a periodic lattice (rows are lattice vectors)."""

    def __init__(self, lattice=None):
        self.lattice = None if lattice is None else np.asarray(lattice, dtype=np.float64)
        self.lattice_inv = None if lattice is None else np.linalg.inv(self.lattice)
        self.mode = _dist.classify_lattice(self.lattice)
        self._const = None
        if self.lattice is not None:
            self._const = DeviceConstants(lat=self.lattice, lat_inv=self.lattice_inv,
                                          shifts=_dist._image_shifts(self.lattice))

    @property
    def periodic(self) -> bool:
        return self.lattice is not None

    def _tensors(self, like):
        c = self._const.get(like.device, like.dtype)
        return c["lat"], c["lat_inv"], c["shifts"]

    def minimal_image(self, d):
        if not self.periodic:
            return d
        lat, inv, shifts = self._tensors(d)
        return _dist.minimal_image(d, lat, inv, self.mode, shifts)

    def half_min_height(self):
        """Half the smallest interplanar spacing: the inradius of the
        fractional rounding cell."""
        if not self.periodic:
            return np.inf
        return 0.5 * float(np.min(1.0 / np.linalg.norm(self.lattice_inv, axis=0)))

    def minimal_image_for(self, rcut):
        """Minimal image for pair functions that vanish beyond rcut.

        Fractional rounding is exact below half the smallest interplanar
        spacing, and where it picks another image both distances are at
        least that; so for rcut up to it rounding gives the same pair
        function values as the 27-image search (configs.py:75-106)."""
        if self.mode in (_dist.MODE_OPEN, _dist.MODE_DIAGONAL, _dist.MODE_ORTHORHOMBIC):
            return self.minimal_image
        if rcut is not None and rcut <= self.half_min_height() + 1e-9:
            def round_mi(d):
                lat, inv, _ = self._tensors(d)
                return _dist.minimal_image(d, lat, inv, _dist.MODE_ORTHORHOMBIC)

            return round_mi
        return self.minimal_image

    def enforce(self, epos):
        """Fold epos into the cell; returns (wrapped, wrap delta int32)."""
        if not self.periodic:
            return epos, torch.zeros(epos.shape, dtype=torch.int32, device=epos.device)
        lat, inv, _ = self._tensors(epos)
        return enforce_pbc(lat, inv, epos)


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
                  device=None, dtype=None):
    """Place electrons near nuclei in proportion to their (effective) charge,
    plus Gaussian noise of width r (reference method/mc.py:25-73), folded
    into the cell for a periodic system.

    The walkers land on the GPU unless `device` says otherwise
    (utils/dtypes.resolve_device); dtype defaults to real_dtype(device).
    The noise is drawn in float64 on the generator's device (CPU by
    default), so a seed gives the same walkers on every device.
    """
    device = resolve_device(device)
    dtype = dtype or real_dtype(device)
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
    geometry = Geometry(getattr(mol, "lattice", None))
    if geometry.periodic:
        positions, wrap = geometry.enforce(positions)
        return Configs.create(positions, geometry, wrap=wrap)
    return Configs.create(positions, geometry)

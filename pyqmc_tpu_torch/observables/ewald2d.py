"""2D-periodic (slab) Ewald summation, Yeh-Berkowitz / Parry form
(counterpart of pyqmc_tpu/observables/ewald2d.py).

For a cell periodic in the xy-plane (lattice rows 0 and 1; z open):

  psi(r) = sum_L erfc(a|r+L|)/|r+L|
         + (pi/Area) sum_{G!=0} (1/G) [ e^{G z} erfc(a z + G/2a)
                                      + e^{-G z} erfc(-a z + G/2a) ] cos(G.rho)
         - (2 sqrt(pi)/Area) [ e^{-a^2 z^2}/a + sqrt(pi) z erf(a z) ]

  xi = lim_{r->0} (psi - 1/r)
     = sum_{L!=0} erfc(a|L|)/|L| + sum_G w_G(0) - 2 sqrt(pi)/(a Area)
       - 2 a/sqrt(pi)

The set-up (images, G vectors, xi) and the ion-ion constant run on the host
in float64 numpy and scipy (`psi_host`); `energy` evaluates psi in torch on
the walkers' device, in their dtype. The sums over G carry e^{+-G z}, so
the electrons must stay within a few 1/G of the plane (|G z| below about
80 in float32, 700 in float64).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import erf as np_erf, erfc as np_erfc

from ..utils.constants import DeviceConstants


def _gpoints_2d(lat2, alpha, tol=1e-10):
    recip = 2.0 * np.pi * np.linalg.inv(lat2).T  # (2, 2) rows
    gmax = 2.0 * alpha * np.sqrt(-np.log(tol))
    bh = 1.0 / np.linalg.norm(np.linalg.inv(recip), axis=0)
    nm = np.maximum(1, np.ceil(gmax / bh).astype(int))
    rngs = [np.arange(-n, n + 1) for n in nm]
    pts = np.array(np.meshgrid(*rngs, indexing="ij")).reshape(2, -1).T
    keep = [n for n in pts if n[0] > 0 or (n[0] == 0 and n[1] > 0)]  # half space
    G = np.array(keep) @ recip
    Gn = np.linalg.norm(G, axis=1)
    sel = np_erfc(Gn / (2 * alpha)) / Gn > tol * 1e-3
    return G[sel], Gn[sel]


def _images_2d(lat2, alpha, tol=1e-10):
    rcut = np.sqrt(-np.log(tol)) / alpha
    h = 1.0 / np.linalg.norm(np.linalg.inv(lat2), axis=0)
    nm = np.maximum(1, np.ceil((rcut + np.linalg.norm(lat2.sum(0))) / h).astype(int))
    rngs = [np.arange(-n, n + 1) for n in nm]
    pts = np.array(np.meshgrid(*rngs, indexing="ij")).reshape(2, -1).T
    L = pts @ lat2
    return np.concatenate([L, np.zeros((len(L), 1))], axis=1)


class Ewald2D:
    """Slab Coulomb for cells periodic in rows 0 and 1 of the lattice."""

    def __init__(self, cell, alpha=None, tol=1e-10):
        lat2 = np.asarray(cell.lattice)[:2, :2]
        self.area = abs(np.linalg.det(lat2))
        h = 1.0 / np.linalg.norm(np.linalg.inv(lat2), axis=0)
        self.alpha = alpha if alpha is not None else 5.0 / min(h)
        self.gpoints, self.gnorms = _gpoints_2d(lat2, self.alpha, tol)
        self.images = _images_2d(lat2, self.alpha, tol)
        a, A = self.alpha, self.area
        Ln = np.linalg.norm(self.images, axis=1)
        nz = Ln > 1e-12
        wg0 = 2.0 * (np.pi / A) * (2.0 * np_erfc(self.gnorms / (2 * a)) / self.gnorms)  # x2: half space
        self.xi = (float(np.sum(np_erfc(a * Ln[nz]) / Ln[nz])) + float(np.sum(wg0))
                   - 2.0 * np.sqrt(np.pi) / (a * A) - 2.0 * a / np.sqrt(np.pi))
        self.atom_coords = np.asarray(cell.atom_coords)
        self.atom_charges = np.asarray(cell.atom_charges, dtype=np.float64)
        self.ii_const = self._ion_ion()
        self._const = DeviceConstants(images=self.images, gpoints=self.gpoints,
                                      gnorms=self.gnorms, atom_coords=self.atom_coords,
                                      atom_charges=self.atom_charges)

    def psi_host(self, r):
        """psi at displacements r (..., 3), float64 numpy, flattened to (n,)."""
        r = np.asarray(r, dtype=np.float64).reshape(-1, 3)
        a, A = self.alpha, self.area
        d = r[:, None, :] + self.images[None]
        dn = np.linalg.norm(d, axis=-1)
        real = np.sum(np_erfc(a * dn) / dn, axis=1)
        z = r[:, 2]
        G, Gn = self.gpoints, self.gnorms
        zz = z[:, None]
        f = (np.exp(Gn[None] * zz) * np_erfc(a * zz + Gn[None] / (2 * a))
             + np.exp(-Gn[None] * zz) * np_erfc(-a * zz + Gn[None] / (2 * a)))
        rec = 2.0 * (np.pi / A) * np.sum(np.cos(r[:, :2] @ G.T) * f / Gn[None], axis=1)
        g0 = -(2.0 * np.sqrt(np.pi) / A) * (np.exp(-(a * z) ** 2) / a
                                           + np.sqrt(np.pi) * z * np_erf(a * z))
        return real + rec + g0

    def _ion_ion(self):
        n = len(self.atom_charges)
        e = 0.5 * np.sum(self.atom_charges**2) * self.xi
        for i in range(n):
            for j in range(i + 1, n):
                e += (self.atom_charges[i] * self.atom_charges[j]
                      * self.psi_host(self.atom_coords[i] - self.atom_coords[j])[0])
        return float(e)

    def _psi_dev(self, r):
        """psi at displacements r (..., 3), on r's device in its dtype."""
        c = self._const.get(r.device, r.dtype)
        a, A = self.alpha, self.area
        d = r[..., None, :] + c["images"]
        dn = torch.sqrt(torch.sum(d * d, dim=-1))
        real = torch.sum(torch.special.erfc(a * dn) / dn, dim=-1)
        z = r[..., 2]
        G, Gn = c["gpoints"], c["gnorms"]
        zz = z[..., None]
        f = (torch.exp(Gn * zz) * torch.special.erfc(a * zz + Gn / (2 * a))
             + torch.exp(-Gn * zz) * torch.special.erfc(-a * zz + Gn / (2 * a)))
        cosg = torch.cos(r[..., :2] @ G.T)
        rec = 2.0 * (np.pi / A) * torch.sum(cosg * f / Gn, dim=-1)
        g0 = -(2.0 * np.sqrt(np.pi) / A) * (torch.exp(-((a * z) ** 2)) / a
                                           + np.sqrt(np.pi) * z * torch.erf(a * z))
        return real + rec + g0

    def energy(self, positions):
        """(ee, ei, ii) per walker for positions (nconf, ne, 3)."""
        c = self._const.get(positions.device, positions.dtype)
        nconf, ne = positions.shape[:2]
        if ne > 1:
            i, j = torch.triu_indices(ne, ne, 1, device=positions.device)
            ee = torch.sum(self._psi_dev(positions[:, i, :] - positions[:, j, :]), dim=-1)
        else:
            ee = torch.zeros(nconf, dtype=positions.dtype, device=positions.device)
        ee = ee + 0.5 * ne * self.xi
        dei = positions[:, :, None, :] - c["atom_coords"][None, None]
        ei = -torch.einsum("I,cnI->c", c["atom_charges"], self._psi_dev(dei))
        ii = torch.full((nconf,), self.ii_const, dtype=positions.dtype, device=positions.device)
        return ee, ei, ii

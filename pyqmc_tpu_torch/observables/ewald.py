"""3D Ewald summation (counterpart of pyqmc_tpu/observables/ewald.py).

  psi(r) = sum_L erfc(a|r+L|)/|r+L| + sum_G w_G cos(G.r) - pi/(V a^2)
  xi     = sum_{L!=0} erfc(a|L|)/|L| + sum_G w_G - pi/(V a^2) - 2a/sqrt(pi)

  E_ee = sum_{i<j} psi(r_ij) + (ne/2) xi
  E_ii = sum_{I<J} Z_I Z_J psi(R_IJ) + (sum_I Z_I^2 / 2) xi   [host, once]
  E_ei = - sum_{i,I} Z_I psi(r_iI)

with w_G = 2 (4 pi / V) exp(-G^2/(4 a^2)) / G^2 over half of G space.
Reciprocal sums go through structure factors, real-space sums over a fixed
image set; alpha = 5 / min cell height, G vectors kept while w_G > 1e-10.
The G vectors, images and constants are built on the host in float64
(scipy's erfc) and copied to the device once.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import erfc as np_erfc

from ..utils.constants import DeviceConstants


def _select_gpoints(lattice, alpha, tol=1e-10):
    recip = 2.0 * np.pi * np.linalg.inv(lattice).T  # rows
    volume = abs(np.linalg.det(lattice))
    gmax = 2.0 * alpha * np.sqrt(-np.log(tol))
    bheights = 1.0 / np.linalg.norm(np.linalg.inv(recip), axis=0)
    nmaxs = np.maximum(1, np.ceil(gmax / bheights).astype(int))
    pts = np.array(np.meshgrid(*[np.arange(-n, n + 1) for n in nmaxs], indexing="ij")).reshape(3, -1).T
    # half space: first nonzero component positive
    keep = [n for n in pts
            if n[0] > 0 or (n[0] == 0 and (n[1] > 0 or (n[1] == 0 and n[2] > 0)))]
    G = np.array(keep) @ recip
    G2 = np.sum(G * G, axis=1)
    w = 2.0 * (4.0 * np.pi / volume) * np.exp(-G2 / (4 * alpha**2)) / G2
    sel = w > tol
    return G[sel], w[sel]


def _image_set(lattice, alpha, tol=1e-10):
    """Lattice translations the erfc sums need."""
    rcut = np.sqrt(-np.log(tol)) / alpha
    heights = 1.0 / np.linalg.norm(np.linalg.inv(lattice), axis=0)
    nimg = np.maximum(1, np.ceil(rcut / heights).astype(int))
    pts = np.array(np.meshgrid(*[np.arange(-n, n + 1) for n in nimg], indexing="ij")).reshape(3, -1).T
    return pts @ lattice


class Ewald:
    def __init__(self, cell, alpha=None, gtol=1e-10):
        lattice = np.asarray(cell.lattice, dtype=np.float64)
        self.lattice = lattice
        self.volume = abs(np.linalg.det(lattice))
        heights = 1.0 / np.linalg.norm(np.linalg.inv(lattice), axis=0)
        self.alpha = alpha if alpha is not None else 5.0 / np.min(heights)
        self.gpoints, self.gweights = _select_gpoints(lattice, self.alpha, gtol)
        self.images = _image_set(lattice, self.alpha)
        a, V = self.alpha, self.volume
        Lnorm = np.linalg.norm(self.images, axis=1)
        nz = Lnorm > 1e-12
        self.xi = (float(np.sum(np_erfc(a * Lnorm[nz]) / Lnorm[nz])) + float(np.sum(self.gweights))
                   - np.pi / (V * a * a) - 2.0 * a / np.sqrt(np.pi))
        self.atom_coords = np.asarray(cell.atom_coords)
        self.atom_charges = np.asarray(cell.atom_charges, dtype=np.float64)
        self.ii_const = self._ion_ion()
        phases = self.atom_coords @ self.gpoints.T  # (natom, nG)
        self.sion_re = np.cos(phases).T @ self.atom_charges
        self.sion_im = np.sin(phases).T @ self.atom_charges
        self._const = DeviceConstants(images=self.images, gp_t=self.gpoints.T, gw=self.gweights,
                                      atoms=self.atom_coords, charges=self.atom_charges,
                                      sion_re=self.sion_re, sion_im=self.sion_im)

    def psi_host(self, r):
        r = np.asarray(r, dtype=np.float64).reshape(-1, 3)
        dn = np.linalg.norm(r[:, None, :] + self.images[None, :, :], axis=-1)
        real = np.sum(np_erfc(self.alpha * dn) / dn, axis=1)
        rec = np.cos(r @ self.gpoints.T) @ self.gweights
        return real + rec - np.pi / (self.volume * self.alpha**2)

    def _ion_ion(self):
        n = len(self.atom_charges)
        e = 0.5 * np.sum(self.atom_charges**2) * self.xi
        for i in range(n):
            for j in range(i + 1, n):
                e += (self.atom_charges[i] * self.atom_charges[j]
                      * self.psi_host(self.atom_coords[i] - self.atom_coords[j])[0])
        return float(e)

    def energy(self, positions):
        """(ee, ei, ii) per walker, each (nconf,); positions (nconf, ne, 3)."""
        nconf, ne = positions.shape[:2]
        dtype, dev = positions.dtype, positions.device
        c = self._const.get(dev, dtype)
        images, a = c["images"], self.alpha
        backg = np.pi / (self.volume * self.alpha**2)
        # ee real space: pairs i < j over all images
        iu = torch.triu_indices(ne, ne, offset=1, device=dev)
        dpair = positions[:, iu[0]] - positions[:, iu[1]]  # (c, npair, 3)
        dimg = dpair[:, :, None, :] + images[None, None]
        dist = torch.sqrt(torch.sum(dimg * dimg, dim=-1))
        ee_real = torch.sum(torch.special.erfc(a * dist) / dist, dim=(1, 2))
        # ee reciprocal through the structure factor
        phase = positions @ c["gp_t"]  # (c, ne, nG)
        s_re = torch.sum(torch.cos(phase), dim=1)
        s_im = torch.sum(torch.sin(phase), dim=1)
        ee_rec = 0.5 * torch.sum(c["gw"][None, :] * (s_re * s_re + s_im * s_im - ne), dim=1)
        ee = ee_real + ee_rec - ne * (ne - 1) / 2.0 * backg + 0.5 * ne * self.xi
        # ei real space and reciprocal
        dei = positions[:, :, None, :] - c["atoms"][None, None]
        deimg = dei[:, :, :, None, :] + images[None, None, None]
        deidist = torch.sqrt(torch.sum(deimg * deimg, dim=-1))
        ei_real = -torch.sum(c["charges"][None, None, :, None] * torch.special.erfc(a * deidist)
                             / deidist, dim=(1, 2, 3))
        ei_rec = -torch.sum(c["gw"][None, :] * (s_re * c["sion_re"][None, :]
                                                + s_im * c["sion_im"][None, :]), dim=1)
        ei = ei_real + ei_rec + ne * float(np.sum(self.atom_charges)) * backg
        return ee, ei, torch.full((nconf,), self.ii_const, dtype=dtype, device=dev)

"""Bilinear pair Jastrows (counterpart of pyqmc_tpu/models/generic_jastrow.py):

    U = sum_{i<j} phi(r_i)^T A phi(r_j) = 1/2 (S^T A S - sum_i phi_i^T A phi_i),

S = sum_i phi(r_i), A symmetric. The state keeps the positions, U, each
electron's feature row phi_i and their sum S, so a move of electron e costs
O(F) whatever the number of electrons:

    dU(e -> x) = (phi(x) - phi_e)^T A (S - phi_e).

dU is linear in phi(x), so its gradient and laplacian are A (S - phi_e)
contracted with the feature map's own gradient and laplacian, which both
feature maps give analytically (the JAX package takes them by autodiff):

  * GeminalJastrow: phi = the AOs (eval_gto's mode 2), A = sym(gcoeff); on a
    cell the gamma-point supercell AOs, each AO summed over the lattice
    images that reach the home cell, the point folded into the home cell
    first (pyqmc_tpu/models/generic_jastrow.py:162-239);
  * GPSJastrow: phi_{s,t}(x) = exp(-f |x - X_st|^2), t = 0, 1, and
    phi^T A psi = sum_s alpha_s (phi_s0 psi_s1 + phi_s1 psi_s0).

Subclasses define `features(params, xyz, derivs)` -> phi (..., F), or with
derivs (phi, grad (..., 3, F), lap (..., F)); `bilinear(params, u, v)`
(u^T A v over the last axis, broadcast over the rest); and `pgradient`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.gto import GTOSpec, eval_gto
from ..utils.constants import DeviceConstants
from ..utils.dtypes import real_dtype, resolve_device


class GenericJastrowState(NamedTuple):
    positions: torch.Tensor  # (nconf, nelec, 3)
    u: torch.Tensor  # (nconf,)
    phi: torch.Tensor  # (nconf, nelec, F) per-electron feature rows
    ssum: torch.Tensor  # (nconf, F) their sum


class GenericJastrow:
    """exp(U) for U = sum_{i<j} phi(r_i)^T A phi(r_j)."""

    def __init__(self, nelec):
        self.nelec = nelec

    def features(self, params, xyz, derivs=False):
        raise NotImplementedError

    def bilinear(self, params, u, v):
        raise NotImplementedError

    # --- protocol ----------------------------------------------------------
    def recompute(self, params, positions):
        phi = self.features(params, positions)
        s = torch.sum(phi, dim=1)
        diag = torch.sum(self.bilinear(params, phi, phi), dim=1)
        return GenericJastrowState(positions, 0.5 * (self.bilinear(params, s, s) - diag), phi, s)

    def value(self, params, state):
        return torch.ones_like(state.u), state.u

    def _rest(self, state, e):
        """phi_e and S - phi_e of electron e."""
        phi_e = state.phi[:, e]
        return phi_e, state.ssum - phi_e

    def testvalue(self, params, state, e, epos):
        phi_e, rest = self._rest(state, e)
        eph = self.features(params, epos)
        if epos.ndim == 3:  # a point axis: (nconf, A, 3)
            phi_e, rest = phi_e[:, None], rest[:, None]
        du = self.bilinear(params, eph - phi_e, rest)
        return torch.exp(du), {"du": du, "phi": eph}

    def testvalue_many(self, params, state, epos):
        """exp(dU_e) for each electron e moved to epos (nconf, 3):
        (nconf, nelec)."""
        eph = self.features(params, epos)[:, None]
        du = self.bilinear(params, eph - state.phi, state.ssum[:, None] - state.phi)
        return torch.exp(du)

    def _derivs(self, params, state, e, epos):
        """(du, grad du, lap du, phi) of electron e at epos (nconf, 3)."""
        phi_e, rest = self._rest(state, e)
        eph, gph, lph = self.features(params, epos, derivs=True)
        return (self.bilinear(params, eph - phi_e, rest),
                self.bilinear(params, gph, rest[:, None]), self.bilinear(params, lph, rest), eph)

    def gradient(self, params, state, e, epos):
        return self._derivs(params, state, e, epos)[1]

    def gradient_value(self, params, state, e, epos):
        du, g, _, eph = self._derivs(params, state, e, epos)
        return g, torch.exp(du), {"du": du, "phi": eph}

    def gradient_laplacian(self, params, state, e, epos):
        _, g, lap, _ = self._derivs(params, state, e, epos)
        return g, lap + torch.sum(g * g, dim=-1)

    def updateinternals(self, params, state, e, epos, mask, saved):
        m = mask[:, None]
        phi_e = state.phi[:, e]
        new_e = torch.where(m, saved["phi"], phi_e)
        newpos = state.positions.clone()
        newpos[:, e] = torch.where(m, epos, state.positions[:, e])
        phi = state.phi.clone()
        phi[:, e] = new_e
        return GenericJastrowState(newpos, torch.where(mask, state.u + saved["du"], state.u), phi,
                                   state.ssum + (new_e - phi_e))


def _gamma_replicated_spec(cell, tol=1e-6):
    """The gamma-point supercell AOs of a cell: the replicated-shell basis of
    KPointOrbitals (models/orbitals.replicated_shells over the images of
    select_pbc_images) and the 0/1 matrix P (nao_repl, nao) that sums each
    AO's images."""
    from .orbitals import replicated_shells, select_pbc_images

    lat = np.asarray(cell.lattice, dtype=np.float64)
    images = select_pbc_images(lat, cell.shells, cell.atom_coords, tol)
    spec, ao_idx, _ = replicated_shells(cell, images, tol)
    P = np.zeros((spec.nao, cell.nao))
    P[np.arange(spec.nao), ao_idx] = 1.0
    return spec, P


class GeminalJastrow(GenericJastrow):
    """AO-pair geminal Jastrow; on a cell its features are the gamma-point
    supercell AOs, periodic across the cell boundary."""

    def __init__(self, mol, img_tol=1e-6):
        super().__init__(sum(mol.nelec))
        self.nao = mol.nao
        lattice = getattr(mol, "lattice", None)
        if lattice is None:
            self.spec = GTOSpec.from_molecule(mol)
            self._const = None
        else:
            self.spec, P = _gamma_replicated_spec(mol, img_tol)
            lat = np.asarray(lattice, dtype=np.float64)
            self._const = DeviceConstants(P=P, lat=lat, lat_inv=np.linalg.inv(lat))

    def make_params(self, device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        return {"gcoeff": torch.zeros((self.nao, self.nao), dtype=dtype, device=device)}

    def features(self, params, xyz, derivs=False):
        lead = xyz.shape[:-1]
        X = xyz.reshape(-1, 3)
        if self._const is not None:
            c = self._const.get(X.device, X.dtype)
            # fold into the home cell: the AO sum is periodic, and the fold's
            # floor leaves the derivatives as they are
            frac = X @ c["lat_inv"]
            X = (frac - torch.floor(frac)) @ c["lat"]
        out = eval_gto(self.spec, X, 2 if derivs else 0)
        out = out if derivs else (out,)
        if self._const is not None:
            out = tuple(x @ c["P"] for x in out)
        phi = out[0].reshape(*lead, self.nao)
        if not derivs:
            return phi
        return phi, out[1].reshape(*lead, 3, self.nao), out[2].reshape(*lead, self.nao)

    def bilinear(self, params, u, v):
        g = 0.5 * (params["gcoeff"] + params["gcoeff"].T)
        return torch.sum((u @ g) * v, dim=-1)

    def pgradient(self, params, positions):
        """dU/dgcoeff = 1/2 (S S^T - sum_i phi_i phi_i^T) per walker
        (nconf, nao, nao): symmetric, as the gradient through the
        symmetrization is."""
        phi = self.features(params, positions)
        s = torch.sum(phi, dim=1)
        return {"gcoeff": 0.5 * (s[:, :, None] * s[:, None, :]
                                 - torch.einsum("cim,cin->cmn", phi, phi))}


class GPSJastrow(GenericJastrow):
    """Gaussian-process-state pair Jastrow: n_support pairs of support points
    Xsupport (s, 2, 3) drawn near the atoms from numpy's default_rng(seed),
    as the JAX package draws them."""

    def __init__(self, mol, n_support=4, init_spread=1.0, seed=0):
        super().__init__(sum(mol.nelec))
        rng = np.random.default_rng(seed)
        centers = np.asarray(mol.atom_coords)
        base = centers[rng.integers(0, len(centers), size=(n_support, 2))]
        self._x0 = base + rng.normal(scale=init_spread, size=(n_support, 2, 3))
        self.n_support = n_support

    def make_params(self, device=None, dtype=None):
        """alpha (s,) zeros, the 0-d width f = 1 and Xsupport (s, 2, 3)."""
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        return {"alpha": torch.zeros(self.n_support, dtype=dtype, device=device),
                "f": torch.tensor(1.0, dtype=dtype, device=device),
                "Xsupport": torch.tensor(self._x0, dtype=dtype, device=device)}

    def _kernel(self, params, xyz):
        """(x - X_st (..., s, 2, 3), |x - X_st|^2, phi (..., s, 2))."""
        d = xyz[..., None, None, :] - params["Xsupport"]
        d2 = torch.sum(d * d, dim=-1)
        return d, d2, torch.exp(-params["f"] * d2)

    def features(self, params, xyz, derivs=False):
        lead, F = xyz.shape[:-1], 2 * self.n_support
        d, d2, k = self._kernel(params, xyz)
        if not derivs:
            return k.reshape(*lead, F)
        f = params["f"]
        grad = (-2.0 * f) * d * k[..., None]  # (..., s, 2, 3)
        lap = (4.0 * f * f * d2 - 6.0 * f) * k
        return (k.reshape(*lead, F), torch.movedim(grad, -1, -3).reshape(*lead, 3, F),
                lap.reshape(*lead, F))

    def _pairs(self, x):
        return x.reshape(*x.shape[:-1], self.n_support, 2)

    def bilinear(self, params, u, v):
        u, v = self._pairs(u), self._pairs(v)
        cross = u[..., 0] * v[..., 1] + u[..., 1] * v[..., 0]
        return torch.sum(cross * params["alpha"], dim=-1)

    def pgradient(self, params, positions):
        """d U / d(alpha, f, Xsupport) per walker, through dU/dphi_i =
        A (S - phi_i) and the kernel's own parameter derivatives."""
        d, d2, k = self._kernel(params, positions)  # (c, n, s, 2, ...)
        s = torch.sum(k, dim=1)  # (c, s, 2)
        rest = s[:, None] - k
        a_rest = params["alpha"][:, None] * rest.flip(-1)  # A (S - phi_i)
        w = a_rest * k
        return {"alpha": s[..., 0] * s[..., 1] - torch.sum(k[..., 0] * k[..., 1], dim=1),
                "f": -torch.sum(w * d2, dim=(1, 2, 3)),
                "Xsupport": 2.0 * params["f"] * torch.sum(w[..., None] * d, dim=1)}

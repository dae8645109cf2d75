"""One-body density matrix (counterpart of pyqmc_tpu/observables/obdm.py).

  rho_ij = < sum_e phi_i*(r') phi_j(r_e) Psi(r_e -> r') / Psi / q(r') >

The auxiliary point r' is drawn from an atom-centered Gaussian mixture q
(wrapped into the cell, with its exact 27-image density, for a periodic
system); dividing by q keeps the estimator unbiased for any q > 0. The
points are the accumulator's own random numbers (observables/
accumulators.py): draw() makes every step's at the block's start, and a
test can pass the JAX package's instead.

On the GPU the orbitals at the auxiliary points and at the electrons are
value-only evaluations: float32 ones run on K3 (ops/gto_kernels.py
ValueMO), as do the wavefunction's own (testvalue_many). The JAX package's
real-pair route for twisted k-point orbitals (ratio_is_modulus) has no
counterpart: the port's complex wavefunctions are complex tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.orbitals import _value_kernel, value_mo
from ..ops.gto import GTOSpec, eval_gto
from ..ops.gto_kernels import ValueMO
from ..ops.pbc import enforce_pbc
from ..utils.constants import DeviceConstants


class GaussianMixture:
    """Atom-centered isotropic Gaussian mixture for auxiliary sampling."""

    def __init__(self, atom_coords, sigma=1.5):
        self.centers = np.asarray(atom_coords, dtype=np.float64)
        self.sigma = sigma
        self._const = DeviceConstants(centers=self.centers)

    def sample(self, generator, shape, device, dtype):
        """Points (*shape, 3): an atom picked by a uniform, plus a normal
        offset of width sigma; drawn on the generator's device."""
        gdev = generator.device
        u = torch.rand(shape, generator=generator, device=gdev, dtype=dtype)
        z = torch.randn(tuple(shape) + (3,), generator=generator, device=gdev, dtype=dtype)
        n = len(self.centers)
        idx = torch.clamp((u * n).long(), max=n - 1)
        centers = self._const.get(gdev, dtype)["centers"]
        return (centers[idx] + self.sigma * z).to(device)

    def density(self, X):
        d = X[..., None, :] - self._const.get(X.device, X.dtype)["centers"]
        r2 = torch.sum(d * d, dim=-1)
        norm = (2 * np.pi * self.sigma**2) ** -1.5 / len(self.centers)
        return norm * torch.sum(torch.exp(-r2 / (2 * self.sigma**2)), dim=-1)


class PeriodicGaussianMixture:
    """The mixture wrapped into a periodic cell: sample() returns points in
    the cell, density() the image sum over the 27 nearest lattice
    translations (error ~ exp(-(|L|/sigma)^2/2))."""

    def __init__(self, cell, sigma=1.5):
        self.inner = GaussianMixture(cell.atom_coords, sigma)
        lattice = np.asarray(cell.lattice, dtype=np.float64)
        ii, jj, kk = np.meshgrid(*([np.arange(-1, 2)] * 3), indexing="ij")
        shifts = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3) @ lattice
        self._const = DeviceConstants(lat=lattice, lat_inv=np.linalg.inv(lattice), shifts=shifts)

    def sample(self, generator, shape, device, dtype):
        r = self.inner.sample(generator, shape, device, dtype)
        c = self._const.get(r.device, dtype)
        return enforce_pbc(c["lat"], c["lat_inv"], r)[0]

    def density(self, X):
        c = self._const.get(X.device, X.dtype)
        centers = self.inner._const.get(X.device, X.dtype)["centers"]
        d = X[..., None, None, :] - centers[:, None, :] + c["shifts"]
        r2 = torch.sum(d * d, dim=-1)
        sig = self.inner.sigma
        norm = (2 * np.pi * sig**2) ** -1.5 / len(self.inner.centers)
        return norm * torch.sum(torch.exp(-r2 / (2 * sig**2)), dim=(-2, -1))


class OrbitalSet:
    """Value-only orbitals X (..., 3) -> (..., norb) of one coefficient
    matrix (nao, norb), the JAX package's eval_gto(spec, X, 0) @ C: K3 for
    float32 points outside plain_orbitals (models/orbitals.py), plain
    otherwise."""

    def __init__(self, mol, coeff):
        self.spec = GTOSpec.from_molecule(mol)
        self.norb = np.asarray(coeff).shape[1]
        self._value_mo = ValueMO(self.spec)
        self._const = DeviceConstants(C=np.asarray(coeff))

    def __call__(self, X):
        C = self._const.get(X.device, X.dtype)["C"]
        if _value_kernel(X):
            return value_mo(self._value_mo, X, C)
        ao = eval_gto(self.spec, X, 0)
        return ao @ C if not C.is_complex() else ao.to(C.dtype) @ C


def spin_slice(nup, ndn, spin):
    """Electrons (lo, hi) of spin None (all), 0 (up) or 1 (down)."""
    if spin is None:
        return 0, nup + ndn
    return (0, nup) if spin == 0 else (nup, nup + ndn)


def slater_params(params):
    """The Slater's parameters inside a product's tree (its first factor,
    "wf0", at any depth), or params itself when it holds the orbitals'."""
    while "mo_coeff_alpha" not in params:
        params = params["wf0"]
    return params


def _like(x, ref):
    """x in ref's dtype when ref is complex (a complex wavefunction's
    ratios), else x."""
    return x.to(ref.dtype) if ref.is_complex() and not x.is_complex() else x


class _Aux:
    """Shared pieces of the density-matrix accumulators: their draws and
    the walker mean."""

    naux = 1

    def draw(self, generator, nsteps, nconf, device, dtype):
        """Every step's auxiliary points: {"raux": (nsteps, nconf, 3)}, or
        {"r1", "r2"} for the two-body matrices."""
        keys = ("raux",) if self.naux == 1 else ("r1", "r2")
        return {k: self.mixture.sample(generator, (nsteps, nconf), device, dtype) for k in keys}

    def _draws(self, draws):
        if draws is None:
            raise ValueError(f"{type(self).__name__} needs its auxiliary points (draws=)")
        return draws

    def avg(self, wf, params, state, positions, rot=None, u_sel=None, draws=None):
        return {k: torch.mean(v, dim=0)
                for k, v in self(wf, params, state, positions, rot, u_sel, draws).items()}


class OBDMAccumulator(_Aux):
    """rho_ij in the basis of `orb_coeff` columns, of spin None (the sum),
    0 (up electrons) or 1 (down): {"value": (nconf, n, n), "norm": (nconf,
    n)}, norm the orbitals' |phi_i(r')|^2 / q(r') (normalize_obdm)."""

    def __init__(self, mol, orb_coeff, spin=None, aux_sigma=1.5):
        self.orbitals = OrbitalSet(mol, orb_coeff)
        self.nup, self.ndn = mol.nelec
        self.spin = spin
        self.mixture = GaussianMixture(mol.atom_coords, aux_sigma)

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None, draws=None):
        raux = self._draws(draws)["raux"]
        q = self.mixture.density(raux)
        lo, hi = spin_slice(self.nup, self.ndn, self.spin)
        phi_aux = self.orbitals(raux)  # (nconf, norb)
        phi_e = self.orbitals(positions[:, lo:hi])  # (nconf, ne, norb)
        ratios = wf.testvalue_many(params, state, raux)[:, lo:hi]
        contrib = torch.einsum("ce,ci,cej->cij", ratios, _like(phi_aux, ratios).conj(),
                               _like(phi_e, ratios))
        return {"value": contrib / q[:, None, None],
                "norm": torch.abs(phi_aux) ** 2 / q[:, None]}

    def keys(self):
        return {"value", "norm"}

    def shapes(self):
        n = self.orbitals.norb
        return {"value": (n, n), "norm": (n,)}


class KOBDMAccumulator(_Aux):
    """One-body density matrix of a periodic cell in the k-point orbitals of
    one spin (0 or 1), the complex route of the JAX package's
    KOBDMAccumulator: {"value_re", "value_im": (nconf, n, n), "norm":
    (nconf, n)}. `orbitals` is the wavefunction's KPointOrbitals; its
    parameters are read from the wavefunction's (slater_params)."""

    def __init__(self, cell, orbitals, spin=0, aux_sigma=1.5):
        if spin not in (0, 1):
            raise ValueError("KOBDM measures one spin sector: spin in (0, 1)")
        self.orbitals = orbitals
        self.nup, self.ndn = cell.nelec
        self.spin = spin
        self.mixture = PeriodicGaussianMixture(cell, aux_sigma)
        self.norb = orbitals.norb[spin]

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None, draws=None):
        raux = self._draws(draws)["raux"]
        qinv = 1.0 / self.mixture.density(raux)
        lo, hi = spin_slice(self.nup, self.ndn, self.spin)
        oparams = slater_params(params)
        ratios = wf.testvalue_many(params, state, raux)[:, lo:hi]
        phi_aux = self.orbitals.eval(oparams, raux, 0)[self.spin]
        phi_e = self.orbitals.eval(oparams, positions[:, lo:hi], 0)[self.spin]
        contrib = torch.einsum("ce,ci,cej->cij", ratios, _like(phi_aux, ratios).conj(),
                               _like(phi_e, ratios)) * qinv[:, None, None]
        im = contrib.imag if contrib.is_complex() else torch.zeros_like(contrib)
        return {"value_re": contrib.real, "value_im": im,
                "norm": torch.abs(phi_aux) ** 2 * qinv[:, None]}

    def keys(self):
        return {"value_re", "value_im", "norm"}

    def shapes(self):
        n = self.norb
        return {"value_re": (n, n), "value_im": (n, n), "norm": (n,)}


def normalize_obdm(rho, norm=None):
    """rho_ij / sqrt(<|phi_i|^2> <|phi_j|^2>), numpy (the JAX package's
    normalize_obdm): corrects orbital-normalization conventions. norm: the
    averaged "norm" output; None leaves rho as it is."""
    rho = np.asarray(rho)
    if norm is None:
        return rho
    n = np.sqrt(np.asarray(norm))
    return rho / np.outer(n, n)

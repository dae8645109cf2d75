"""Orbital evaluators (counterpart of pyqmc_tpu/models/orbitals.py):
molecular (mo = ao @ C per spin) and periodic k-point orbitals, real at
time-reversal-invariant (TRIM) k-points and complex at any other twist.
Coefficients may be complex (torch complex64 / complex128); the AOs stay
real and are contracted with [Re C | Im C] in one real product, so a
complex evaluation is one AO pass, as the JAX package's pair path
(models/orbitals.py:563-629) makes it.

Kernels, with the JAX package's gates ("on TPU" read as "on CUDA"):
  K3 (ops/gto_kernels.py:ValueMO) serves every value-only evaluation
     (mode 0 and eval_mo_t) of float32 inputs, for complex coefficients
     over the 2 norb columns [Re C | Im C];
  K6 (ops/gto_kernels.py:EvalGTO2) serves the mode-2 AOs of float32 inputs
     from MIN_NAO_FUSED2 AOs on (the periodic replicated-shell basis).
Their wrappers run the plain PyTorch versions for CPU tensors. Inside
`with plain_orbitals():` every evaluation is plain, as under the JAX
package's fused=False; a block built with fused=False (method/vmc.py,
method/dmc.py) runs in it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..ops.gto import GTOSpec, eval_gto
from ..ops.gto_kernels import MIN_NAO_FUSED2, EvalGTO2, ValueMO
from ..utils.constants import DeviceConstants
from ..utils.dtypes import complex_dtype, real_dtype, resolve_device

_KERNELS = contextvars.ContextVar("orbital_kernels", default=True)


@contextlib.contextmanager
def plain_orbitals():
    """Evaluate every orbital without K3 and K6 inside this block."""
    token = _KERNELS.set(False)
    try:
        yield
    finally:
        _KERNELS.reset(token)


def _value_kernel(X):
    """K3's gate: float32 points, outside plain_orbitals."""
    return X.dtype == torch.float32 and _KERNELS.get()


def _pair(C):
    """[Re C | Im C] (nao, 2 norb) of complex coefficients."""
    return torch.cat([C.real, C.imag], dim=-1)


def _unpair(m, n, axis=-1):
    """The complex values of a product with _pair's columns, split along
    `axis` at n."""
    re, im = torch.split(m, n, dim=axis)
    return torch.complex(re, im)


def contract(ao, C):
    """ao @ C for real AO values and real or complex coefficients C: one
    real product with [Re C | Im C] for complex C."""
    if not C.is_complex():
        return ao @ C
    return _unpair(ao @ _pair(C), C.shape[-1])


def value_mo(vm, X, C, transposed=False):
    """K3 (ValueMO vm) at X with real or complex C: for complex C one launch
    over [Re C | Im C], combined into complex values."""
    if not C.is_complex():
        return vm.transposed(X, C) if transposed else vm(X, C)
    if transposed:
        return _unpair(vm.transposed(X, _pair(C)), C.shape[-1], axis=0)
    return _unpair(vm(X, _pair(C)), C.shape[-1])


def _eval2_kernel(ev2, X):
    """K6's gate: an evaluator built (from MIN_NAO_FUSED2 AOs on), float32
    points, outside plain_orbitals."""
    return ev2 is not None and _value_kernel(X)


class MolecularOrbitals:
    """Open-boundary orbitals; owns the mo_coeff parameter layout
    {"mo_coeff_alpha": (nao, norb_up), "mo_coeff_beta": (nao, norb_dn)},
    complex when either coefficient array is."""

    def __init__(self, mol, mo_coeff: Tuple[np.ndarray, np.ndarray]):
        self.spec = GTOSpec.from_molecule(mol)
        self._ca = np.asarray(mo_coeff[0])
        self._cb = np.asarray(mo_coeff[1])
        self.is_complex = bool(np.iscomplexobj(self._ca) or np.iscomplexobj(self._cb))
        self.norb = (self._ca.shape[1], self._cb.shape[1])
        self._value_mo = ValueMO(self.spec)
        self._eval2 = EvalGTO2(self.spec) if self.spec.nao >= MIN_NAO_FUSED2 else None

    def make_params(self, device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        if self.is_complex:
            dtype = complex_dtype(dtype)
        return {
            "mo_coeff_alpha": torch.as_tensor(self._ca, dtype=dtype, device=device),
            "mo_coeff_beta": torch.as_tensor(self._cb, dtype=dtype, device=device),
        }

    def eval_mo_t(self, params, X):
        """Value-only MOs of both spins, transposed: X (M, 3) ->
        (norb_up + norb_dn, M), points on the minor axis (K3's layout)."""
        C = torch.cat([params["mo_coeff_alpha"], params["mo_coeff_beta"]], dim=1)
        if _value_kernel(X):
            return value_mo(self._value_mo, X, C, transposed=True)
        return contract(eval_gto(self.spec, X, 0), C).T

    def eval(self, params, X, mode: int):
        """X (..., 3) -> per-spin MOs.

        mode 0: (mo_up, mo_dn); mode 1 adds (gmo_up, gmo_dn) with a 3-axis
        before the orbital axis; mode 2 adds the laplacian MOs.
        """
        ca, cb = params["mo_coeff_alpha"], params["mo_coeff_beta"]
        if mode == 0:
            if _value_kernel(X):
                mo = value_mo(self._value_mo, X, torch.cat([ca, cb], dim=1))
                return mo[..., :ca.shape[1]], mo[..., ca.shape[1]:]
            ao = eval_gto(self.spec, X, 0)
            return contract(ao, ca), contract(ao, cb)
        if mode == 1:
            ao, aog = eval_gto(self.spec, X, 1)
            return contract(ao, ca), contract(ao, cb), contract(aog, ca), contract(aog, cb)
        if _eval2_kernel(self._eval2, X):
            ao, aog, aol = self._eval2(X)
        else:
            ao, aog, aol = eval_gto(self.spec, X, 2)
        return (contract(ao, ca), contract(ao, cb), contract(aog, ca), contract(aog, cb),
                contract(aol, ca), contract(aol, cb))


def select_pbc_images(lattice, shells, atom_coords, tol=1e-6, ngrid=6):
    """Lattice images L whose translated atoms have a basis function reaching
    into the home cell (distance from R_a + L to an ngrid^3 sample of the
    cell below rcut plus the sample's margin), rcut from the most diffuse
    exponent (models/orbitals.py:121-151)."""
    amin = min(float(np.min(s.exps)) for s in shells)
    rcut = np.sqrt(-np.log(tol) / amin)
    fr = (np.arange(ngrid) + 0.5) / ngrid
    grid = np.array(np.meshgrid(fr, fr, fr, indexing="ij")).reshape(3, -1).T @ lattice
    margin = 0.5 * np.linalg.norm(lattice.sum(axis=0)) / ngrid
    heights = 1.0 / np.linalg.norm(np.linalg.inv(lattice), axis=0)
    diam = np.linalg.norm(lattice.sum(axis=0))
    nimg = np.maximum(1, np.ceil((rcut + diam) / heights).astype(int))
    pts = np.array(np.meshgrid(*[np.arange(-n, n + 1) for n in nimg], indexing="ij")).reshape(3, -1).T
    imgs = pts @ lattice
    d = np.linalg.norm(imgs[:, None, None, :] + np.asarray(atom_coords)[None, :, None, :]
                       - grid[None, None, :, :], axis=-1)
    return imgs[d.min(axis=(1, 2)) <= rcut + margin]


def replicated_shells(cell, images, tol, ngrid=6):
    """A basis of one shell per (lattice image, shell) pair that reaches the
    home cell (distance from the shifted center to an ngrid^3 sample of the
    cell below the shell's rcut plus the sample's margin): (GTOSpec, the
    primitive cell's AO of each row (nao_repl,), the image of each row
    (nao_repl,))."""
    lat = np.asarray(cell.lattice, dtype=np.float64)
    fr = (np.arange(ngrid) + 0.5) / ngrid
    grid = np.array(np.meshgrid(fr, fr, fr, indexing="ij")).reshape(3, -1).T @ lat
    margin = 0.5 * np.linalg.norm(lat.sum(axis=0)) / ngrid
    centers, repl, ao_idx, img = [], [], [], []
    off = 0
    for i, L in enumerate(images):
        for sh in cell.shells:
            c = np.asarray(cell.atom_coords)[sh.atom] + L
            rcut = np.sqrt(-np.log(tol) / float(np.min(sh.exps)))
            if np.min(np.linalg.norm(grid - c[None], axis=1)) > rcut + margin:
                continue
            repl.append(dataclasses.replace(sh, atom=len(centers), ao_offset=off))
            centers.append(c)
            nsph = 2 * sh.l + 1
            ao_idx.extend(range(sh.ao_offset, sh.ao_offset + nsph))
            img.extend([i] * nsph)
            off += nsph
    return (GTOSpec.from_shells(repl, np.asarray(centers), off),
            np.asarray(ao_idx, dtype=np.int64), np.asarray(img, dtype=np.int64))


class KPointOrbitals:
    """Periodic k-point orbitals.

    mo_coeff: per spin a list over k-points of (nao, nocc_k) arrays; the
    orbital order is k-major. The AOs of a replicated-shell basis (every
    kept (shell, image) pair its own shell) contract with one folded
    coefficient matrix R (nao_repl, norb_up + norb_dn), R[r, (s, k, j)] =
    e^{i k.L_r} C^s_k[ao(r), j], and each orbital column takes the phase
    e^{i k.(wA)} of the lattice translation wA that folds the point into the
    primitive cell (models/orbitals.py:346-360, :563-629).

    realify: at time-reversal-invariant k every Bloch phase is +-1 and each
    orbital can be rotated to a real vector (`_try_realify`); the evaluation
    is then real (real_mode), R real and the wrap phases exactly +-1.
    "auto" realifies when every k is TRIM and the rotation leaves no
    imaginary rest; True requires it; False keeps the complex mode, whose
    parameters and values are complex tensors.
    """

    def __init__(self, cell, kpts, mo_coeff, images=None, img_tol=1e-6, realify="auto"):
        self.spec = GTOSpec.from_molecule(cell)
        self.lattice = np.asarray(cell.lattice, dtype=np.float64)
        self.lattice_inv = np.linalg.inv(self.lattice)
        self.kpts = np.asarray(kpts, dtype=np.float64).reshape(-1, 3)
        self.images = (np.asarray(images) if images is not None
                       else select_pbc_images(self.lattice, cell.shells, cell.atom_coords, img_tol))
        self._mo = [[np.asarray(c) for c in mo_coeff[s]] for s in range(2)]
        frac2 = self.kpts @ self.lattice.T / np.pi
        is_trim = bool(np.all(np.abs(frac2 - np.round(frac2)) < 1e-8))
        self.real_mode = False
        if realify in (True, "auto") and is_trim:
            rotated, ok = self._try_realify()
            if ok:
                self._mo = rotated
                self.real_mode = True
            elif realify is True:
                raise ValueError("realify requested but orbitals are not phase-rotatable to "
                                 "real vectors")
        if not self.real_mode:
            self._mo = [[b.astype(np.complex128) for b in blocks] for blocks in self._mo]
        ph = np.exp(1j * self.images @ self.kpts.T)  # (nimg, nk)
        self.img_phases = np.real(ph) if self.real_mode else ph
        self.norb = tuple(sum(b.shape[1] for b in self._mo[s]) for s in range(2))
        self.nk = len(self.kpts)
        self._build_replicated(cell, img_tol)
        # kphase (nao_repl, nk * nao): row r holds its image's phases at the
        # columns (k, its primitive AO), so AO_repl @ kphase are the k-AOs
        nao = self.spec.nao
        kphase = np.zeros((len(self._repl_ao_idx), self.nk * nao), dtype=self._repl_phase.dtype)
        for k in range(self.nk):
            kphase[np.arange(len(self._repl_ao_idx)), k * nao + self._repl_ao_idx] = \
                self._repl_phase[:, k]
        self._const = DeviceConstants(lat=self.lattice, lat_inv=self.lattice_inv,
                                      kpts_t=self.kpts.T, phase=self._repl_phase,
                                      ao_idx=self._repl_ao_idx, korb=self._korb, kphase=kphase)
        self._value_mo = ValueMO(self._repl_spec)
        self._eval2 = EvalGTO2(self._repl_spec) if self._repl_spec.nao >= MIN_NAO_FUSED2 else None

    @property
    def is_complex(self):
        return not self.real_mode

    def _build_replicated(self, cell, tol):
        """The culled replicated-shell spec (models/orbitals.py:220-318):
        row r of the new basis is AO _repl_ao_idx[r] of the primitive cell
        on an image with phases _repl_phase[r] (nk,), +-1 in real mode."""
        self._repl_spec, self._repl_ao_idx, img = replicated_shells(cell, self.images, tol)
        self._repl_phase = self.img_phases[img]  # (nao_repl, nk)
        # orbital column -> k index, both spins concatenated
        self._korb = np.concatenate([
            np.concatenate([np.full(b.shape[1], k, dtype=np.int64) for k, b in enumerate(self._mo[s])])
            for s in range(2)])

    def _try_realify(self, tol=1e-6):
        """Rotate every orbital column v by exp(-i theta), theta = arg(v.v)/2;
        real when the imaginary rest is below tol."""
        out = []
        for spin in range(2):
            blocks = []
            for c in self._mo[spin]:
                c = np.asarray(c, dtype=np.complex128)
                cols = []
                for j in range(c.shape[1]):
                    v = c[:, j]
                    r = v * np.exp(-1j * 0.5 * np.angle(np.sum(v * v)))
                    if np.max(np.abs(r.imag)) > tol * max(1.0, np.max(np.abs(r.real))):
                        return None, False
                    cols.append(r.real)
                blocks.append(np.stack(cols, axis=1))
            out.append(blocks)
        return out, True

    def make_params(self, device=None, dtype=None):
        """{"mo_coeff_alpha": [per k (nao, nocc_k)], "mo_coeff_beta": [...]},
        complex in the complex mode."""
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        if self.is_complex:
            dtype = complex_dtype(dtype)
        return {f"mo_coeff_{tag}": [torch.as_tensor(b, dtype=dtype, device=device) for b in self._mo[s]]
                for s, tag in enumerate(("alpha", "beta"))}

    def _fold(self, X):
        """(X folded into the primitive cell, wrap phases (..., nk)):
        e^{i k.(wA)}, exactly +-1 in real mode."""
        c = self._const.get(X.device, X.dtype)
        frac = X @ c["lat_inv"]
        wrap = torch.floor(frac)
        Xf = (frac - wrap) @ c["lat"]
        karg = (wrap @ c["lat"]) @ c["kpts_t"]
        if not self.real_mode:
            return Xf, torch.polar(torch.ones_like(karg), karg)
        one = torch.ones((), dtype=X.dtype, device=X.device)
        return Xf, torch.where(torch.cos(karg) > 0, one, -one)

    def _folded_coeff(self, params, dtype):
        """R (nao_repl, norb_up + norb_dn): R[r, (s, k, j)] = phase_k(r)
        C^s_k[ao(r), j], complex in the complex mode; rebuilt per call so
        new mo_coeff flow through."""
        c = self._const.get(params["mo_coeff_alpha"][0].device, dtype)
        idx, ph = c["ao_idx"], c["phase"]
        cdtype = ph.dtype
        cols = [b.to(cdtype)[idx] * ph[:, k][:, None]
                for tag in ("alpha", "beta") for k, b in enumerate(params[f"mo_coeff_{tag}"])]
        return torch.cat(cols, dim=1)

    def _wcol(self, wphase):
        return wphase[..., self._const.get(wphase.device, wphase.real.dtype)["korb"]]

    def eval(self, params, X, mode: int):
        """Per-spin MOs at X (..., 3), as MolecularOrbitals.eval."""
        Xf, wphase = self._fold(X)
        R = self._folded_coeff(params, X.dtype)
        wcol = self._wcol(wphase)  # (..., norb_tot)
        nu = self.norb[0]

        def split(m):
            return m[..., :nu], m[..., nu:]

        if mode == 0:
            if _value_kernel(X):
                mo = value_mo(self._value_mo, Xf, R)
            else:
                mo = contract(eval_gto(self._repl_spec, Xf, 0), R)
            return split(mo * wcol)
        if mode == 1:
            ao, aog = eval_gto(self._repl_spec, Xf, 1)
            return (split(contract(ao, R) * wcol)
                    + split(contract(aog, R) * wcol[..., None, :]))
        if _eval2_kernel(self._eval2, X):
            ao, aog, aol = self._eval2(Xf)
        else:
            ao, aog, aol = eval_gto(self._repl_spec, Xf, 2)
        return (split(contract(ao, R) * wcol) + split(contract(aog, R) * wcol[..., None, :])
                + split(contract(aol, R) * wcol))

    def kaos(self, X):
        """Bloch sums of the primitive cell's AOs at X (..., 3), with the
        fold's wrap phases: (..., nk, nao); the MOs of k-point k are
        kaos[..., k, :] @ C_k. Plain PyTorch (K3 contracts with the
        coefficients, and these feed the coefficients' gradients)."""
        Xf, wphase = self._fold(X)
        ao = contract(eval_gto(self._repl_spec, Xf, 0),
                      self._const.get(X.device, X.dtype)["kphase"])
        return ao.reshape(X.shape[:-1] + (self.nk, -1)) * wphase[..., :, None]

    def eval_mo_t(self, params, X):
        """Value-only MOs (norb_up + norb_dn, M) at X (M, 3), points minor."""
        Xf, wphase = self._fold(X)
        R = self._folded_coeff(params, X.dtype)
        wcol_t = self._wcol(wphase).T
        if _value_kernel(X):
            return value_mo(self._value_mo, Xf, R, transposed=True) * wcol_t
        return contract(eval_gto(self._repl_spec, Xf, 0), R).T * wcol_t

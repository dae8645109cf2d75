"""Orbital evaluators (counterpart of pyqmc_tpu/models/orbitals.py):
molecular (mo = ao @ C per spin) and periodic k-point orbitals in their
real, time-reversal-invariant (TRIM) mode.

Kernels, with the JAX package's gates ("on TPU" read as "on CUDA"):
  K3 (ops/gto_kernels.py:ValueMO) serves every value-only evaluation
     (mode 0 and eval_mo_t) of float32 inputs;
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
from ..utils.dtypes import real_dtype, resolve_device

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


def _eval2_kernel(ev2, X):
    """K6's gate: an evaluator built (from MIN_NAO_FUSED2 AOs on), float32
    points, outside plain_orbitals."""
    return ev2 is not None and _value_kernel(X)


class MolecularOrbitals:
    """Open-boundary orbitals; owns the mo_coeff parameter layout
    {"mo_coeff_alpha": (nao, norb_up), "mo_coeff_beta": (nao, norb_dn)}."""

    def __init__(self, mol, mo_coeff: Tuple[np.ndarray, np.ndarray]):
        self.spec = GTOSpec.from_molecule(mol)
        self._ca = np.asarray(mo_coeff[0])
        self._cb = np.asarray(mo_coeff[1])
        self.norb = (self._ca.shape[1], self._cb.shape[1])
        self._value_mo = ValueMO(self.spec)
        self._eval2 = EvalGTO2(self.spec) if self.spec.nao >= MIN_NAO_FUSED2 else None

    def make_params(self, device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        return {
            "mo_coeff_alpha": torch.as_tensor(self._ca, dtype=dtype, device=device),
            "mo_coeff_beta": torch.as_tensor(self._cb, dtype=dtype, device=device),
        }

    def eval_mo_t(self, params, X):
        """Value-only MOs of both spins, transposed: X (M, 3) ->
        (norb_up + norb_dn, M), points on the minor axis (K3's layout)."""
        C = torch.cat([params["mo_coeff_alpha"], params["mo_coeff_beta"]], dim=1)
        if _value_kernel(X):
            return self._value_mo.transposed(X, C)
        return (eval_gto(self.spec, X, 0) @ C).T

    def eval(self, params, X, mode: int):
        """X (..., 3) -> per-spin MOs.

        mode 0: (mo_up, mo_dn); mode 1 adds (gmo_up, gmo_dn) with a 3-axis
        before the orbital axis; mode 2 adds the laplacian MOs.
        """
        ca, cb = params["mo_coeff_alpha"], params["mo_coeff_beta"]
        if mode == 0:
            if _value_kernel(X):
                mo = self._value_mo(X, torch.cat([ca, cb], dim=1))
                return mo[..., :ca.shape[1]], mo[..., ca.shape[1]:]
            ao = eval_gto(self.spec, X, 0)
            return ao @ ca, ao @ cb
        if mode == 1:
            ao, aog = eval_gto(self.spec, X, 1)
            return ao @ ca, ao @ cb, aog @ ca, aog @ cb
        if _eval2_kernel(self._eval2, X):
            ao, aog, aol = self._eval2(X)
        else:
            ao, aog, aol = eval_gto(self.spec, X, 2)
        return ao @ ca, ao @ cb, aog @ ca, aog @ cb, aol @ ca, aol @ cb


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


class KPointOrbitals:
    """Periodic k-point orbitals in the real (TRIM) mode.

    mo_coeff: per spin a list over k-points of (nao, nocc_k) arrays; the
    orbital order is k-major. At time-reversal-invariant k every Bloch phase
    is +-1 and each orbital is rotated to a real vector (`_try_realify`), so
    the evaluation is real: the AOs of a replicated-shell basis (every kept
    (shell, image) pair its own shell) contract with one folded coefficient
    matrix R (nao_repl, norb_up + norb_dn), and each orbital column takes
    the sign cos(k . wA) = +-1 of the lattice translation wA that folds the
    point into the primitive cell. Other twists (the complex mode) are not
    ported.
    """

    def __init__(self, cell, kpts, mo_coeff, images=None, img_tol=1e-6):
        self.spec = GTOSpec.from_molecule(cell)
        self.lattice = np.asarray(cell.lattice, dtype=np.float64)
        self.lattice_inv = np.linalg.inv(self.lattice)
        self.kpts = np.asarray(kpts, dtype=np.float64).reshape(-1, 3)
        self.images = (np.asarray(images) if images is not None
                       else select_pbc_images(self.lattice, cell.shells, cell.atom_coords, img_tol))
        self._mo = [[np.asarray(c) for c in mo_coeff[s]] for s in range(2)]
        frac2 = self.kpts @ self.lattice.T / np.pi
        if not np.all(np.abs(frac2 - np.round(frac2)) < 1e-8):
            raise NotImplementedError("only time-reversal-invariant k-points (real mode) are ported")
        rotated, ok = self._try_realify()
        if not ok:
            raise NotImplementedError("orbitals are not phase-rotatable to real vectors; the "
                                      "complex mode is not ported")
        self._mo = rotated
        self.real_mode = True
        self.img_phases = np.real(np.exp(1j * self.images @ self.kpts.T))  # (nimg, nk), +-1
        self.norb = tuple(sum(b.shape[1] for b in self._mo[s]) for s in range(2))
        self.nk = len(self.kpts)
        self._build_replicated(cell, img_tol)
        self._const = DeviceConstants(lat=self.lattice, lat_inv=self.lattice_inv,
                                      kpts_t=self.kpts.T, phase=self._repl_phase,
                                      ao_idx=self._repl_ao_idx, korb=self._korb)
        self._value_mo = ValueMO(self._repl_spec)
        self._eval2 = EvalGTO2(self._repl_spec) if self._repl_spec.nao >= MIN_NAO_FUSED2 else None

    def _build_replicated(self, cell, tol):
        """The culled replicated-shell spec (models/orbitals.py:220-318):
        shell sh on image L is kept when it reaches the home cell; row r of
        the new basis is AO _repl_ao_idx[r] of the primitive cell on an
        image with phases _repl_phase[r] (nk,)."""
        lat = self.lattice
        ngrid = 6
        fr = (np.arange(ngrid) + 0.5) / ngrid
        grid = np.array(np.meshgrid(fr, fr, fr, indexing="ij")).reshape(3, -1).T @ lat
        margin = 0.5 * np.linalg.norm(lat.sum(axis=0)) / ngrid
        centers, repl, ao_idx, phase = [], [], [], []
        off = 0
        for L, ph in zip(self.images, self.img_phases):
            for sh in cell.shells:
                c = cell.atom_coords[sh.atom] + L
                rcut = np.sqrt(-np.log(tol) / float(np.min(sh.exps)))
                if np.min(np.linalg.norm(grid - c[None], axis=1)) > rcut + margin:
                    continue
                repl.append(dataclasses.replace(sh, atom=len(centers), ao_offset=off))
                centers.append(c)
                nsph = 2 * sh.l + 1
                ao_idx.extend(range(sh.ao_offset, sh.ao_offset + nsph))
                phase.extend([ph] * nsph)
                off += nsph
        self._repl_spec = GTOSpec.from_shells(repl, np.asarray(centers), off)
        self._repl_ao_idx = np.asarray(ao_idx, dtype=np.int64)
        self._repl_phase = np.asarray(phase)  # (nao_repl, nk), +-1
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
        """{"mo_coeff_alpha": [per k (nao, nocc_k)], "mo_coeff_beta": [...]}."""
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        return {f"mo_coeff_{tag}": [torch.as_tensor(b, dtype=dtype, device=device) for b in self._mo[s]]
                for s, tag in enumerate(("alpha", "beta"))}

    def _fold(self, X):
        """(X folded into the primitive cell, wrap signs (..., nk) = +-1)."""
        c = self._const.get(X.device, X.dtype)
        frac = X @ c["lat_inv"]
        wrap = torch.floor(frac)
        Xf = (frac - wrap) @ c["lat"]
        karg = (wrap @ c["lat"]) @ c["kpts_t"]
        one = torch.ones((), dtype=X.dtype, device=X.device)
        return Xf, torch.where(torch.cos(karg) > 0, one, -one)

    def _folded_coeff(self, params, dtype):
        """R (nao_repl, norb_up + norb_dn): R[r, (s, k, j)] = phase_k(r)
        C^s_k[ao(r), j]; rebuilt per call so new mo_coeff flow through."""
        c = self._const.get(params["mo_coeff_alpha"][0].device, dtype)
        idx, ph = c["ao_idx"], c["phase"]
        cols = [b.to(dtype)[idx] * ph[:, k][:, None]
                for tag in ("alpha", "beta") for k, b in enumerate(params[f"mo_coeff_{tag}"])]
        return torch.cat(cols, dim=1)

    def _wcol(self, wphase):
        return wphase[..., self._const.get(wphase.device, wphase.dtype)["korb"]]

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
                mo = self._value_mo(Xf, R)
            else:
                mo = eval_gto(self._repl_spec, Xf, 0) @ R
            return split(mo * wcol)
        if mode == 1:
            ao, aog = eval_gto(self._repl_spec, Xf, 1)
            return split((ao @ R) * wcol) + split((aog @ R) * wcol[..., None, :])
        if _eval2_kernel(self._eval2, X):
            ao, aog, aol = self._eval2(Xf)
        else:
            ao, aog, aol = eval_gto(self._repl_spec, Xf, 2)
        return (split((ao @ R) * wcol) + split((aog @ R) * wcol[..., None, :])
                + split((aol @ R) * wcol))

    def eval_mo_t(self, params, X):
        """Value-only MOs (norb_up + norb_dn, M) at X (M, 3), points minor."""
        Xf, wphase = self._fold(X)
        R = self._folded_coeff(params, X.dtype)
        wcol_t = self._wcol(wphase).T
        if _value_kernel(X):
            return self._value_mo.transposed(Xf, R) * wcol_t
        return (eval_gto(self._repl_spec, Xf, 0) @ R).T * wcol_t

"""Batched GTO (atomic orbital) evaluation (counterpart of pyqmc_tpu/ops/gto.py).

Spherical AOs through exact cart->solid-harmonic tables (ops/harmonics.py):
shells are grouped by angular momentum and padded to a common primitive
count, so each l-group is a few batched tensor ops.

Derivative algebra: for f = P(x,y,z) * g(r^2), P a degree-l monomial,
g = sum_p c_p exp(-a_p r^2):
    grad f = (grad P) g0 - 2 P g1 r
    lap  f = (lap P) g0 - (4 l + 6) P g1 + 4 P g2 r^2
with g_k = sum_p c_p a_p^k exp(-a_p r^2).

Within a group the AOs come out "concat" ordered (shell-major, m-minor);
`GTOSpec.perm` gathers the concatenated groups into the molecule's AO order.
The CUDA kernels work in concat order and permute `mo_coeff` rows instead
(`concat_rows = argsort(perm)`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .harmonics import cart2sph_matrix, cart_components


@dataclasses.dataclass(frozen=True)
class LGroup:
    l: int
    shell_atoms: np.ndarray  # (S,) atom index per shell in this group
    alpha: np.ndarray  # (S, P) padded exponents
    coef: np.ndarray  # (S, P) padded coefficients (0 padding)
    ao_pos: np.ndarray  # (S * (2l+1),) target AO indices


class GTOSpec:
    """Static AO-evaluation tables built on the host from a Molecule."""

    def __init__(self, groups, perm, nao, atom_coords):
        self.groups: Tuple[LGroup, ...] = tuple(groups)
        self.perm = np.asarray(perm)  # concat order -> AO order gather indices
        self.nao = int(nao)
        self.atom_coords = np.asarray(atom_coords)
        self._tensors: Dict[tuple, list] = {}

    @staticmethod
    def from_molecule(mol) -> "GTOSpec":
        return GTOSpec.from_shells(mol.shells, mol.atom_coords, mol.nao)

    @staticmethod
    def from_shells(shell_list, atom_coords, nao) -> "GTOSpec":
        groups = []
        concat_ao = []
        for l in sorted({s.l for s in shell_list}):
            shells = [s for s in shell_list if s.l == l]
            pmax = max(len(s.exps) for s in shells)
            alpha = np.ones((len(shells), pmax))  # pad alpha 1, coef 0
            coef = np.zeros((len(shells), pmax))
            atoms = np.zeros(len(shells), dtype=np.int64)
            ao_pos = []
            for i, s in enumerate(shells):
                n = len(s.exps)
                alpha[i, :n] = s.exps
                coef[i, :n] = s.coeffs
                atoms[i] = s.atom
                ao_pos.extend(range(s.ao_offset, s.ao_offset + 2 * l + 1))
            groups.append(LGroup(l=l, shell_atoms=atoms, alpha=alpha, coef=coef,
                                 ao_pos=np.array(ao_pos, dtype=np.int64)))
            concat_ao.extend(ao_pos)
        return GTOSpec(groups, np.argsort(np.array(concat_ao)), nao, atom_coords)

    def tensors(self, device, dtype):
        """Per-group (centers, alpha, coef, C) tensors plus the perm, cached
        per (device, dtype) so repeated evaluations copy nothing."""
        key = (torch.device(device), dtype)
        if key not in self._tensors:
            groups = []
            for g in self.groups:
                groups.append(tuple(
                    torch.as_tensor(a, dtype=dtype, device=device)
                    for a in (self.atom_coords[g.shell_atoms], g.alpha, g.coef,
                              cart2sph_matrix(g.l))
                ))
            perm = torch.as_tensor(self.perm, device=device)
            self._tensors[key] = (groups, perm)
        return self._tensors[key]


def _powers(xs, l):
    """[[1, a, a^2, ..., a^l] for a in xs = (x, y, z)], each power the
    previous times a."""
    pows = []
    for a in xs:
        p = [torch.ones_like(a), a]
        for _ in range(2, l + 1):
            p.append(p[-1] * a)
        pows.append(p)
    return pows


def _monomial(pows, comp):
    i, j, k = comp
    return pows[0][i] * pows[1][j] * pows[2][k]


def _monomials(xs, comps):
    """Monomial products for components [(lx, ly, lz)]; xs = (x, y, z) each
    (M, S). Returns (M, S, ncart)."""
    pows = _powers(xs, sum(comps[0]))
    return torch.stack([_monomial(pows, c) for c in comps], dim=-1)


def _times(n, t):
    """n * t, with no launch where n is 1 (the same bits)."""
    return t if n == 1 else n * t


def eval_gto(spec: GTOSpec, X: torch.Tensor, mode: int = 0):
    """All AOs at points X (..., 3).

    mode 0 -> ao (..., nao); 1 -> (ao, grad (..., 3, nao));
    2 -> (ao, grad, lap (..., nao)).
    """
    batch_shape = X.shape[:-1]
    Xf = X.reshape(-1, 3)
    M = Xf.shape[0]
    groups, perm = spec.tensors(X.device, X.dtype)
    vals, grads, laps = [], [], []
    for g, (centers, alpha, coef, C) in zip(spec.groups, groups):
        r = Xf[:, None, :] - centers[None, :, :]  # (M, S, 3)
        r2 = torch.sum(r * r, dim=-1)  # (M, S)
        e = torch.exp(-r2[:, :, None] * alpha[None])  # (M, S, P)
        g0 = torch.einsum("msp,sp->ms", e, coef)
        if mode >= 1:
            g1 = torch.einsum("msp,sp->ms", e, coef * alpha)
        if mode >= 2:
            g2 = torch.einsum("msp,sp->ms", e, coef * alpha * alpha)
        comps = cart_components(g.l)
        x, y, z = r[..., 0], r[..., 1], r[..., 2]
        # the powers of x, y and z once per group: each monomial below is the
        # product that a table of its own degree would give
        pows = _powers((x, y, z), g.l)
        P = torch.stack([_monomial(pows, c) for c in comps], dim=-1)  # (M, S, C)
        vals.append(torch.einsum("msc,cq->msq", P * g0[..., None], C).reshape(M, -1))
        zero = torch.zeros_like(x) if mode >= 1 else None
        if mode >= 1:
            dP = []
            for ax in range(3):
                cols = []
                for comp in comps:
                    n = comp[ax]
                    if n == 0:
                        cols.append(zero)
                    else:
                        e2 = list(comp)
                        e2[ax] = n - 1
                        cols.append(_times(n, _monomial(pows, e2)))
                dP.append(torch.stack(cols, dim=-1))
            dP = torch.stack(dP, dim=1)  # (M, 3, S, C)
            grad_cart = dP * g0[:, None, :, None] - 2.0 * (
                r.permute(0, 2, 1)[..., None] * (P * g1[..., None])[:, None]
            )
            grads.append(torch.einsum("mxsc,cq->mxsq", grad_cart, C).reshape(M, 3, -1))
        if mode >= 2:
            cols = []
            for (i, j, k) in comps:
                acc = zero
                for ax, n in enumerate((i, j, k)):
                    if n >= 2:
                        e2 = [i, j, k]
                        e2[ax] = n - 2
                        acc = acc + n * (n - 1) * _monomial(pows, e2)
                cols.append(acc)
            lapP = torch.stack(cols, dim=-1)
            lap_cart = (lapP * g0[..., None] - (4.0 * g.l + 6.0) * P * g1[..., None]
                        + 4.0 * P * (g2 * r2)[..., None])
            laps.append(torch.einsum("msc,cq->msq", lap_cart, C).reshape(M, -1))
    ao = torch.cat(vals, dim=-1)[:, perm].reshape(*batch_shape, spec.nao)
    if mode == 0:
        return ao
    grad = torch.cat(grads, dim=-1)[:, :, perm].reshape(*batch_shape, 3, spec.nao)
    if mode == 1:
        return ao, grad
    lap = torch.cat(laps, dim=-1)[:, perm].reshape(*batch_shape, spec.nao)
    return ao, grad, lap

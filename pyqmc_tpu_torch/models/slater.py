"""Single-determinant Slater wavefunction (counterpart of
pyqmc_tpu/models/slater.py).

Only the single determinant is ported; `SlaterState` keeps the JAX
package's shapes, with a determinant axis of length 1, so states convert
leaf for leaf. Methods are pure and batched over walkers; the electron
index `e` is a Python int, so the spin branch is chosen on the host. The
orbitals are molecular (MolecularOrbitals, built from mo_coeff) or any
evaluator with the same protocol, such as KPointOrbitals.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.linalg import sherman_morrison_row, slogdet_inv
from ..utils.constants import index_tensor
from ..utils.dtypes import real_dtype, resolve_device
from .orbitals import MolecularOrbitals


class SlaterState(NamedTuple):
    inv_up: torch.Tensor  # (nconf, 1, nup, nup)
    inv_dn: torch.Tensor  # (nconf, 1, ndn, ndn)
    phase_up: torch.Tensor  # (nconf, 1)
    logdet_up: torch.Tensor
    phase_dn: torch.Tensor
    logdet_dn: torch.Tensor
    # orbital values (slot 0) and gradients (slots 1:4) of each electron at
    # its CURRENT position, so the drift at the old position is a small
    # contraction instead of an AO evaluation
    mog_up: torch.Tensor  # (nconf, nup, 4, norb_up)
    mog_dn: torch.Tensor  # (nconf, ndn, 4, norb_dn)


@dataclasses.dataclass(frozen=True)
class DeterminantExpansion:
    """Determinant bookkeeping (single determinant only in the port)."""

    occ_up: np.ndarray  # (1, nup) orbital indices
    occ_dn: np.ndarray  # (1, ndn)
    map_up: np.ndarray  # (1,)
    map_dn: np.ndarray  # (1,)

    @staticmethod
    def single(nup, ndn):
        return DeterminantExpansion(
            occ_up=np.arange(nup)[None, :], occ_dn=np.arange(ndn)[None, :],
            map_up=np.zeros(1, dtype=np.int64), map_dn=np.zeros(1, dtype=np.int64),
        )


class Slater:
    """params: {"det_coeff": (1,)} plus the orbitals' parameters
    ({"mo_coeff_alpha": (nao, norb_up), "mo_coeff_beta": (nao, norb_dn)}
    for molecular orbitals); electron e occupies orbitals 0..n-1 of its
    spin.

    The arguments come in the JAX package's order,
    Slater(mol, orbitals, expansion, mo_coeff=None, det_coeff=None):
    Slater(mol, None, DeterminantExpansion.single(nup, ndn), (ca, cb))
    builds MolecularOrbitals from mo_coeff; Slater(mol, evaluator,
    expansion) takes a ready evaluator. An expansion of None is the single
    determinant."""

    def __init__(self, mol, orbitals=None, expansion=None, mo_coeff=None, det_coeff=None):
        self.nup, self.ndn = mol.nelec
        self.nelec = self.nup + self.ndn
        if expansion is not None and (expansion.occ_up.shape[1] != self.nup
                                      or expansion.occ_dn.shape[1] != self.ndn):
            raise ValueError(f"DeterminantExpansion electron counts ({expansion.occ_up.shape[1]} "
                             f"up, {expansion.occ_dn.shape[1]} dn) do not match mol.nelec "
                             f"{mol.nelec}")
        if orbitals is None and mo_coeff is None:
            raise ValueError("Slater needs orbitals or mo_coeff")
        self.orbitals = orbitals if orbitals is not None else MolecularOrbitals(mol, mo_coeff)
        if self.orbitals.norb[0] < self.nup or self.orbitals.norb[1] < self.ndn:
            raise ValueError(f"the orbitals have {self.orbitals.norb} columns for "
                             f"{mol.nelec} electrons")
        single = DeterminantExpansion.single(self.nup, self.ndn)
        if expansion is not None and not (
                np.array_equal(expansion.occ_up, single.occ_up)
                and np.array_equal(expansion.occ_dn, single.occ_dn)
                and len(expansion.map_up) == 1):
            raise NotImplementedError("only the single determinant of the first n orbitals "
                                      "is ported")
        self.expansion = single
        self._det_coeff0 = np.ones(1) if det_coeff is None else np.asarray(det_coeff)

    @staticmethod
    def from_mean_field(mf):
        """Single determinant of the lowest nup / ndn orbitals of an SCF."""
        nup, ndn = mf.mol.nelec
        return Slater(mf.mol, None, DeterminantExpansion.single(nup, ndn),
                      (mf.mo_coeff[0][:, :nup], mf.mo_coeff[1][:, :ndn]))

    def make_params(self, device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        p = {"det_coeff": torch.as_tensor(self._det_coeff0, dtype=dtype, device=device)}
        p.update(self.orbitals.make_params(device, dtype))
        return p

    # --- helpers ---------------------------------------------------------
    def _spin_row(self, e: int):
        return (0, e) if e < self.nup else (1, e - self.nup)

    def _ratio(self, state, e, mo_up, mo_dn):
        """r = sum_j mo[..., j] inv[j, row] for electron e; mo (nconf, [k,] norb)."""
        s, row = self._spin_row(e)
        n = self.nup if s == 0 else self.ndn
        mo = (mo_up if s == 0 else mo_dn)[..., :n]
        icol = (state.inv_up if s == 0 else state.inv_dn)[:, 0, :, row]  # (nconf, n)
        if mo.ndim == 3:
            return torch.einsum("ckj,cj->ck", mo, icol)
        return torch.sum(mo * icol, dim=-1)

    # --- protocol ---------------------------------------------------------
    def recompute(self, params, positions):
        mo_up_all, mo_dn_all, gmo_up_all, gmo_dn_all = self.orbitals.eval(params, positions, 1)
        nup, ndn = self.nup, self.ndn
        mo_up = mo_up_all[:, :nup]
        mo_dn = mo_dn_all[:, nup:]
        pu, lu, iu = slogdet_inv(mo_up[:, None, :, :nup])
        pd, ld, idn = slogdet_inv(mo_dn[:, None, :, :ndn])
        return SlaterState(
            inv_up=iu, inv_dn=idn, phase_up=pu, logdet_up=lu, phase_dn=pd, logdet_dn=ld,
            mog_up=torch.cat([mo_up[:, :, None, :], gmo_up_all[:, :nup]], dim=2),
            mog_dn=torch.cat([mo_dn[:, :, None, :], gmo_dn_all[:, nup:]], dim=2),
        )

    def value(self, params, state):
        """(phase, logabs) of the determinant product times det_coeff."""
        c = params["det_coeff"][0]
        phase = torch.sign(c) * state.phase_up[:, 0] * state.phase_dn[:, 0]
        return phase, torch.log(torch.abs(c)) + state.logdet_up[:, 0] + state.logdet_dn[:, 0]

    def testvalue(self, params, state, e, epos):
        """Psi(r_e = epos) / Psi; epos (nconf, 3) or (nconf, naux, 3)."""
        mo_up, mo_dn = self.orbitals.eval(params, epos, 0)
        return self._ratio(state, e, mo_up, mo_dn), {"mo_up": mo_up, "mo_dn": mo_dn}

    def _ratio_many(self, state, es, mo_up, mo_dn):
        """Ratios for electrons es (static), electron es[i] at the points
        whose orbitals are mo_*[:, i] (nconf, k, ..., norb_s); returns
        (nconf, k, ...)."""
        parts, order = [], []
        for s, (mo, inv, n, base) in enumerate(((mo_up, state.inv_up, self.nup, 0),
                                                (mo_dn, state.inv_dn, self.ndn, self.nup))):
            idxs = [i for i, e in enumerate(es) if (e < self.nup) == (s == 0)]
            if not idxs:
                continue
            rows = index_tensor([es[i] - base for i in idxs], inv.device)
            icol = inv[:, 0][:, :, rows]  # (nconf, n, k_s)
            sel = mo[:, index_tensor(idxs, mo.device)][..., :n]
            parts.append(torch.einsum("ck...j,cjk->ck...", sel, icol))
            order += idxs
        out = torch.cat(parts, dim=1)
        if order != sorted(order):
            out = out[:, index_tensor(np.argsort(order), out.device)]
        return out

    def testvalue_aux_all(self, params, state, aux, es=None):
        """Ratios (ne, nconf, naux) for moving electron es[i] to its own
        points aux[i] (ne, nconf, naux, 3), es a static sequence of electron
        indices (None: all, in order): the ECP quadrature. The orbitals are
        evaluated once on the flat point set, in the transposed layout
        (norb, points) of eval_mo_t (K3's layout, as models/slater.py:239-313
        consumes it)."""
        ne, nc, nq, _ = aux.shape
        es = tuple(range(ne)) if es is None else tuple(int(e) for e in es)
        mo_r = self.orbitals.eval_mo_t(params, aux.reshape(-1, 3)).reshape(-1, ne, nc, nq)
        norb_up = self.orbitals.norb[0]
        outs, order = [], []
        for s, (inv, n, off, base) in enumerate(((state.inv_up, self.nup, 0, 0),
                                                 (state.inv_dn, self.ndn, norb_up, self.nup))):
            idxs = [i for i, e in enumerate(es) if (e < self.nup) == (s == 0)]
            if not idxs:
                continue
            rows = index_tensor([es[i] - base for i in idxs], inv.device)
            sel = mo_r[off:off + n][:, index_tensor(idxs, mo_r.device)]  # (n, k, nc, nq)
            icol = inv[:, 0][:, :, rows]  # (nc, n, k)
            outs.append(torch.einsum("jkcq,cjk->kcq", sel, icol))
            order += idxs
        out = torch.cat(outs, dim=0)
        if order != sorted(order):
            out = out[index_tensor(np.argsort(order), out.device)]
        return out

    def gradient_value(self, params, state, e, epos):
        """(grad psi/psi at epos (nconf, 3), ratio (nconf,), saved)."""
        mo_up, mo_dn, gmo_up, gmo_dn = self.orbitals.eval(params, epos, 1)
        m4u = torch.cat([mo_up[:, None, :], gmo_up], dim=1)
        m4d = torch.cat([mo_dn[:, None, :], gmo_dn], dim=1)
        r = self._ratio(state, e, m4u, m4d)  # (nconf, 4)
        saved = {"mo_up": mo_up, "mo_dn": mo_dn, "gmo_up": gmo_up, "gmo_dn": gmo_dn}
        return r[:, 1:4] / r[:, 0:1], r[:, 0], saved

    def gradient_current(self, params, state, e, epos=None):
        """grad log psi of electron e at its current position, from the
        orbital cache (no AO evaluation)."""
        s, row = self._spin_row(e)
        mog = state.mog_up if s == 0 else state.mog_dn
        r = self._ratio(state, e, mog[:, row], mog[:, row])  # (nconf, 4)
        return r[:, 1:4] / r[:, 0:1]

    def move_begin(self, params, state, e, epos):
        """Move protocol, first half: gradient at the current position."""
        return self.gradient_current(params, state, e, epos), None

    def move_finish(self, params, state, e, epos, aux):
        """Move protocol, second half: (grad_new, ratio, saved) at epos."""
        return self.gradient_value(params, state, e, epos)

    def gradient_laplacian(self, params, state, e, epos):
        """(grad psi/psi, lap psi/psi) at epos."""
        mo_up, mo_dn, gmo_up, gmo_dn, lmo_up, lmo_dn = self.orbitals.eval(params, epos, 2)
        ratio = self._ratio(state, e, mo_up, mo_dn)
        gratio = self._ratio(state, e, gmo_up, gmo_dn)
        lratio = self._ratio(state, e, lmo_up, lmo_dn)
        return gratio / ratio[:, None], lratio / ratio

    def gradient_laplacian_many(self, params, state, es, epos):
        """gradient_laplacian of electrons es (static) at epos (nconf, k, 3):
        one orbital evaluation of all k * nconf points (K6's launch on the
        periodic path) -> (grad (nconf, k, 3), lap (nconf, k))."""
        mo_up, mo_dn, gmo_up, gmo_dn, lmo_up, lmo_dn = self.orbitals.eval(params, epos, 2)
        ratio = self._ratio_many(state, es, mo_up, mo_dn)
        g = self._ratio_many(state, es, gmo_up, gmo_dn)
        lap = self._ratio_many(state, es, lmo_up, lmo_dn)
        return g / ratio[..., None], lap / ratio

    def updateinternals(self, params, state, e, epos, mask, saved):
        """Sherman-Morrison update where `mask`, plus the orbital cache row."""
        s, row = self._spin_row(e)
        if "gmo_up" in saved:
            mo, gmo = (saved["mo_up"], saved["gmo_up"]) if s == 0 else (saved["mo_dn"], saved["gmo_dn"])
        else:
            mo_up, mo_dn, gmo_up, gmo_dn = self.orbitals.eval(params, epos, 1)
            mo, gmo = (mo_up, gmo_up) if s == 0 else (mo_dn, gmo_dn)
        n = self.nup if s == 0 else self.ndn
        sfx = "up" if s == 0 else "dn"
        inv = getattr(state, f"inv_{sfx}")
        phase = getattr(state, f"phase_{sfx}")
        logdet = getattr(state, f"logdet_{sfx}")
        mog = getattr(state, f"mog_{sfx}")
        ratio, inv_new = sherman_morrison_row(inv, mo[:, None, :n], row)
        absr = torch.abs(ratio)
        safe = torch.where(absr == 0, torch.ones_like(absr), absr)
        m = mask[:, None]
        new4 = torch.cat([mo[:, None, :], gmo], dim=1)
        mog = mog.clone()
        mog[:, row] = torch.where(mask[:, None, None], new4, mog[:, row])
        return state._replace(**{
            f"inv_{sfx}": torch.where(m[..., None, None], inv_new, inv),
            f"phase_{sfx}": torch.where(m, phase * ratio / safe, phase),
            f"logdet_{sfx}": torch.where(m, logdet + torch.log(safe), logdet),
            f"mog_{sfx}": mog,
        })

"""Multi-determinant Slater wavefunction (counterpart of
pyqmc_tpu/models/slater.py).

    Psi = sum_d c_d det(up-orbitals occ_up[map_up[d]]) det(dn-orbitals occ_dn[map_dn[d]])

The state keeps the JAX package's shapes: per spin the inverses, phases and
log-determinants of every unique spin-determinant (a determinant axis of
length ndu / ndd), so states convert leaf for leaf. Methods are pure and
batched over walkers; the electron index `e` is a Python int, so the spin
is chosen on the host and only the moving spin's determinants are touched.
The orbitals are molecular (MolecularOrbitals, built from mo_coeff) or any
evaluator with the same protocol, such as KPointOrbitals.

Moving electron e to a point x multiplies Psi by a linear function of the
orbital values there: Psi(r_e = x) / Psi = sum_o phi_o(x) v_o, with
v_o = sum_{k,j: occ[k,j] = o} W_k inv_k[j, row(e)] and W_k the expansion
weight of unique determinant k (the sum of c_d det_d / Psi over the
determinants d that use it). Every ratio, gradient and laplacian is one
contraction with v (`_columns` holds it for every row), the JAX package's
per-determinant sum (`_ratio_terms`) in another order, so the ECP's
(walker, point) ratios never carry a determinant axis. The determinant of
the first n orbitals keeps its own paths (v is then a column of the one
inverse), those of the single-determinant port.

Complex orbitals (KPointOrbitals at a general twist, complex molecular
coefficients) or a complex det_coeff make the wavefunction complex: phases
of unit modulus, complex inverses, weights and ratios (models/slater.py:18,
:452-491 of the JAX package), and pgradient the holomorphic d log psi / dp.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.gto import eval_gto
from ..ops.linalg import sherman_morrison_row, slogdet_inv
from ..utils.constants import DeviceConstants, index_tensor
from ..utils.dtypes import complex_dtype, real_dtype, resolve_device
from .orbitals import MolecularOrbitals


class SlaterState(NamedTuple):
    inv_up: torch.Tensor  # (nconf, ndu, nup, nup)
    inv_dn: torch.Tensor  # (nconf, ndd, ndn, ndn)
    phase_up: torch.Tensor  # (nconf, ndu)
    logdet_up: torch.Tensor
    phase_dn: torch.Tensor  # (nconf, ndd)
    logdet_dn: torch.Tensor
    # orbital values (slot 0) and gradients (slots 1:4) of each electron at
    # its CURRENT position, so the drift at the old position is a small
    # contraction instead of an AO evaluation
    mog_up: torch.Tensor  # (nconf, nup, 4, norb_up)
    mog_dn: torch.Tensor  # (nconf, ndn, 4, norb_dn)


@dataclasses.dataclass(frozen=True)
class DeterminantExpansion:
    """Determinant bookkeeping: unique spin-determinants per spin, and the
    expansion's references to them."""

    occ_up: np.ndarray  # (ndu, nup) orbital indices
    occ_dn: np.ndarray  # (ndd, ndn)
    map_up: np.ndarray  # (ndet,)
    map_dn: np.ndarray  # (ndet,)

    # ndarray fields do not compare or hash by value on their own
    def __hash__(self):
        return hash((self.occ_up.tobytes(), self.occ_dn.tobytes(), self.map_up.tobytes(),
                     self.map_dn.tobytes()))

    def __eq__(self, other):
        return (np.array_equal(self.occ_up, other.occ_up)
                and np.array_equal(self.occ_dn, other.occ_dn)
                and np.array_equal(self.map_up, other.map_up)
                and np.array_equal(self.map_dn, other.map_dn))

    @staticmethod
    def single(nup, ndn):
        return DeterminantExpansion(
            occ_up=np.arange(nup)[None, :], occ_dn=np.arange(ndn)[None, :],
            map_up=np.zeros(1, dtype=np.int64), map_dn=np.zeros(1, dtype=np.int64),
        )

    def is_first_n(self):
        """One determinant, occupying the first n orbitals of each spin."""
        nup, ndn = self.occ_up.shape[1], self.occ_dn.shape[1]
        return (len(self.map_up) == 1 and self.occ_up.shape[0] == 1
                and self.occ_dn.shape[0] == 1
                and np.array_equal(self.occ_up[0], np.arange(nup))
                and np.array_equal(self.occ_dn[0], np.arange(ndn)))


def _one_hot(index, width):
    """(len(index), width) float64 with a 1 at (i, index[i])."""
    out = np.zeros((len(index), width))
    out[np.arange(len(index)), np.asarray(index, dtype=np.int64)] = 1.0
    return out


def _hold_singular(dead, inv, phase, logdet):
    """Determinants flagged `dead` (nconf, nd), singular at the walker's
    positions (a zero determinant, an update with a zero ratio, or one whose
    inverse overflows in float32), held at zero until the next recompute:
    phase 0, log|det| -inf and a zero inverse, so that they add nothing to
    any ratio or weight and every later update leaves them so. Without it
    the inverse's inf entries reach the ratios as 0 x inf = nan. Returns
    (inv, phase, logdet)."""
    zero = torch.zeros((), dtype=inv.dtype, device=inv.device)
    return (torch.where(dead[..., None, None], zero, inv), torch.where(dead, zero, phase),
            torch.where(dead, torch.full_like(logdet, -torch.inf), logdet))


class Slater:
    """params: {"det_coeff": (ndet,)} plus the orbitals' parameters
    ({"mo_coeff_alpha": (nao, norb_up), "mo_coeff_beta": (nao, norb_dn)}
    for molecular orbitals).

    The arguments come in the JAX package's order,
    Slater(mol, orbitals, expansion, mo_coeff=None, det_coeff=None):
    Slater(mol, None, expansion, (ca, cb), det_coeff=c) builds
    MolecularOrbitals from mo_coeff; Slater(mol, evaluator, expansion)
    takes a ready evaluator. An expansion of None is the single
    determinant of the first n orbitals; det_coeff defaults to ones."""

    def __init__(self, mol, orbitals=None, expansion=None, mo_coeff=None, det_coeff=None):
        self.nup, self.ndn = mol.nelec
        self.nelec = self.nup + self.ndn
        exp = DeterminantExpansion.single(self.nup, self.ndn) if expansion is None else expansion
        if exp.occ_up.shape[1] != self.nup or exp.occ_dn.shape[1] != self.ndn:
            raise ValueError(f"DeterminantExpansion electron counts ({exp.occ_up.shape[1]} "
                             f"up, {exp.occ_dn.shape[1]} dn) do not match mol.nelec "
                             f"{mol.nelec}")
        if orbitals is None and mo_coeff is None:
            raise ValueError("Slater needs orbitals or mo_coeff")
        self.orbitals = orbitals if orbitals is not None else MolecularOrbitals(mol, mo_coeff)
        norb = self.orbitals.norb
        for s, occ in enumerate((exp.occ_up, exp.occ_dn)):
            if occ.size and int(np.max(occ)) >= norb[s]:
                raise ValueError(f"the orbitals have {norb} columns; the expansion occupies "
                                 f"orbital {int(np.max(occ))} of spin {s}")
        self.expansion = exp
        self._first_n = exp.is_first_n()
        ndet = len(exp.map_up)
        self._det_coeff0 = np.ones(ndet) if det_coeff is None else np.asarray(det_coeff)
        # complex orbitals or coefficients: every orbital value is taken
        # complex (_eval), so that the ratios' contractions share one dtype
        self.is_complex = bool(getattr(self.orbitals, "is_complex", False)
                               or np.iscomplexobj(self._det_coeff0))
        if self._det_coeff0.shape != (ndet,):
            raise ValueError(f"det_coeff has shape {self._det_coeff0.shape} for {ndet} "
                             "determinants")
        # sel_s (ndet, nd_s): determinant d uses unique determinant map_s[d];
        # scat_s (norb_s, nd_s * n_s): column (k, j) of unique determinant k
        # holds orbital occ_s[k, j]
        const = {}
        for tag, occ, mp, nb in (("up", exp.occ_up, exp.map_up, norb[0]),
                                 ("dn", exp.occ_dn, exp.map_dn, norb[1])):
            const[f"map_{tag}"] = np.asarray(mp, dtype=np.int64)
            const[f"occ_{tag}"] = np.asarray(occ, dtype=np.int64).reshape(-1)
            const[f"sel_{tag}"] = _one_hot(mp, occ.shape[0])
            const[f"scat_{tag}"] = _one_hot(occ.reshape(-1), nb).T
        self._const = DeviceConstants(**const)

    @staticmethod
    def from_mean_field(mf):
        """Single determinant of the lowest nup / ndn orbitals of an SCF."""
        nup, ndn = mf.mol.nelec
        return Slater(mf.mol, None, DeterminantExpansion.single(nup, ndn),
                      (mf.mo_coeff[0][:, :nup], mf.mo_coeff[1][:, :ndn]))

    def make_params(self, device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        cdtype = complex_dtype(dtype) if np.iscomplexobj(self._det_coeff0) else dtype
        p = {"det_coeff": torch.as_tensor(self._det_coeff0, dtype=cdtype, device=device)}
        p.update(self.orbitals.make_params(device, dtype))
        return p

    def _eval(self, params, X, mode):
        """The orbitals' eval, complex throughout for a complex wavefunction."""
        out = self.orbitals.eval(params, X, mode)
        if self.is_complex:
            out = tuple(m if m.is_complex() else m.to(complex_dtype(m.dtype)) for m in out)
        return out

    # --- helpers ---------------------------------------------------------
    def _spin_row(self, e: int):
        return (0, e) if e < self.nup else (1, e - self.nup)

    def _c(self, like):
        return self._const.get(like.device, like.dtype)

    def _weights(self, params, state):
        """Signed, max-shifted expansion weights w_d = c_d phase_d
        exp(log|det_d| - ref): (w (nconf, ndet), their sum (nconf,), ref
        (nconf,))."""
        c = self._c(state.logdet_up)
        mu, md = c["map_up"], c["map_dn"]
        logs = state.logdet_up[:, mu] + state.logdet_dn[:, md]
        phase = state.phase_up[:, mu] * state.phase_dn[:, md]
        ref = torch.amax(logs, dim=1, keepdim=True)
        w = params["det_coeff"][None, :] * phase * torch.exp(logs - ref)
        return w, torch.sum(w, dim=1), ref[:, 0]

    def _unique_weights(self, params, state, s):
        """W (nconf, nd_s): the share of Psi carried by each unique
        determinant of spin s, sum over d with map_s[d] = k of w_d / sum(w)."""
        w, denom, _ = self._weights(params, state)
        return (w @ self._c(w)["sel_up" if s == 0 else "sel_dn"]) / denom[:, None]

    def _columns(self, params, state, s):
        """(nconf, width, n_s): column r holds the v of the electron of row
        r of spin s, Psi(r_e = x) / Psi = sum_o phi_o(x) v_o over the first
        `width` orbitals of spin s (n_s for the determinant of the first n
        orbitals, where v is a column of its inverse; all of them
        otherwise)."""
        inv = state.inv_up if s == 0 else state.inv_dn
        if self._first_n:
            return inv[:, 0]
        nconf, nd, n = inv.shape[:3]
        W = self._unique_weights(params, state, s)
        x = (inv * W[:, :, None, None]).reshape(nconf, nd * n, n)
        return self._c(inv)["scat_up" if s == 0 else "scat_dn"] @ x

    def _ratio(self, icol, mo):
        """sum_o mo[..., o] icol[:, o]; mo (nconf, [k,] norb), icol (nconf, width)."""
        mo = mo[..., :icol.shape[1]]
        if mo.ndim == 3:
            return torch.einsum("ckj,cj->ck", mo, icol)
        return torch.sum(mo * icol, dim=-1)

    def _column(self, params, state, e):
        """(spin of e, its v (nconf, width))."""
        s, row = self._spin_row(e)
        return s, self._columns(params, state, s)[:, :, row]

    def _ratio_e(self, params, state, e, mo_up, mo_dn):
        s, icol = self._column(params, state, e)
        return self._ratio(icol, mo_up if s == 0 else mo_dn)

    def _spin_columns(self, params, state, es):
        """{spin: _columns} of the spins of electrons es."""
        return {s: self._columns(params, state, s) for s in {int(e >= self.nup) for e in es}}

    def _ratio_many(self, columns, es, mo_up, mo_dn):
        """Ratios for electrons es (static), electron es[i] at the points
        whose orbitals are mo_*[:, i] (nconf, k, ..., norb_s); columns from
        _spin_columns; returns (nconf, k, ...)."""
        parts, order = [], []
        for s, (mo, base) in enumerate(((mo_up, 0), (mo_dn, self.nup))):
            idxs = [i for i, e in enumerate(es) if (e < self.nup) == (s == 0)]
            if not idxs:
                continue
            cols = columns[s]
            rows = index_tensor([es[i] - base for i in idxs], cols.device)
            icol = cols[:, :, rows]  # (nconf, width, k_s)
            sel = mo[:, index_tensor(idxs, mo.device)][..., :cols.shape[1]]
            parts.append(torch.einsum("ck...j,cjk->ck...", sel, icol))
            order += idxs
        out = torch.cat(parts, dim=1)
        if order != sorted(order):
            out = out[:, index_tensor(np.argsort(order), out.device)]
        return out

    # --- protocol ---------------------------------------------------------
    def recompute(self, params, positions):
        mo_up_all, mo_dn_all, gmo_up_all, gmo_dn_all = self._eval(params, positions, 1)
        nup, ndn = self.nup, self.ndn
        mo_up = mo_up_all[:, :nup]
        mo_dn = mo_dn_all[:, nup:]
        if self._first_n:
            m_up, m_dn = mo_up[:, None, :, :nup], mo_dn[:, None, :, :ndn]
        else:
            c = self._c(mo_up)
            m_up = self._det_matrices(mo_up, c["occ_up"], self.expansion.occ_up.shape[0])
            m_dn = self._det_matrices(mo_dn, c["occ_dn"], self.expansion.occ_dn.shape[0])
        pu, lu, iu = slogdet_inv(m_up)
        pd, ld, idn = slogdet_inv(m_dn)
        if not self._first_n:
            iu, pu, lu = _hold_singular(pu == 0, iu, pu, lu)
            idn, pd, ld = _hold_singular(pd == 0, idn, pd, ld)
        return SlaterState(
            inv_up=iu, inv_dn=idn, phase_up=pu, logdet_up=lu, phase_dn=pd, logdet_dn=ld,
            mog_up=torch.cat([mo_up[:, :, None, :], gmo_up_all[:, :nup]], dim=2),
            mog_dn=torch.cat([mo_dn[:, :, None, :], gmo_dn_all[:, nup:]], dim=2),
        )

    @staticmethod
    def _det_matrices(mo, occ_flat, nd):
        """mo (nconf, n, norb) -> (nconf, nd, n, n): row i of determinant k
        holds electron i's values of the orbitals occ[k]."""
        nconf, n = mo.shape[:2]
        return mo[:, :, occ_flat].reshape(nconf, n, nd, n).transpose(1, 2)

    def value(self, params, state):
        """(phase, logabs) of the expansion."""
        if self._first_n:
            c = params["det_coeff"][0]
            phase = torch.sgn(c) * state.phase_up[:, 0] * state.phase_dn[:, 0]
            return phase, torch.log(torch.abs(c)) + state.logdet_up[:, 0] + state.logdet_dn[:, 0]
        w, denom, ref = self._weights(params, state)
        absd = torch.abs(denom)
        # an expansion that is exactly zero (a node) gets a tiny value
        tiny = 1e-300 if absd.dtype == torch.float64 else 1e-30
        safe = torch.where(absd == 0, torch.full_like(absd, tiny), absd)
        return denom / safe, torch.log(safe) + ref

    def testvalue(self, params, state, e, epos):
        """Psi(r_e = epos) / Psi; epos (nconf, 3) or (nconf, naux, 3)."""
        mo_up, mo_dn = self._eval(params, epos, 0)
        return self._ratio_e(params, state, e, mo_up, mo_dn), {"mo_up": mo_up, "mo_dn": mo_dn}

    def testvalue_many(self, params, state, epos):
        """Ratios for moving EACH electron to epos (nconf, 3), one at a
        time: (nconf, nelec)."""
        mo_up, mo_dn = self._eval(params, epos, 0)
        outs = []
        for s, (mo, n) in enumerate(((mo_up, self.nup), (mo_dn, self.ndn))):
            if n == 0:
                continue
            cols = self._columns(params, state, s)
            outs.append(torch.einsum("cj,cjr->cr", mo[:, :cols.shape[1]], cols))
        return torch.cat(outs, dim=1)

    def testvalue_aux_all(self, params, state, aux, es=None):
        """Ratios (ne, nconf, naux) for moving electron es[i] to its own
        points aux[i] (ne, nconf, naux, 3), es a static sequence of electron
        indices (None: all, in order): the ECP quadrature. The orbitals are
        evaluated once on the flat point set: for the determinant of the
        first n orbitals in the transposed layout (norb, points) of
        eval_mo_t (K3's layout, as models/slater.py:239-313 consumes it),
        otherwise in the row layout of eval mode 0, as the JAX package's
        multi-determinant branch (:314-323) does."""
        ne, nc, nq, _ = aux.shape
        es = tuple(range(ne)) if es is None else tuple(int(e) for e in es)
        outs, order = [], []
        if self._first_n:
            mo_r = self.orbitals.eval_mo_t(params, aux.reshape(-1, 3)).reshape(-1, ne, nc, nq)
            if self.is_complex and not mo_r.is_complex():
                mo_r = mo_r.to(complex_dtype(mo_r.dtype))
            norb_up = self.orbitals.norb[0]
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
        else:
            mos = self._eval(params, aux.reshape(-1, 3), 0)
            for s, (mo, base) in enumerate(zip(mos, (0, self.nup))):
                idxs = [i for i, e in enumerate(es) if (e < self.nup) == (s == 0)]
                if not idxs:
                    continue
                cols = self._columns(params, state, s)
                rows = index_tensor([es[i] - base for i in idxs], cols.device)
                sel = mo.reshape(ne, nc, nq, -1)[index_tensor(idxs, mo.device)]
                outs.append(torch.einsum("kcqj,cjk->kcq", sel[..., :cols.shape[1]],
                                         cols[:, :, rows]))
                order += idxs
        out = torch.cat(outs, dim=0)
        if order != sorted(order):
            out = out[index_tensor(np.argsort(order), out.device)]
        return out

    def gradient_value(self, params, state, e, epos):
        """(grad psi/psi at epos (nconf, 3), ratio (nconf,), saved)."""
        mo_up, mo_dn, gmo_up, gmo_dn = self._eval(params, epos, 1)
        m4u = torch.cat([mo_up[:, None, :], gmo_up], dim=1)
        m4d = torch.cat([mo_dn[:, None, :], gmo_dn], dim=1)
        r = self._ratio_e(params, state, e, m4u, m4d)  # (nconf, 4)
        saved = {"mo_up": mo_up, "mo_dn": mo_dn, "gmo_up": gmo_up, "gmo_dn": gmo_dn}
        return r[:, 1:4] / r[:, 0:1], r[:, 0], saved

    def gradient(self, params, state, e, epos):
        """grad psi / psi of electron e at epos (nconf, 3)."""
        return self.gradient_value(params, state, e, epos)[0]

    def gradient_current(self, params, state, e, epos=None):
        """grad log psi of electron e at its current position, from the
        orbital cache (no AO evaluation)."""
        s, row = self._spin_row(e)
        mog = state.mog_up if s == 0 else state.mog_dn
        r = self._ratio_e(params, state, e, mog[:, row], mog[:, row])  # (nconf, 4)
        return r[:, 1:4] / r[:, 0:1]

    def gradient_value_pair(self, params, state, e, epos_old, epos_new):
        """One orbital evaluation of both positions: (grad at epos_old,
        grad at epos_new, ratio new / old, saved at epos_new)."""
        X = torch.stack([epos_old, epos_new], dim=1)  # (nconf, 2, 3)
        mo_up, mo_dn, gmo_up, gmo_dn = self._eval(params, X, 1)
        nconf = X.shape[0]
        s, icol = self._column(params, state, e)
        mo, gmo = (mo_up, gmo_up) if s == 0 else (mo_dn, gmo_dn)
        r = self._ratio(icol, mo)  # (nconf, 2)
        gr = self._ratio(icol, gmo.reshape(nconf, 6, -1)).reshape(nconf, 2, 3)
        saved = {"mo_up": mo_up[:, 1], "mo_dn": mo_dn[:, 1], "gmo_up": gmo_up[:, 1],
                 "gmo_dn": gmo_dn[:, 1]}
        return gr[:, 0] / r[:, 0, None], gr[:, 1] / r[:, 1, None], r[:, 1] / r[:, 0], saved

    def move_begin(self, params, state, e, epos):
        """Move protocol, first half: gradient at the current position."""
        return self.gradient_current(params, state, e, epos), None

    def move_finish(self, params, state, e, epos, aux):
        """Move protocol, second half: (grad_new, ratio, saved) at epos."""
        return self.gradient_value(params, state, e, epos)

    def gradient_laplacian(self, params, state, e, epos):
        """(grad psi/psi, lap psi/psi) at epos."""
        mo_up, mo_dn, gmo_up, gmo_dn, lmo_up, lmo_dn = self._eval(params, epos, 2)
        s, icol = self._column(params, state, e)
        ratio = self._ratio(icol, mo_up if s == 0 else mo_dn)
        gratio = self._ratio(icol, gmo_up if s == 0 else gmo_dn)
        lratio = self._ratio(icol, lmo_up if s == 0 else lmo_dn)
        return gratio / ratio[:, None], lratio / ratio

    def gradient_laplacian_many(self, params, state, es, epos):
        """gradient_laplacian of electrons es (static) at epos (nconf, k, 3):
        one orbital evaluation of all k * nconf points (K6's launch on the
        periodic path) -> (grad (nconf, k, 3), lap (nconf, k))."""
        mo_up, mo_dn, gmo_up, gmo_dn, lmo_up, lmo_dn = self._eval(params, epos, 2)
        cols = self._spin_columns(params, state, es)
        ratio = self._ratio_many(cols, es, mo_up, mo_dn)
        g = self._ratio_many(cols, es, gmo_up, gmo_dn)
        lap = self._ratio_many(cols, es, lmo_up, lmo_dn)
        return g / ratio[..., None], lap / ratio

    def updateinternals(self, params, state, e, epos, mask, saved):
        """Sherman-Morrison update of every unique determinant of the moving
        spin where `mask`, plus the orbital cache row."""
        s, row = self._spin_row(e)
        if "gmo_up" in saved:
            mo, gmo = (saved["mo_up"], saved["gmo_up"]) if s == 0 else (saved["mo_dn"], saved["gmo_dn"])
        else:
            mo_up, mo_dn, gmo_up, gmo_dn = self._eval(params, epos, 1)
            mo, gmo = (mo_up, gmo_up) if s == 0 else (mo_dn, gmo_dn)
        sfx = "up" if s == 0 else "dn"
        inv = getattr(state, f"inv_{sfx}")
        phase = getattr(state, f"phase_{sfx}")
        logdet = getattr(state, f"logdet_{sfx}")
        mog = getattr(state, f"mog_{sfx}")
        if self._first_n:
            rows = mo[:, None, :self.nup if s == 0 else self.ndn]
        else:
            nd, n = inv.shape[1:3]
            rows = mo[:, self._c(mo)[f"occ_{sfx}"]].reshape(mo.shape[0], nd, n)
        ratio, inv_new = sherman_morrison_row(inv, rows, row)
        absr = torch.abs(ratio)
        safe = torch.where(absr == 0, torch.ones_like(absr), absr)
        phase_new, logdet_new = phase * ratio / safe, logdet + torch.log(safe)
        if not self._first_n:
            inv_new, phase_new, logdet_new = _hold_singular(
                (absr == 0) | ~torch.isfinite(inv_new).all(dim=-1).all(dim=-1),
                inv_new, phase_new, logdet_new)
        m = mask[:, None]
        new4 = torch.cat([mo[:, None, :], gmo], dim=1)
        mog = mog.clone()
        mog[:, row] = torch.where(mask[:, None, None], new4, mog[:, row])
        return state._replace(**{
            f"inv_{sfx}": torch.where(m[..., None, None], inv_new, inv),
            f"phase_{sfx}": torch.where(m, phase_new, phase),
            f"logdet_{sfx}": torch.where(m, logdet_new, logdet),
            f"mog_{sfx}": mog,
        })

    def pgradient(self, params, positions):
        """d log psi / d params per walker, {"det_coeff": (nconf, ndet),
        "mo_coeff_alpha": (nconf, nao, norb_up), "mo_coeff_beta": ...}:
        the coefficients' derivatives from the expansion weights, the
        orbital coefficients' from tr(M^-1 dM) (models/slater.py:546-601).
        For k-point orbitals each spin's entry is a list over k of (nconf,
        nao, nocc_k), from the Bloch-summed AOs of each k
        (models/slater.py:_pgradient_kpoint, :501). For a complex
        wavefunction the derivatives are holomorphic, d log psi / dp, as the
        JAX package's (:505-560): d log|psi| along a real direction of a
        complex parameter is their real part, along its imaginary direction
        minus their imaginary part."""
        kpoint = not isinstance(self.orbitals, MolecularOrbitals)
        state = self.recompute(params, positions)
        w, denom, _ = self._weights(params, state)
        out = {"det_coeff": (w / params["det_coeff"][None, :]) / denom[:, None]}
        if kpoint:
            aos = self.orbitals.kaos(positions)  # (nconf, nelec, nk, nao)
        else:
            aos = eval_gto(self.orbitals.spec, positions, 0)[:, :, None, :]
        aos = aos.to(state.inv_up.dtype)
        nconf = positions.shape[0]
        for s, (inv, sl, cname) in enumerate(((state.inv_up, slice(0, self.nup), "mo_coeff_alpha"),
                                              (state.inv_dn, slice(self.nup, None),
                                               "mo_coeff_beta"))):
            blocks = params[cname] if kpoint else [params[cname]]
            nd, n = inv.shape[1:3]
            if n == 0:
                grads = [torch.zeros((nconf,) + tuple(b.shape), dtype=b.dtype, device=b.device)
                         for b in blocks]
                out[cname] = grads if kpoint else grads[0]
                continue
            W = self._unique_weights(params, state, s)  # (nconf, nd)
            scat = self._c(inv)["scat_up" if s == 0 else "scat_dn"]  # (norb, nd * n)
            grads, off = [], 0
            for k, b in enumerate(blocks):
                # t[c, k, j, m] = sum_i inv[c, k, j, i] ao[c, i, m], weighted by
                # W_k, each column (k, j) scattered onto its orbital occ[k, j]
                # (the orbitals off .. off + nocc of this k-point's block)
                t = torch.einsum("ckji,cim->ckjm", inv, aos[:, sl, k]) * W[:, :, None, None]
                grads.append(t.reshape(nconf, nd * n, -1).transpose(1, 2)
                             @ scat[off:off + b.shape[1]].T)
                off += b.shape[1]
            out[cname] = grads if kpoint else grads[0]
        return out

"""Self-contained RHF/UHF with DIIS (a copy of pyqmc_tpu/system/scf.py).

Replaces the reference's dependence on PySCF mean-field objects
(pyqmc/pyscftools.py:30-102) for generating trial-wavefunction MO
coefficients. Host-side numpy; runs once at setup.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.linalg

from . import integrals


@dataclasses.dataclass
class MeanField:
    mol: object
    mo_coeff: Tuple[np.ndarray, np.ndarray]  # per spin (nao, nmo)
    mo_energy: Tuple[np.ndarray, np.ndarray]
    mo_occ: Tuple[np.ndarray, np.ndarray]
    e_tot: float
    restricted: bool
    converged: bool = True

    @property
    def nelec(self):
        return self.mol.nelec


class _DIIS:
    def __init__(self, max_vec=8):
        self.errs = []
        self.focks = []
        self.max_vec = max_vec

    def update(self, F, err):
        self.focks.append(F.copy())
        self.errs.append(err.ravel().copy())
        if len(self.focks) > self.max_vec:
            self.focks.pop(0)
            self.errs.pop(0)
        n = len(self.focks)
        if n < 2:
            return F
        B = -np.ones((n + 1, n + 1))
        B[-1, -1] = 0.0
        for i in range(n):
            for j in range(n):
                B[i, j] = np.dot(self.errs[i], self.errs[j])
        rhs = np.zeros(n + 1)
        rhs[-1] = -1.0
        try:
            c = np.linalg.solve(B, rhs)[:n]
        except np.linalg.LinAlgError:
            return F
        return sum(ci * Fi for ci, Fi in zip(c, self.focks))


def _eigh_f(F, X):
    Fp = X.T @ F @ X
    e, Cp = np.linalg.eigh(Fp)
    return e, X @ Cp


def run_scf(
    mol,
    restricted: Optional[bool] = None,
    max_cycle: int = 200,
    conv_tol: float = 1e-10,
    level_shift: float = 0.0,
    guess_noise: float = 0.0,
    verbose: bool = False,
    integrals_cache: Optional[dict] = None,
    init_C: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> MeanField:
    """Run RHF (spin 0) or UHF.

    integrals_cache: a mutable dict reused across calls with the SAME
    geometry/basis — overlap/kinetic/nuclear/ERI are computed once and
    stored there. The ECP matrix is always rebuilt (the ECP generator
    varies the pseudopotential at fixed basis, system/ecp_generate.py)."""
    if restricted is None:
        restricted = mol.spin == 0
    if integrals_cache is not None and "ERI" in integrals_cache:
        S, T, V, ERI = (integrals_cache[k] for k in ("S", "T", "V", "ERI"))
    else:
        S, T = integrals.overlap_kinetic(mol)
        V = integrals.nuclear(mol)
        ERI = integrals.eri(mol)
        if integrals_cache is not None:
            integrals_cache.update(S=S, T=T, V=V, ERI=ERI)
    # J/K as BLAS matvecs over flattened ERI: J = (ij|kl) D_kl is a gemv on
    # the (n^2, n^2) view; K = (ik|jl) D_kl needs the (i,k)<->(j) transposed
    # copy, built once and cached (the ECP generator runs hundreds of SCFs
    # in one fixed sea — a naive einsum contraction was ~100x slower for
    # 3d-metal all-electron seas, nao ~ 150).
    # MEMORY: ERI_K is a full second nao^4 array — ~4 GB f64 at nao~150 —
    # doubling the peak host memory of a cached-sea SCF. A per-iteration
    # tensordot over the strided view would avoid the persistent copy but
    # re-materializes the same transpose on EVERY Fock build, which is the
    # 100x slowdown above; keep the cache, and pass integrals_cache=None
    # (or evict "ERI_K") when memory is tighter than time.
    nao_ = S.shape[0]
    ERI_J = ERI.reshape(nao_ * nao_, nao_ * nao_)
    if integrals_cache is not None and "ERI_K" in integrals_cache:
        ERI_K = integrals_cache["ERI_K"]
    else:
        ERI_K = np.ascontiguousarray(ERI.transpose(0, 2, 1, 3)).reshape(
            nao_ * nao_, nao_ * nao_
        )
        if integrals_cache is not None:
            integrals_cache["ERI_K"] = ERI_K
    H = T + V
    if getattr(mol, "ecp", None):
        from .ecp_integrals import ecp_matrix

        H = H + ecp_matrix(mol)
    enuc = mol.nuclear_repulsion()
    nup, ndn = mol.nelec

    # symmetric orthogonalization with removal of linear dependencies
    s, U = np.linalg.eigh(S)
    keep = s > 1e-9
    X = U[:, keep] / np.sqrt(s[keep])

    e, C = _eigh_f(H, X)
    Cs = [C.copy(), C.copy()]
    if init_C is not None:
        Cs = [np.asarray(init_C[0]).copy(), np.asarray(init_C[1]).copy()]
    if guess_noise > 0:
        rng = np.random.default_rng(0)
        Cs[0] = C + guess_noise * rng.normal(size=C.shape)
        Cs[1] = C - guess_noise * rng.normal(size=C.shape)

    nocc = (nup, ndn)
    diis = [_DIIS(), _DIIS()]
    e_old = 0.0
    for it in range(max_cycle):
        D = [
            Cs[s_][:, : nocc[s_]] @ Cs[s_][:, : nocc[s_]].T if nocc[s_] > 0
            else np.zeros_like(S)
            for s_ in range(2)
        ]
        Dt = D[0] + D[1]
        J = (ERI_J @ Dt.ravel()).reshape(nao_, nao_)
        # one GEMM for both spin K matrices (one pass over ERI_K)
        KD = (ERI_K @ np.stack([D[0].ravel(), D[1].ravel()], axis=1))
        Ks = [KD[:, s_].reshape(nao_, nao_) for s_ in range(2)]
        Fs = [H + J - Ks[s_] for s_ in range(2)]
        if restricted:
            Favg = 0.5 * (Fs[0] + Fs[1])
            Fs = [Favg, Favg]
        e_elec = 0.5 * sum(np.sum((H + Fs[s_]) * D[s_]) for s_ in range(2))
        e_tot = e_elec + enuc
        # DIIS on FDS - SDF
        newC = []
        es = []
        for s_ in range(2):
            err = Fs[s_] @ D[s_] @ S - S @ D[s_] @ Fs[s_]
            F = diis[s_].update(Fs[s_], X.T @ err @ X)
            if level_shift > 0.0:
                F = F + level_shift * (S - S @ D[s_] @ S)
            ei, Ci = _eigh_f(F, X)
            newC.append(Ci)
            es.append(ei)
        Cs = newC
        if verbose:
            print(f"SCF iter {it}: E = {e_tot:.12f}")
        if abs(e_tot - e_old) < conv_tol and it > 1:
            scf_converged = True
            break
        e_old = e_tot
    else:
        scf_converged = False

    return MeanField(
        mol=mol,
        mo_coeff=(Cs[0], Cs[1]),
        mo_energy=(es[0], es[1]),
        mo_occ=(
            (np.arange(len(es[0])) < nup).astype(float),
            (np.arange(len(es[1])) < ndn).astype(float),
        ),
        e_tot=float(e_tot),
        restricted=restricted,
        converged=scf_converged,
    )

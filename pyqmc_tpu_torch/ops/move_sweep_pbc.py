"""Kernel 7: the Metropolis sweep of a periodic Slater-Jastrow wavefunction
with real (TRIM) k-point orbitals, hand-written in CUDA
(csrc/pbc_sweep.cu), with its plain PyTorch version beside it.

Counterpart of pyqmc_tpu/ops/move_pallas_pbc.py:build_fused_sweep_pbc in
its vmc mode. Per electron move, the kernel folds the proposal into the
supercell and accumulates the wrap delta, folds it into the primitive cell
and takes each orbital column's TRIM sign, evaluates the replicated-shell
AOs and contracts them with the folded coefficients R on the fly, takes the
Jastrow minimal image by rounding with the supercell constants, and updates
the inverse by Sherman-Morrison. One warp runs one walker, lane j owning
orbital column j of the moving electron's spin.

`build_fused_sweep_pbc` applies the JAX gate (`_match_sj_pbc`) once and
returns None outside it; ops/move_sweep.py:build_fused_sweep delegates
here for a periodic pattern. The returned `FusedSweepPBC` runs the plain
version for CPU tensors and launches the kernel for CUDA tensors; it never
falls back from one to the other. The plain version is
ops/move_sweep.py:sweep_plain with the periodic Geometry.enforce. The dmc
mode of the Pallas kernel is not ported yet: inside the gate, mode="dmc"
runs the plain dmc sweep on CPU tensors and raises KernelUnsupported on
CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from . import distances as _dist
from .gto_kernels import MAX_L, pack_groups
from .move_sweep import KernelUnsupported, WalkerState, _KIND, check_cuda, sweep_plain

LAUNCHES = _build.LaunchCount()
MAX_ORBITALS_PER_SPIN = 32  # one lane per orbital column
MAX_SHARED_BYTES = 227 * 1024

# header slots, in the order of enum PbcSlot in csrc/pbc_sweep.cu
(P_NELEC, P_NUP, P_NDN, P_NAO, P_NGROUPS, P_I_GROUPS, P_NK, P_F_KPTS, P_I_KORB, P_F_SLAT,
 P_F_SLATI, P_F_PLAT, P_F_PLATI, P_HASJ, P_NATOM, P_NA, P_NB, P_F_ATOMS, P_F_ABAS, P_F_BBAS,
 P_I_AKIND, P_I_BKIND, P_F_ACOEFF, P_F_BCOEFF, P_HEADER) = range(25)


def _match_sj_pbc(wf, geometry):
    """The JAX package's gate (move_pallas_pbc._match_sj_pbc), check for
    check: a periodic geometry; MultiplyWF(single-determinant real-mode
    k-point Slater with occ = the first n orbitals, JastrowSpin) or the
    Slater alone; both spins non-empty; the Jastrow's lattice the
    sampler's, and on a general lattice every cutoff within half the
    smallest cell height (so rounding is its minimal image). Returns
    (slater, jastrow, sl_idx, j_idx, orbitals) or None."""
    from ..models.jastrow import JastrowSpin
    from ..models.multiply import MultiplyWF
    from ..models.orbitals import KPointOrbitals
    from ..models.slater import Slater

    lat = getattr(geometry, "lattice", None)
    if lat is None:
        return None
    factors = list(wf.wfs) if isinstance(wf, MultiplyWF) else [wf]
    slater = jastrow = sl_idx = j_idx = None
    for i, f in enumerate(factors):
        if isinstance(f, Slater) and slater is None:
            slater, sl_idx = f, i
        elif isinstance(f, JastrowSpin) and jastrow is None:
            jastrow, j_idx = f, i
        else:
            return None
    if slater is None:
        return None
    orb = slater.orbitals
    if not isinstance(orb, KPointOrbitals):
        return None
    if not orb.real_mode or orb._repl_spec is None:
        return None
    exp = slater.expansion
    nup, ndn = slater.nup, slater.ndn
    if nup == 0 or ndn == 0:
        return None
    if len(exp.map_up) != 1 or exp.occ_up.shape[0] != 1 or exp.occ_dn.shape[0] != 1:
        return None
    if orb.norb != (nup, ndn):
        return None
    if not (np.array_equal(exp.occ_up[0], np.arange(nup))
            and np.array_equal(exp.occ_dn[0], np.arange(ndn))):
        return None
    if jastrow is not None:
        if any(b.kind not in ("polypade", "cutoffcusp") for b in jastrow.a_basis + jastrow.b_basis):
            return None
        jlat = getattr(jastrow.geometry, "lattice", None)
        if jlat is None or not np.allclose(jlat, lat):
            return None
        if _dist.classify_lattice(np.asarray(lat)) == _dist.MODE_GENERAL:
            heights = 1.0 / np.linalg.norm(np.linalg.inv(np.asarray(lat)), axis=0)
            rcut_max = max(b.rcut for b in jastrow.a_basis + jastrow.b_basis)
            if rcut_max > 0.5 * float(np.min(heights)) + 1e-9:
                return None
    return slater, jastrow, sl_idx, j_idx, orb


class PBCTables:
    """The kernel's packed tables (layout in csrc/pbc_sweep.cu): the
    replicated-shell basis, k-points and each orbital column's k, the
    supercell and primitive lattices and their inverses, and the Jastrow
    bases; the Jastrow coefficients are appended per call. The folded
    coefficients R go to the kernel as a separate (nao_repl, nup + ndn)
    matrix in concat row order."""

    def __init__(self, geometry, slater, jastrow, orb):
        spec = orb._repl_spec
        self.nup, self.ndn, self.nao = slater.nup, slater.ndn, spec.nao
        self.hasj = jastrow is not None
        self.concat_rows = np.argsort(spec.perm)
        if max(self.nup, self.ndn) > MAX_ORBITALS_PER_SPIN:
            self.unsupported = f"more than {MAX_ORBITALS_PER_SPIN} electrons of one spin"
        elif max(g.l for g in spec.groups) > MAX_L:
            self.unsupported = f"AO angular momentum above l={MAX_L}"
        else:
            self.unsupported = None
        fl: list = []

        def put(arr):
            off = len(fl)
            fl.extend(np.asarray(arr, dtype=np.float64).ravel().tolist())
            return off

        meta = [0] * P_HEADER
        meta[P_NELEC], meta[P_NUP], meta[P_NDN] = self.nup + self.ndn, self.nup, self.ndn
        meta[P_NAO], meta[P_NGROUPS] = spec.nao, len(spec.groups)
        meta[P_I_GROUPS] = pack_groups(spec, put, meta)
        meta[P_NK], meta[P_F_KPTS] = orb.nk, put(orb.kpts)
        meta[P_I_KORB] = len(meta)
        meta += orb._korb.tolist()
        slat = np.asarray(geometry.lattice, dtype=np.float64)
        meta[P_F_SLAT], meta[P_F_SLATI] = put(slat), put(np.linalg.inv(slat))
        meta[P_F_PLAT], meta[P_F_PLATI] = put(orb.lattice), put(orb.lattice_inv)
        if self.hasj:
            self.natom, self.na, self.nb = (jastrow.natom, len(jastrow.a_basis),
                                            len(jastrow.b_basis))
            meta[P_HASJ], meta[P_NATOM], meta[P_NA], meta[P_NB] = 1, self.natom, self.na, self.nb
            meta[P_F_ATOMS] = put(jastrow.atom_coords)
            meta[P_F_ABAS] = put([[b.param, b.rcut] for b in jastrow.a_basis])
            meta[P_F_BBAS] = put([[b.param, b.rcut] for b in jastrow.b_basis])
            meta[P_I_AKIND] = len(meta)
            meta += [_KIND[b.kind] for b in jastrow.a_basis]
            meta[P_I_BKIND] = len(meta)
            meta += [_KIND[b.kind] for b in jastrow.b_basis]
            n0 = len(fl)
            meta[P_F_ACOEFF] = n0
            meta[P_F_BCOEFF] = n0 + self.natom * self.na * 2
            self.ntab = n0 + self.natom * self.na * 2 + self.nb * 3
        else:
            self.ntab = len(fl)
        self._static = np.asarray(fl)
        self._meta = np.asarray(meta, dtype=np.int32)
        self._cache = {}

    def check(self):
        if self.unsupported is not None:
            raise KernelUnsupported(self.unsupported)

    def pack(self, j_params, device, dtype):
        """(tab, meta, concat rows) tensors on `device`."""
        key = (torch.device(device), dtype)
        if key not in self._cache:
            self._cache[key] = (torch.as_tensor(self._static, dtype=dtype, device=device),
                                torch.as_tensor(self._meta, device=device),
                                torch.as_tensor(self.concat_rows, device=device))
        static, meta, rows = self._cache[key]
        parts = [static]
        if self.hasj:
            parts += [j_params["acoeff"].reshape(-1), j_params["bcoeff"].reshape(-1)]
        tab = torch.cat([p.to(dtype) for p in parts])
        if tab.numel() != self.ntab:
            raise ValueError(f"parameters do not fit the tables: {tab.numel()} != {self.ntab}")
        return tab, meta, rows


class FusedSweepPBC:
    """sweep(params, positions, wrap, state, gauss_step, unif_step)
    -> (positions, wrap, state, acc), or (acc, r2p, r2a) last in the dmc
    mode: the contract of `sweep_plain`."""

    def __init__(self, wf, geometry, tstep, drift_cutoff, match, mode="vmc"):
        self.wf, self.geometry, self.mode = wf, geometry, mode
        self.tstep, self.drift_cutoff = float(tstep), float(drift_cutoff)
        self.slater, self.jastrow, self.sl_idx, self.j_idx, self.orb = match
        self.tables = PBCTables(geometry, self.slater, self.jastrow, self.orb)
        self.walkers = WalkerState(wf, self.slater, self.jastrow, self.sl_idx, self.j_idx)

    def __call__(self, params, positions, wrap, state, gauss_step, unif_step):
        if positions.device.type == "cpu":
            return self.plain(params, positions, wrap, state, gauss_step, unif_step)
        if positions.device.type != "cuda":
            raise ValueError(f"no sweep for device {positions.device}")
        return self.kernel(params, positions, wrap, state, gauss_step, unif_step)

    def plain(self, params, positions, wrap, state, gauss_step, unif_step):
        return sweep_plain(self.wf, self.geometry, self.tstep, self.drift_cutoff, params,
                           positions, wrap, state, gauss_step, unif_step, mode=self.mode)

    def kernel(self, params, positions, wrap, state, gauss_step, unif_step):
        nconf, nelec = positions.shape[:2]
        dtype = positions.dtype
        if self.mode != "vmc":
            raise KernelUnsupported("the dmc mode of the periodic sweep kernel is not ported")
        self.tables.check()
        if gauss_step.shape != (nelec, nconf, 3) or unif_step.shape != (nelec, nconf):
            raise ValueError("gauss_step must be (nelec, nconf, 3) and unif_step (nelec, nconf), "
                             f"got {tuple(gauss_step.shape)} and {tuple(unif_step.shape)}")
        sl_params, sl, j_params, js = self.walkers.split(params, state)
        state_in, sizes = self.walkers.pack(positions, sl, js, walker_major=True)
        tab, meta, rows = self.tables.pack(j_params, positions.device, dtype)
        R = self.orb._folded_coeff(sl_params, dtype)[rows].contiguous()
        gauss_w = gauss_step.permute(1, 0, 2).contiguous()  # (nconf, nelec, 3)
        unif_w = unif_step.t().contiguous()  # (nconf, nelec)
        state_out = torch.empty_like(state_in)
        wrapd = torch.empty((nconf, nelec, 3), dtype=dtype, device=positions.device)
        nacc = torch.empty(nconf, dtype=dtype, device=positions.device)
        check_cuda(dtype, state_in, gauss_w, unif_w, R, tab, meta, state_out, wrapd, nacc)
        _build.launch("pq_pbc_sweep", dtype, state_in.data_ptr(), state_out.data_ptr(),
                      gauss_w.data_ptr(), unif_w.data_ptr(), wrapd.data_ptr(), nacc.data_ptr(),
                      R.data_ptr(), tab.data_ptr(), tab.numel(), meta.data_ptr(), meta.numel(),
                      nconf, state_in.shape[1], self.tables.nao, R.shape[1], nelec, self.tstep,
                      self.drift_cutoff)
        LAUNCHES.add()
        pos_o, new_state = self.walkers.unpack(state_out, sizes, state, walker_major=True)
        # wrap deltas are whole numbers (floor in the kernel's dtype)
        return pos_o, wrap + wrapd.to(torch.int32), new_state, torch.mean(nacc)


def build_fused_sweep_pbc(wf, geometry, tstep, drift_cutoff=1.0, mode="vmc"):
    """FusedSweepPBC for a periodic wavefunction inside the gate, else None
    (the caller then runs sweep_plain). Only the vmc mode's kernel is
    ported: a dmc-mode sweep raises KernelUnsupported on CUDA tensors."""
    m = _match_sj_pbc(wf, geometry)
    if m is None:
        return None
    return FusedSweepPBC(wf, geometry, tstep, drift_cutoff, m, mode=mode)

"""One sweep of single-electron moves over all electrons of a Slater-Jastrow
wavefunction, hand-written in CUDA, with its plain PyTorch version beside
it. Counterpart of pyqmc_tpu/ops/move_pallas.py:build_fused_sweep, in both
of its modes:

  mode="vmc"  the Metropolis sweep of method/vmc.py: drift capped in norm
              (`limdrift`); kernel csrc/vmc_sweep.cu; returns
              (positions, wrap, state, acc);
  mode="dmc"  the drift-diffusion sweep of method/dmc.py: Umrigar drift
              limiting (`limdrift_umrigar`), fixed-node rejection of moves
              with ratio <= 0, and the per-walker sums of proposed and
              accepted squared displacements that the effective time step
              needs; kernel csrc/dmc_sweep.cu; returns
              (positions, wrap, state, (acc, r2p, r2a)).

Both kernels are instances of one template (csrc/sweep_kernel.cuh), each
with its own C symbol and launch counter. `build_fused_sweep` applies the
same gate as the JAX function (`_match_sj`) once, when a block is built, and
returns None outside it. The returned `FusedSweep` runs the plain version
for CPU tensors and launches the kernel for CUDA tensors; it never falls
back from one to the other.

The plain version, `sweep_plain`, is the sweep of method/vmc.py (or
method/dmc.py) over the wavefunction's move protocol (default_move_begin /
default_move_finish / updateinternals). Kernel and plain version consume
the same pre-drawn gauss and unif, so in float64 they give the same chain
to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .harmonics import cart2sph_matrix

LAUNCHES = _build.LaunchCount()  # vmc-mode kernel
DMC_LAUNCHES = _build.LaunchCount()  # dmc-mode kernel
MODES = ("vmc", "dmc")

# kernel caps (csrc/sweep_kernel.cuh and csrc/tmove_sweep.cu instantiate
# NMAX 4 and 16; csrc/lane_group.cuh handles l <= 3; csrc/ecp_device.cuh
# MAXCHAN nonlocal channels per atom); shared memory without an opt-in
MAX_ELECTRONS_PER_SPIN = 16
MAX_L = 3
MAX_CHANNELS = 8
MAX_SHARED_BYTES = 48 * 1024



class KernelUnsupported(ValueError):
    """The wavefunction is inside the gate but outside a kernel's compile-time caps."""


def limdrift(g, cutoff=1.0):
    """Cap the drift vector norm (reference mc.py:76-89); a complex
    wavefunction drifts along Re(g)."""
    g = g.real
    tot = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
    return torch.where(tot > cutoff, g * (cutoff / tot), g)


def limdrift_umrigar(g, tau):
    """Umrigar et al. drift limiting (method/dmc.py:32-39):
    v -> v * (sqrt(1 + 2 v^2 tau) - 1) / (v^2 tau), on Re(g)."""
    g = g.real
    v2 = torch.sum(g * g, dim=-1, keepdim=True)
    taueff = torch.clamp(v2 * tau, min=1e-12)
    return g * ((torch.sqrt(1.0 + 2.0 * taueff) - 1.0) / taueff)


def sweep_plain(wf, geometry, tstep, drift_cutoff, params, positions, wrap, state,
                gauss_step, unif_step, mode="vmc"):
    """Sweep over all electrons: the Metropolis sweep of method/vmc.py
    (mode="vmc") or the drift-diffusion sweep of method/dmc.py:153-204
    (mode="dmc").

    gauss_step (nelec, nconf, 3), pre-scaled by sqrt(tstep); unif_step
    (nelec, nconf). Returns (positions, wrap, state, acc) with acc the sum
    over electrons of the mean acceptance; in dmc mode the last entry is
    (acc, r2p, r2a), r2p and r2a (nconf,) being each walker's summed
    squared displacement over every proposal and over the accepted ones.
    """
    from ..models.multiply import default_move_begin, default_move_finish

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dmc = mode == "dmc"
    positions = positions.clone()
    wrap = wrap.clone()
    acc = torch.zeros((), dtype=positions.dtype, device=positions.device)
    r2p = torch.zeros(positions.shape[0], dtype=positions.dtype, device=positions.device)
    r2a = torch.zeros_like(r2p)
    for e in range(positions.shape[1]):
        epos = positions[:, e, :]
        grad_old, aux = default_move_begin(wf, params, state, e, epos)
        drift_old = limdrift_umrigar(grad_old, tstep) if dmc else limdrift(grad_old, drift_cutoff)
        gauss = gauss_step[e]
        newpos, wrapdelta = geometry.enforce(epos + gauss + tstep * drift_old)
        grad_new, ratio, saved = default_move_finish(wf, params, state, e, newpos, aux)
        drift_new = limdrift_umrigar(grad_new, tstep) if dmc else limdrift(grad_new, drift_cutoff)
        forward = torch.sum(gauss * gauss, dim=-1)
        backward = torch.sum((gauss + tstep * (drift_old + drift_new)) ** 2, dim=-1)
        t_prob = torch.exp((forward - backward) / (2.0 * tstep))
        accept_prob = torch.abs(ratio) ** 2 * t_prob
        if dmc and not ratio.is_complex():
            # fixed node: a move across the node is rejected (a complex
            # wavefunction has no node to cross: method/dmc.py:178-182)
            accept_prob = torch.where(ratio <= 0, torch.zeros_like(accept_prob), accept_prob)
        accept = accept_prob > unif_step[e]
        state = wf.updateinternals(params, state, e, newpos, accept, saved)
        positions[:, e, :] = torch.where(accept[:, None], newpos, epos)
        wrap[:, e, :] = torch.where(accept[:, None], wrap[:, e, :] + wrapdelta, wrap[:, e, :])
        acc = acc + torch.mean(accept.to(positions.dtype))
        if dmc:
            r2 = torch.sum((gauss + tstep * drift_old) ** 2, dim=-1)
            r2p = r2p + r2
            r2a = r2a + torch.where(accept, r2, torch.zeros_like(r2))
    if dmc:
        return positions, wrap, state, (acc, r2p, r2a)
    return positions, wrap, state, acc


def _match_sj(wf, geometry):
    """The JAX package's gate (move_pallas._match_sj): open boundary,
    MultiplyWF(single-determinant molecular Slater with occ = the first n
    orbitals, JastrowSpin) or either factor alone, both spins non-empty; the
    orbitals real, since the kernels are (complex ones run plain, as the
    JAX package's ECP energy takes K2 for real wavefunctions only,
    observables/ecp.py:645). Returns (slater, jastrow, sl_idx, j_idx) or
    None."""
    from ..models.jastrow import JastrowSpin
    from ..models.multiply import MultiplyWF
    from ..models.orbitals import MolecularOrbitals
    from ..models.slater import Slater

    # the checks of move_pallas._match_sj, in its order
    if getattr(geometry, "lattice", None) is not None:
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
    if not isinstance(slater.orbitals, MolecularOrbitals) or slater.orbitals.is_complex:
        return None
    exp = slater.expansion
    nup, ndn = slater.nup, slater.ndn
    if nup == 0 or ndn == 0:
        return None
    # one determinant whose occupation is the first n orbitals, so that the
    # orbital cache (all norb orbitals) is the kernels' occupied columns
    if not exp.is_first_n() or slater.orbitals.norb != (nup, ndn):
        return None
    if jastrow is not None:
        if any(b.kind not in ("polypade", "cutoffcusp")
               for b in jastrow.a_basis + jastrow.b_basis):
            return None
        # the port's JastrowSpin is open-boundary only and carries no
        # geometry; a periodic one will, and stays outside the gate
        if getattr(getattr(jastrow, "geometry", None), "lattice", None) is not None:
            return None
    return slater, jastrow, sl_idx, j_idx


# meta header slots, in the order of enum MetaSlot in csrc/sj_device.cuh
(M_NELEC, M_NUP, M_NDN, M_NAO, M_NATOM, M_NA, M_NB, M_NGROUPS, M_HASJ, M_F_CA, M_F_CB,
 M_F_ACOEFF, M_F_BCOEFF, M_F_ATOMS, M_F_ABAS, M_F_BBAS, M_I_AKIND, M_I_BKIND, M_I_GROUPS,
 M_NQATOMS, M_I_QATOMS, M_F_RMAX, M_HEADER) = range(23)
_KIND = {"polypade": 0, "cutoffcusp": 1}


class SJTables:
    """The kernels' packed tables (layout in csrc/sj_device.cuh).

    Static parts (basis, Jastrow bases, ECP quadrature) are packed once;
    the parameters (MO and Jastrow coefficients) are appended per call, so
    a parameter update needs no rebuild.
    """

    def __init__(self, slater, jastrow, ecp_acc=None):
        spec = slater.orbitals.spec
        self.nup, self.ndn = slater.nup, slater.ndn
        self.nao = spec.nao
        self.hasj = jastrow is not None
        if max(self.nup, self.ndn) > MAX_ELECTRONS_PER_SPIN:
            self.unsupported = f"more than {MAX_ELECTRONS_PER_SPIN} electrons of one spin"
        elif max(g.l for g in spec.groups) > MAX_L:
            self.unsupported = f"AO angular momentum above l={MAX_L}"
        else:
            self.unsupported = None
        self.concat_rows = np.argsort(spec.perm)  # AO order -> concat order
        fl: list = []
        meta = [0] * M_HEADER

        def put(arr):
            off = len(fl)
            fl.extend(np.asarray(arr, dtype=np.float64).ravel().tolist())
            return off

        meta[M_NELEC] = self.nup + self.ndn
        meta[M_NUP], meta[M_NDN], meta[M_NAO] = self.nup, self.ndn, self.nao
        meta[M_NGROUPS] = len(spec.groups)
        self.natom = self.na = self.nb = 0
        if self.hasj:
            self.natom, self.na, self.nb = (jastrow.natom, len(jastrow.a_basis),
                                            len(jastrow.b_basis))
            meta[M_HASJ] = 1
            meta[M_NATOM], meta[M_NA], meta[M_NB] = self.natom, self.na, self.nb
            meta[M_F_ATOMS] = put(jastrow.atom_coords)
            meta[M_F_ABAS] = put([[b.param, b.rcut] for b in jastrow.a_basis])
            meta[M_F_BBAS] = put([[b.param, b.rcut] for b in jastrow.b_basis])
            meta[M_I_AKIND] = len(meta)
            meta += [_KIND[b.kind] for b in jastrow.a_basis]
            meta[M_I_BKIND] = len(meta)
            meta += [_KIND[b.kind] for b in jastrow.b_basis]
        groups, row = [], 0
        prims, shells = [], []
        for gi, g in enumerate(spec.groups):
            S, P = g.alpha.shape
            f_cen, f_alpha, f_coef = (put(spec.atom_coords[g.shell_atoms]), put(g.alpha),
                                      put(g.coef))
            groups += [g.l, S, P, f_cen, f_alpha, f_coef, put(cart2sph_matrix(g.l)), row]
            row += S * (2 * g.l + 1)
            for si in range(S):
                live = np.flatnonzero(g.coef[si])
                shells.append([gi, si, len(prims), len(live)])
                prims += [[f_cen + 3 * si, f_alpha + si * P + p, f_coef + si * P + p]
                          for p in live]
        meta[M_I_GROUPS] = len(meta)
        meta += groups
        # the lane-group kernels' plan (csrc/lane_group.cuh): the primitives
        # with a nonzero coefficient, the shells, then per Jastrow basis kind
        # the e-ion pairs (atom, basis) and the e-e bases
        self.nprim = len(prims)
        ion = [[], []]
        bk = [[], []]
        if self.hasj:
            for k, b in enumerate(jastrow.b_basis):
                bk[_KIND[b.kind]].append(k)
            for atom in range(self.natom):
                for k, b in enumerate(jastrow.a_basis):
                    ion[_KIND[b.kind]] += [atom, k]
        self.plan = np.asarray(
            [len(prims), len(shells), len(ion[0]) // 2, len(ion[1]) // 2, len(bk[0]), len(bk[1])]
            + [i for p in prims for i in p] + [i for sh in shells for i in sh]
            + ion[0] + ion[1] + bk[0] + bk[1], dtype=np.int32)
        self.nq_total = 0
        if ecp_acc is not None:
            self._put_quadrature(ecp_acc, meta, put)
            if self.unsupported is None and any(len(a.nonlocal_channels) > MAX_CHANNELS
                                                for a in ecp_acc.nl_atoms):
                self.unsupported = f"more than {MAX_CHANNELS} nonlocal ECP channels on one atom"
        meta[M_F_RMAX] = put([ecp_acc.rmax if ecp_acc is not None else 0.0])
        # parameters, appended per call
        n0 = len(fl)
        meta[M_F_CA] = n0
        meta[M_F_CB] = n0 + self.nao * self.nup
        nparam = self.nao * (self.nup + self.ndn)
        if self.hasj:
            meta[M_F_ACOEFF] = n0 + nparam
            meta[M_F_BCOEFF] = n0 + nparam + self.natom * self.na * 2
            nparam += self.natom * self.na * 2 + self.nb * 3
        self.ntab = n0 + nparam
        self._static = np.asarray(fl)
        self._meta = np.asarray(meta, dtype=np.int32)
        self._cache = {}

    def _put_quadrature(self, ecp_acc, meta, put):
        """Quadrature atoms in the JAX kernel's order (move_pallas._quad_static):
        naip groups ascending, atoms in nl_atoms order within a group."""
        naip = ecp_acc.atom_naip
        order = [i for n in sorted(set(naip)) for i in range(len(naip)) if naip[i] == n]
        meta[M_NQATOMS] = len(order)
        meta[M_I_QATOMS] = len(meta)
        qstart = len(meta)
        meta += [0] * (5 * len(order))
        for qi, i in enumerate(order):
            aecp = ecp_acc.nl_atoms[i]
            pts, w = ecp_acc.atom_quad[i]
            chans = []
            for ch in aecp.nonlocal_channels:
                terms = np.stack([ch.coeffs, ch.exps, np.asarray(ch.powers, float)], axis=1)
                chans += [ch.l, len(ch.coeffs), put(terms)]
            meta[qstart + 5 * qi: qstart + 5 * qi + 5] = [
                len(w), put(np.concatenate([np.asarray(pts), np.asarray(w)[:, None]], axis=1)),
                len(aecp.nonlocal_channels), len(meta), put(ecp_acc.atom_coords[aecp.atom])]
            meta += chans
            self.nq_total += len(w)

    def shared_bytes(self, dtype):
        return self.ntab * torch.empty((), dtype=dtype).element_size() + 4 * len(self._meta)

    def check(self, dtype):
        """Raise KernelUnsupported outside the kernels' compile-time caps."""
        if self.unsupported is not None:
            raise KernelUnsupported(self.unsupported)
        if self.shared_bytes(dtype) > MAX_SHARED_BYTES:
            raise KernelUnsupported(f"tables need {self.shared_bytes(dtype)} bytes of shared "
                                    f"memory, over {MAX_SHARED_BYTES}")

    def pack(self, sl_params, j_params, device, dtype):
        """(tab, meta) tensors on `device`: static tables plus parameters."""
        key = (torch.device(device), dtype)
        if key not in self._cache:
            self._cache[key] = (
                torch.as_tensor(self._static, dtype=dtype, device=device),
                torch.as_tensor(self._meta, device=device),
                torch.as_tensor(self.concat_rows, device=device),
            )
        static, meta, rows = self._cache[key]
        parts = [static,
                 sl_params["mo_coeff_alpha"][rows, :self.nup].reshape(-1),
                 sl_params["mo_coeff_beta"][rows, :self.ndn].reshape(-1)]
        if self.hasj:
            parts += [j_params["acoeff"].reshape(-1), j_params["bcoeff"].reshape(-1)]
        tab = torch.cat([p.to(dtype) for p in parts])
        if tab.numel() != self.ntab:
            raise ValueError(f"parameters do not fit the tables: {tab.numel()} != {self.ntab}")
        return tab, meta

    def plan_tensor(self, device):
        """The lane-group kernels' plan (`plan`) as an int32 tensor on `device`."""
        key = ("plan", torch.device(device))
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(self.plan, device=device)
        return self._cache[key]


def check_cuda(dtype, *tensors, strided=()):
    """Device, dtype and contiguity checks before passing pointers to a
    kernel; `strided` tensors, which the kernel reads with their strides,
    are not held to contiguity."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    dev = tensors[0].device
    for t in (*tensors, *strided):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device}")
        if t.dtype != dtype and t.dtype != torch.int32:
            raise TypeError(f"kernel input of dtype {t.dtype}, expected {dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")


def _factor(wf, idx, params, state):
    from ..models.multiply import MultiplyWF

    if isinstance(wf, MultiplyWF):
        return params[f"wf{idx}"], state[idx]
    return params, state


class WalkerState:
    """The kernels' state rows, walker w's row r at [w, r] (walker-major).
    Rows: pos (3 nelec) | inv_up |
    inv_dn | phase_up | logdet_up | phase_dn | logdet_dn | mog_up | mog_dn
    | u (csrc/sweep_kernel.cuh)."""

    def __init__(self, wf, slater, jastrow, sl_idx, j_idx):
        self.wf, self.slater, self.jastrow = wf, slater, jastrow
        self.sl_idx, self.j_idx = sl_idx, j_idx

    def split(self, params, state):
        """(slater params, slater state, jastrow params or None, jastrow state or None)."""
        sl_params, sl = _factor(self.wf, self.sl_idx, params, state)
        if self.jastrow is None:
            return sl_params, sl, None, None
        j_params, js = _factor(self.wf, self.j_idx, params, state)
        return sl_params, sl, j_params, js

    def pack(self, positions, sl, js):
        """(nconf, rows) contiguous tensor and the row count of every leaf."""
        nconf, dtype = positions.shape[0], positions.dtype
        u = js.u if js is not None else torch.zeros(nconf, dtype=dtype, device=positions.device)
        cols = [positions, sl.inv_up, sl.inv_dn, sl.phase_up, sl.logdet_up, sl.phase_dn,
                sl.logdet_dn, sl.mog_up, sl.mog_dn, u]
        sizes = [c[0].numel() for c in cols]
        packed = torch.cat([c.reshape(nconf, -1).to(dtype) for c in cols], dim=1)
        return packed.contiguous(), sizes

    def unpack(self, packed, sizes, state):
        """(positions, new state) from the kernel's output rows."""
        from ..models.jastrow import JastrowState
        from ..models.multiply import MultiplyWF
        from ..models.slater import SlaterState

        nconf = packed.shape[0]
        nup, ndn = self.slater.nup, self.slater.ndn
        out = torch.split(packed, sizes, dim=1)
        pos_o = out[0].reshape(nconf, nup + ndn, 3)
        new_sl = SlaterState(
            inv_up=out[1].reshape(nconf, 1, nup, nup), inv_dn=out[2].reshape(nconf, 1, ndn, ndn),
            phase_up=out[3].reshape(nconf, 1), logdet_up=out[4].reshape(nconf, 1),
            phase_dn=out[5].reshape(nconf, 1), logdet_dn=out[6].reshape(nconf, 1),
            mog_up=out[7].reshape(nconf, nup, 4, nup), mog_dn=out[8].reshape(nconf, ndn, 4, ndn),
        )
        if not isinstance(self.wf, MultiplyWF):
            return pos_o, new_sl
        new_state = list(state)
        new_state[self.sl_idx] = new_sl
        if self.jastrow is not None:
            new_state[self.j_idx] = JastrowState(positions=pos_o, u=out[9].reshape(nconf))
        return pos_o, tuple(new_state)

    def nmax(self):
        """The kernels' template width: electrons of one spin, 4 or 16."""
        return 4 if max(self.slater.nup, self.slater.ndn) <= 4 else MAX_ELECTRONS_PER_SPIN


class FusedSweep:
    """sweep(params, positions, wrap, state, gauss_step, unif_step)
    -> (positions, wrap, state, acc), or (..., (acc, r2p, r2a)) in dmc
    mode: the contract of `sweep_plain`."""

    def __init__(self, wf, geometry, tstep, drift_cutoff, match, mode="vmc"):
        self.wf, self.geometry, self.mode = wf, geometry, mode
        self.tstep, self.drift_cutoff = float(tstep), float(drift_cutoff)
        self.slater, self.jastrow, self.sl_idx, self.j_idx = match
        self.tables = SJTables(self.slater, self.jastrow)
        self.walkers = WalkerState(wf, *match)

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
        name, (state_out, sizes, sums), inputs, args = self.pack(
            params, positions, wrap, state, gauss_step, unif_step)  # inputs held to the end
        _build.launch(name, positions.dtype, *args)
        (DMC_LAUNCHES if self.mode == "dmc" else LAUNCHES).add()
        pos_o, new_state = self.walkers.unpack(state_out, sizes, state)
        # sum over electrons of the mean acceptance = walker mean of the count
        acc = torch.mean(sums[0])
        if self.mode == "dmc":
            return pos_o, wrap, new_state, (acc, sums[1], sums[2])
        return pos_o, wrap, new_state, acc

    def pack(self, params, positions, wrap, state, gauss_step, unif_step):
        """(C entry name, (state_out, sizes, sums), inputs, its arguments) of
        one launch: the inputs checked and laid out as the kernel reads
        them and held while the caller launches, the outputs allocated."""
        nconf, nelec = positions.shape[:2]
        dtype = positions.dtype
        self.tables.check(dtype)
        if gauss_step.shape != (nelec, nconf, 3) or unif_step.shape != (nelec, nconf):
            raise ValueError("gauss_step must be (nelec, nconf, 3) and unif_step (nelec, nconf), "
                             f"got {tuple(gauss_step.shape)} and {tuple(unif_step.shape)}")
        sl_params, sl, j_params, js = self.walkers.split(params, state)
        state_in, sizes = self.walkers.pack(positions, sl, js)
        gauss_w = gauss_step.permute(1, 0, 2).contiguous()  # (nconf, nelec, 3)
        unif_t = unif_step.contiguous()  # (nelec, nconf)
        tab, meta = self.tables.pack(sl_params, j_params, positions.device, dtype)
        plan = self.tables.plan_tensor(positions.device)
        state_out = torch.empty_like(state_in)
        dmc = self.mode == "dmc"
        # per-walker outputs: accepted moves, and in dmc mode r2p and r2a
        sums = torch.empty((3 if dmc else 1, nconf), dtype=dtype, device=positions.device)
        check_cuda(dtype, state_in, gauss_w, unif_t, tab, meta, plan, state_out, sums)
        args = (state_in.data_ptr(), state_out.data_ptr(), gauss_w.data_ptr(), unif_t.data_ptr(),
                sums.data_ptr(), tab.data_ptr(), tab.numel(), meta.data_ptr(), meta.numel(),
                plan.data_ptr(), plan.numel(), nconf, state_in.shape[1], nelec, self.tables.nao,
                self.tables.nprim, self.walkers.nmax(), self.tstep)
        if not dmc:
            args += (self.drift_cutoff,)
        return ("pq_dmc_sweep" if dmc else "pq_vmc_sweep", (state_out, sizes, sums),
                (state_in, gauss_w, unif_t, tab, meta, plan), args)


def build_fused_sweep(wf, geometry, tstep, drift_cutoff=1.0, mode="vmc"):
    """FusedSweep for a wavefunction inside the gate, else None (the caller
    then uses sweep_plain). mode="dmc" applies Umrigar drift limiting and
    the fixed-node rejection and returns (acc, r2p, r2a) last. A periodic
    pattern goes to ops/move_sweep_pbc.py, as the JAX package's
    build_fused_sweep delegates to build_fused_sweep_pbc."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    m = _match_sj(wf, geometry)
    if m is None:
        from .move_sweep_pbc import build_fused_sweep_pbc

        return build_fused_sweep_pbc(wf, geometry, tstep, drift_cutoff, mode=mode)
    return FusedSweep(wf, geometry, tstep, drift_cutoff, m, mode=mode)

"""The Casula T-move sweep of fixed-node DMC with a nonlocal ECP,
hand-written in CUDA (csrc/tmove_sweep.cu), with its plain PyTorch version
beside it.

Counterpart of pyqmc_tpu/ops/move_pallas.py:build_fused_tmove_sweep (the
kernel) and of `tmove_sweep` in pyqmc_tpu/method/dmc.py (the plain version).
Per electron: the nonlocal quadrature on the walker's own rotation
(ECPAccumulator.tmove_quadrature), heat-bath selection among {stay} and the
quadrature points with amplitudes max(0, w_q r_q), the reverse-amplitude
acceptance norm / back_norm that keeps detailed balance, then the move to
the chosen point with the Sherman-Morrison and cache update.

`build_fused_tmove_sweep` applies the JAX function's gate once, when a block
is built, and returns None outside it. The returned `FusedTmoveSweep` runs
the plain version for CPU tensors and launches the kernel for CUDA tensors;
it never falls back from one to the other. Both consume the same pre-drawn
rotations and uniforms, so in float64 they give the same chain to rounding.
"""

from __future__ import annotations

import torch

from . import _build
from .move_sweep import SJTables, WalkerState, _match_sj, check_cuda

LAUNCHES = _build.LaunchCount()


def tmove_sweep_plain(wf, geometry, ecp_acc, tau, params, positions, wrap, state, rot,
                      u_sel, u_acc):
    """T-move sweep over all electrons (method/dmc.py:78-138 of the JAX
    package). rot (nelec, nconf, 3, 3): the electrons' quadrature rotations;
    u_sel, u_acc (nelec, nconf): the selection and acceptance uniforms.
    Returns (positions, wrap, state)."""
    positions = positions.clone()
    wrap = wrap.clone()
    for e in range(positions.shape[1]):
        aux, w, r = ecp_acc.tmove_quadrature(wf, params, state, positions, e, rot[e], tau)
        nq = w.shape[1]
        amp = torch.clamp(w * r, min=0.0)  # forward amplitudes
        norm = 1.0 + torch.sum(amp, dim=1)  # the weight of staying is 1
        # categories: 0 = stay, 1..nq = the points in quadrature order
        probs = torch.cat([1.0 / norm[:, None], amp / norm[:, None]], dim=1)
        cum = torch.cumsum(probs, dim=1)
        choice = torch.sum(u_sel[e][:, None] > cum, dim=1)  # 0..nq
        move = choice > 0
        qidx = torch.clamp(choice - 1, 0, nq - 1)
        r_m = torch.gather(r, 1, qidx[:, None])[:, 0]
        w_m = torch.gather(w, 1, qidx[:, None])[:, 0]
        # reverse amplitudes seen from the chosen point m, on the same
        # sphere: q != m: max(0, w_q r_q / r_m); q == m (back): w_m / r_m
        ok = move & (torch.abs(r_m) > 1e-30)
        inv_r = torch.where(ok, 1.0 / r_m, torch.zeros_like(r_m))
        amp_b = torch.clamp(w * r * inv_r[:, None], min=0.0)
        is_m = torch.arange(nq, device=w.device)[None, :] == qidx[:, None]
        amp_b = torch.where(is_m, torch.clamp(w_m * inv_r, min=0.0)[:, None], amp_b)
        back_norm = 1.0 + torch.sum(amp_b, dim=1)
        acc_prob = torch.where(move, norm / back_norm, torch.zeros_like(norm))
        accept = acc_prob > u_acc[e]
        newpos = torch.gather(aux, 1, qidx[:, None, None].expand(-1, 1, 3))[:, 0, :]
        newpos, wrapdelta = geometry.enforce(newpos)
        newpos = torch.where(accept[:, None], newpos, positions[:, e, :])
        # gradient_value, so that `saved` carries the orbital gradients the
        # Slater cache needs
        _, _, saved = wf.gradient_value(params, state, e, newpos)
        state = wf.updateinternals(params, state, e, newpos, accept, saved)
        positions[:, e, :] = newpos
        wrap[:, e, :] = torch.where(accept[:, None], wrap[:, e, :] + wrapdelta, wrap[:, e, :])
    return positions, wrap, state


class FusedTmoveSweep:
    """tmove(params, positions, wrap, state, rot, u_sel, u_acc)
    -> (positions, wrap, state): the contract of `tmove_sweep_plain`."""

    def __init__(self, wf, geometry, ecp_acc, tau, match):
        self.wf, self.geometry, self.ecp_acc, self.tau = wf, geometry, ecp_acc, float(tau)
        self.slater, self.jastrow, self.sl_idx, self.j_idx = match
        self.tables = SJTables(self.slater, self.jastrow, ecp_acc)
        self.walkers = WalkerState(wf, *match)

    def __call__(self, params, positions, wrap, state, rot, u_sel, u_acc):
        if positions.device.type == "cpu":
            return self.plain(params, positions, wrap, state, rot, u_sel, u_acc)
        if positions.device.type != "cuda":
            raise ValueError(f"no T-move sweep for device {positions.device}")
        return self.kernel(params, positions, wrap, state, rot, u_sel, u_acc)

    def plain(self, params, positions, wrap, state, rot, u_sel, u_acc):
        return tmove_sweep_plain(self.wf, self.geometry, self.ecp_acc, self.tau, params,
                                 positions, wrap, state, rot, u_sel, u_acc)

    def kernel(self, params, positions, wrap, state, rot, u_sel, u_acc):
        nconf, nelec = positions.shape[:2]
        dtype = positions.dtype
        self.tables.check(dtype)
        if (rot.shape != (nelec, nconf, 3, 3) or u_sel.shape != (nelec, nconf)
                or u_acc.shape != (nelec, nconf)):
            raise ValueError("rot must be (nelec, nconf, 3, 3) and u_sel, u_acc (nelec, nconf), "
                             f"got {tuple(rot.shape)}, {tuple(u_sel.shape)}, {tuple(u_acc.shape)}")
        sl_params, sl, j_params, js = self.walkers.split(params, state)
        state_in, sizes = self.walkers.pack(positions, sl, js)
        rot_t = rot.reshape(nelec, nconf, 9).permute(0, 2, 1).reshape(9 * nelec, nconf)
        rot_t = rot_t.to(dtype).contiguous()
        u_sel, u_acc = u_sel.contiguous(), u_acc.contiguous()
        tab, meta = self.tables.pack(sl_params, j_params, positions.device, dtype)
        state_out = torch.empty_like(state_in)
        # w_q and r_q of every quadrature point, walker-minor
        scratch = torch.empty((2 * self.tables.nq_total, nconf), dtype=dtype,
                              device=positions.device)
        check_cuda(dtype, state_in, rot_t, u_sel, u_acc, tab, meta, state_out, scratch)
        _build.launch("pq_tmove_sweep", dtype, state_in.data_ptr(), state_out.data_ptr(),
                      rot_t.data_ptr(), u_sel.data_ptr(), u_acc.data_ptr(), scratch.data_ptr(),
                      tab.data_ptr(), tab.numel(), meta.data_ptr(), meta.numel(), nconf,
                      state_in.shape[0], self.walkers.nmax(), self.tau)
        LAUNCHES.add()
        pos_o, new_state = self.walkers.unpack(state_out, sizes, state)
        return pos_o, wrap, new_state


def build_fused_tmove_sweep(wf, geometry, ecp_acc, tau, max_aux_evals=128):
    """FusedTmoveSweep for a wavefunction and ECP inside the JAX function's
    gate, else None (the caller then uses tmove_sweep_plain): the
    `_match_sj` pattern, an open-boundary ECP with nonlocal channels of
    l <= 6, and nelec * (nq + 2) <= 2 * max_aux_evals. The kernel's own caps
    are not part of the gate: outside them its launch raises
    KernelUnsupported."""
    m = _match_sj(wf, geometry)
    if m is None:
        return None
    if ecp_acc is None or not ecp_acc.nl_atoms:
        return None
    if getattr(ecp_acc, "_lattice", None) is not None:
        return None
    if any(ch.l > 6 for a in ecp_acc.nl_atoms for ch in a.nonlocal_channels):
        return None
    nelec = m[0].nup + m[0].ndn
    if nelec * (ecp_acc.nq_total + 2) > max_aux_evals * 2:
        return None
    return FusedTmoveSweep(wf, geometry, ecp_acc, tau, m)

"""Kernel 2: the nonlocal ECP energy of a Slater-Jastrow wavefunction,
hand-written in CUDA (csrc/ecp_energy.cu), with its plain PyTorch version
beside it.

Counterpart of pyqmc_tpu/ops/move_pallas.py:build_fused_ecp_energy. The
gate is the JAX one: the `_match_sj` pattern, dense quadrature (the only
mode the port has) and nelec * nq <= 512. The returned `FusedECPEnergy`
runs the plain chain for CPU tensors and launches the kernel for CUDA
tensors; it never falls back from one to the other.

The plain version, `ecp_nonlocal_plain`, is the dense ECPAccumulator chain:
per electron the quadrature geometry, then the wavefunction ratios of all
electrons' points through one `default_testvalue_aux_all` call.
"""

from __future__ import annotations

import torch

from . import _build
from .move_sweep import SJTables, _factor, _match_sj, check_cuda

LAUNCHES = _build.LaunchCount()


def ecp_nonlocal_plain(ecp_acc, wf, params, positions, state, rot):
    """Nonlocal ECP energy (nconf,) = sum_e sum_q T_q ratio_q, with rot
    (nelec, nconf, 3, 3) the per-electron quadrature rotations."""
    from ..models.multiply import default_testvalue_aux_all

    geo = [ecp_acc._quadrature_geometry(positions, e, rot[e]) for e in range(positions.shape[1])]
    aux = torch.stack([a for a, _ in geo])  # (nelec, nconf, nq, 3)
    T = torch.stack([t for _, t in geo])  # (nelec, nconf, nq)
    ratio = default_testvalue_aux_all(wf, params, state, aux)
    return torch.sum(torch.sum(T * ratio, dim=2), dim=0)


class FusedECPEnergy:
    """ecp_nl(params, positions, state, rot) -> (nconf,) nonlocal energy."""

    def __init__(self, wf, ecp_acc, match):
        self.wf, self.ecp_acc = wf, ecp_acc
        self.slater, self.jastrow, self.sl_idx, self.j_idx = match
        self.tables = SJTables(self.slater, self.jastrow, ecp_acc)

    def __call__(self, params, positions, state, rot):
        if positions.device.type == "cpu":
            return self.plain(params, positions, state, rot)
        if positions.device.type != "cuda":
            raise ValueError(f"no ECP energy for device {positions.device}")
        return self.kernel(params, positions, state, rot)

    def plain(self, params, positions, state, rot):
        return ecp_nonlocal_plain(self.ecp_acc, self.wf, params, positions, state, rot)

    def kernel(self, params, positions, state, rot):
        nconf, nelec = positions.shape[:2]
        nup, ndn = self.slater.nup, self.slater.ndn
        dtype = positions.dtype
        self.tables.check(dtype)
        if rot.shape != (nelec, nconf, 3, 3):
            raise ValueError(f"rot must be (nelec, nconf, 3, 3), got {tuple(rot.shape)}")
        sl_params, sl = _factor(self.wf, self.sl_idx, params, state)
        j_params = _factor(self.wf, self.j_idx, params, state)[0] if self.jastrow else None
        pos_t = positions.reshape(nconf, 3 * nelec).t().contiguous()
        invu = sl.inv_up.reshape(nconf, nup * nup).t().contiguous()
        invd = sl.inv_dn.reshape(nconf, ndn * ndn).t().contiguous()
        rot_t = rot.reshape(nelec, nconf, 9).permute(0, 2, 1).reshape(9 * nelec, nconf)
        rot_t = rot_t.to(dtype).contiguous()
        tab, meta = self.tables.pack(sl_params, j_params, positions.device, dtype)
        wvec = torch.empty((self.tables.nao, nelec * nconf), dtype=dtype, device=positions.device)
        partial = torch.empty((nelec, nconf), dtype=dtype, device=positions.device)
        out = torch.empty(nconf, dtype=dtype, device=positions.device)
        check_cuda(dtype, pos_t, invu, invd, rot_t, tab, meta, wvec, partial, out)
        _build.launch("pq_ecp_energy", dtype, pos_t.data_ptr(), invu.data_ptr(), invd.data_ptr(),
                      rot_t.data_ptr(), wvec.data_ptr(), partial.data_ptr(), out.data_ptr(),
                      tab.data_ptr(), tab.numel(), meta.data_ptr(), meta.numel(), nelec, nconf)
        LAUNCHES.add()
        return out


def build_fused_ecp_energy(wf, ecp_acc, max_aux_evals=512):
    """FusedECPEnergy for a wavefunction and ECP inside the gate, else None
    (the caller then uses ecp_nonlocal_plain). The kernel's own caps are
    not part of the gate: outside them its launch raises KernelUnsupported."""
    from ..configs import Geometry

    m = _match_sj(wf, Geometry())
    if m is None or not ecp_acc.nl_atoms:
        return None
    if any(ch.l > 6 for a in ecp_acc.nl_atoms for ch in a.nonlocal_channels):
        return None
    if ecp_acc.nelec * ecp_acc.nq_total > max_aux_evals:
        return None
    return FusedECPEnergy(wf, ecp_acc, m)

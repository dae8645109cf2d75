"""Kernel 2: the nonlocal ECP energy of a Slater-Jastrow wavefunction,
hand-written in CUDA (csrc/ecp_energy.cu: a group of lanes per walker, one
launch), with its plain PyTorch version beside it.

Counterpart of pyqmc_tpu/ops/move_pallas.py:build_fused_ecp_energy. The
gate is the JAX one: the `_match_sj` pattern, dense quadrature (the only
mode the port has) and nelec * nq <= 512. The returned `FusedECPEnergy`
runs the plain chain for CPU tensors and launches the kernel for CUDA
tensors; it never falls back from one to the other.

The plain version, `ecp_nonlocal_plain`, is the ECPAccumulator's flat
chain (observables/ecp.py:660-749): per static chunk of electrons the
quadrature geometry, the downselection where the accumulator has one, then
the wavefunction ratios of the chunk's points through one
`default_testvalue_aux_all` call. It is the only nonlocal path of a
periodic cell, whose ratios run on K3 (models/orbitals.py).
"""

from __future__ import annotations

import torch

from . import _build
from .move_sweep import (MAX_ELECTRONS_PER_SPIN, KernelUnsupported, SJTables, _factor, _match_sj,
                         check_cuda)

LAUNCHES = _build.LaunchCount()

# csrc/ecp_energy.cu: lanes per walker; csrc/lane_group.cuh: threads of a
# block and the shared memory a block may hold
LANES = 32
THREADS = 128
MAX_BLOCK_SHARED = 227 * 1024


def _up16(nbytes):
    return -(-nbytes // 16) * 16


def block_shared(tables, itemsize):
    """(walkers per block, dynamic shared bytes of a block) of the kernel,
    as csrc/ecp_energy.cu (ecp_smem, launch_ecp_g) and csrc/lane_group.cuh
    (staged_bytes, walkers_per_block) reckon them: the staged tables and
    plan, then each walker's positions, inverses, rotations and wvec, per
    point its T_q and Slater ratio, per point and electron a Jastrow u.
    0 walkers: none fits."""
    nelec, nq = tables.nup + tables.ndn, tables.nq_total
    per_walker = itemsize * (12 * nelec + tables.nup ** 2 + tables.ndn ** 2
                             + nelec * tables.nao + 2 * nelec * nq + nelec * (nq + 1))
    base = (_up16(tables.ntab * itemsize + 4 * len(tables._meta))
            + _up16(4 * len(tables.plan)))
    walkers = THREADS // LANES
    while walkers > 0 and base + walkers * per_walker > MAX_BLOCK_SHARED:
        walkers -= 1
    return walkers, base + walkers * per_walker


def ecp_nonlocal_plain(ecp_acc, wf, params, positions, state, rot, u_sel=None):
    """Nonlocal ECP energy (nconf,) = sum_e sum_q T_q ratio_q, with rot
    (nelec, nconf, 3, 3) the per-electron quadrature rotations and u_sel
    (nelec, nconf) the downselection uniforms (needed when the accumulator
    downselects)."""
    from ..models.multiply import default_testvalue_aux_all
    from ..observables.ecp import systematic_downselect

    nconf, nelec = positions.shape[:2]
    dense = ecp_acc.nselect is None or ecp_acc.nselect >= ecp_acc.nq_total
    if not dense and u_sel is None:
        raise ValueError("the downselected ECP needs the step's selection uniforms u_sel")
    chunk = ecp_acc.echunk
    if chunk == "auto":
        npts = ecp_acc.nq_total if dense else ecp_acc.nselect
        chunk = max(1, 262144 // max(nconf * npts, 1))
    chunk = nelec if chunk is None else min(int(chunk), nelec)
    out = torch.zeros(nconf, dtype=positions.dtype, device=positions.device)
    for c0 in range(0, nelec, chunk):
        es = tuple(range(c0, min(c0 + chunk, nelec)))
        epos = positions[:, c0:c0 + len(es)].transpose(0, 1)  # (k, nconf, 3)
        aux, T = ecp_acc.quadrature_geometry(epos, rot[c0:c0 + len(es)])
        if not dense:
            idx, wts = systematic_downselect(T, ecp_acc.nselect, u_sel[c0:c0 + len(es)])
            T = torch.gather(T, 2, idx) * wts
            aux = torch.gather(aux, 2, idx[..., None].expand(*idx.shape, 3))
        ratio = default_testvalue_aux_all(wf, params, state, aux,
                                          es=None if len(es) == nelec else es)
        out = out + torch.sum(torch.sum(T * ratio, dim=2), dim=0)
    return out


class FusedECPEnergy:
    """ecp_nl(params, positions, state, rot) -> (nconf,) nonlocal energy."""

    def __init__(self, wf, ecp_acc, match):
        self.wf, self.ecp_acc = wf, ecp_acc
        self.slater, self.jastrow, self.sl_idx, self.j_idx = match
        self.tables = SJTables(self.slater, self.jastrow, ecp_acc)

    def __call__(self, params, positions, state, rot, u_sel=None):
        if positions.device.type == "cpu":
            return self.plain(params, positions, state, rot)
        if positions.device.type != "cuda":
            raise ValueError(f"no ECP energy for device {positions.device}")
        return self.kernel(params, positions, state, rot)

    def plain(self, params, positions, state, rot, u_sel=None):
        return ecp_nonlocal_plain(self.ecp_acc, self.wf, params, positions, state, rot)

    def kernel(self, params, positions, state, rot):
        name, out, inputs, args = self.pack(params, positions, state, rot)  # inputs held to the end
        check_cuda(positions.dtype, out, *inputs[3:], strided=inputs[:3])
        _build.launch(name, positions.dtype, *args)
        LAUNCHES.add()
        return out

    def pack(self, params, positions, state, rot):
        """(C entry name, out, inputs, its arguments) of one launch, as
        FusedSweep.pack. Positions, both inverses and rot are handed over
        where they lie, with their strides (the positions' rows of 3 and
        rot in its (nelec, nconf, 3, 3) layout must be dense, as the
        caller's are: only another layout is copied). Raises
        KernelUnsupported where not one walker fits a block's shared
        memory."""
        nconf, nelec = positions.shape[:2]
        dtype = positions.dtype
        t = self.tables
        t.check(dtype)
        if rot.shape != (nelec, nconf, 3, 3):
            raise ValueError(f"rot must be (nelec, nconf, 3, 3), got {tuple(rot.shape)}")
        if block_shared(t, positions.element_size())[0] == 0:
            raise KernelUnsupported("not one walker fits the ECP kernel's shared memory")
        sl_params, sl = _factor(self.wf, self.sl_idx, params, state)
        j_params = _factor(self.wf, self.j_idx, params, state)[0] if self.jastrow else None
        if positions.stride()[1:] != (3, 1):
            positions = positions.contiguous()
        rot = rot.to(dtype).contiguous()
        invs = []
        for inv, n in ((sl.inv_up, t.nup), (sl.inv_dn, t.ndn)):
            inv = inv.to(dtype)
            if inv.shape[-2:] != (n, n) or inv.numel() != nconf * n * n:
                raise ValueError(f"an inverse must be (nconf, 1, {n}, {n}), "
                                 f"got {tuple(inv.shape)}")
            invs.append((inv, (inv.stride(0), inv.stride(-2), inv.stride(-1))))
        (invu, su), (invd, sd) = invs
        tab, meta = t.pack(sl_params, j_params, positions.device, dtype)
        plan = t.plan_tensor(positions.device)
        out = torch.empty(nconf, dtype=dtype, device=positions.device)
        args = (positions.data_ptr(), positions.stride(0), invu.data_ptr(), *su, invd.data_ptr(),
                *sd, rot.data_ptr(), out.data_ptr(), tab.data_ptr(), tab.numel(),
                meta.data_ptr(), meta.numel(), plan.data_ptr(), plan.numel(), nconf, nelec,
                t.nup, t.ndn, t.nao, t.nq_total,
                4 if max(t.nup, t.ndn) <= 4 else MAX_ELECTRONS_PER_SPIN)
        return "pq_ecp_energy", out, (positions, invu, invd, rot, tab, meta, plan), args


def build_fused_ecp_energy(wf, ecp_acc, max_aux_evals=512):
    """FusedECPEnergy for a wavefunction and ECP inside the gate, else None
    (the caller then uses ecp_nonlocal_plain). The kernel's own caps are
    not part of the gate: outside them its launch raises KernelUnsupported."""
    from ..configs import Geometry

    m = _match_sj(wf, Geometry(ecp_acc._lattice))
    if m is None or not ecp_acc.nl_atoms or ecp_acc.nselect is not None:
        return None
    if any(ch.l > 6 for a in ecp_acc.nl_atoms for ch in a.nonlocal_channels):
        return None
    if ecp_acc.nelec * ecp_acc.nq_total > max_aux_evals:
        return None
    return FusedECPEnergy(wf, ecp_acc, m)

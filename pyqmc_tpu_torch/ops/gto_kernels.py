"""Kernels 3 and 6: GTO evaluation over many points, hand-written in CUDA,
each with its plain PyTorch version beside it.

K3, `ValueMO` (csrc/value_mo.cu): value-only AOs contracted with a
coefficient matrix C (nao, norb) in the kernel's own body, one thread per
point, output in the transposed layout (norb, M) so that neighbouring
threads write neighbouring addresses. Counterpart of
pyqmc_tpu/ops/gto_pallas.py:build_pallas_value_mo and its two wrappers
`fused_value_mo_t` (the native (norb, M) layout) and `fused_value_mo`
(row-major (..., norb); here the same kernel, transposed in PyTorch). Plain
version: eval_gto(spec, X, 0) @ C.

K6, `EvalGTO2` (csrc/gto_eval.cu): AO values, gradients and laplacians,
one thread per point, written as (nao, M), (3 nao, M) and (nao, M) rows and
handed back transposed (views). Counterpart of
pyqmc_tpu/ops/gto_pallas.py:build_pallas_evaluator and its wrapper
`fused_eval_gto2`. Plain version: eval_gto(spec, X, 2). The MO products
after it stay torch.matmul, as the JAX package leaves them to XLA.

Both wrappers run the plain version for CPU tensors and launch the kernel
for CUDA tensors; they never fall back from one to the other. The callers
(models/orbitals.py) apply the JAX package's gates: the kernels serve
float32 only, K6 only from MIN_NAO_FUSED2 AOs on.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .gto import GTOSpec, eval_gto
from .harmonics import cart2sph_matrix
from .move_sweep import KernelUnsupported

VALUE_MO_LAUNCHES = _build.LaunchCount()  # K3
EVAL_GTO2_LAUNCHES = _build.LaunchCount()  # K6
MIN_NAO_FUSED2 = 128  # pyqmc_tpu/models/orbitals.py:_FUSED_MIN_NAO
MAX_L = 3  # csrc/ao_shell.cuh

# header slots of the tables (enum GtoSlot in csrc/ao_shell.cuh)
T_NAO, T_NGROUPS, T_I_GROUPS, T_I_AOROW, T_HEADER = range(5)


def pack_groups(spec: GTOSpec, put, meta):
    """Append the spec's l-groups to a table under construction: per group
    the ints l, S, P, offsets of centers (S, 3), alpha (S, P), coef (S, P)
    and the cart->sph weights, and its first concat row (GroupSlot in
    csrc/sj_device.cuh). Returns the meta offset of the first group."""
    start = len(meta)
    row = 0
    rows = []
    for g in spec.groups:
        S, P = g.alpha.shape
        rows += [g.l, S, P, put(spec.atom_coords[g.shell_atoms]), put(g.alpha), put(g.coef),
                 put(cart2sph_matrix(g.l)), row]
        row += S * (2 * g.l + 1)
    meta += rows
    return start


class GTOTables:
    """The basis as the kernels read it: a float table and an int table
    (layout in csrc/ao_shell.cuh), built once and cached per device and
    dtype. concat_rows[r] is the AO index of concat row r, the order in
    which the kernels visit the AOs (l-group, shell, m)."""

    def __init__(self, spec: GTOSpec):
        self.nao = spec.nao
        self.concat_rows = np.argsort(spec.perm)
        self.unsupported = (f"AO angular momentum above l={MAX_L}"
                            if max(g.l for g in spec.groups) > MAX_L else None)
        fl: list = []

        def put(arr):
            off = len(fl)
            fl.extend(np.asarray(arr, dtype=np.float64).ravel().tolist())
            return off

        meta = [0] * T_HEADER
        meta[T_NAO], meta[T_NGROUPS] = spec.nao, len(spec.groups)
        meta[T_I_GROUPS] = pack_groups(spec, put, meta)
        meta[T_I_AOROW] = len(meta)
        meta += self.concat_rows.tolist()
        self._tab = np.asarray(fl)
        self._meta = np.asarray(meta, dtype=np.int32)
        self._cache = {}

    def get(self, device, dtype):
        key = (torch.device(device), dtype)
        if key not in self._cache:
            self._cache[key] = (torch.as_tensor(self._tab, dtype=dtype, device=device),
                                torch.as_tensor(self._meta, device=device),
                                torch.as_tensor(self.concat_rows, device=device))
        return self._cache[key]


def _check(X, dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")


class ValueMO:
    """K3. mo_t = f.transposed(X (M, 3), C (nao, norb)) -> (norb, M);
    mo = f(X (..., 3), C) -> (..., norb). C is in AO order; the kernel
    reads it in concat row order."""

    def __init__(self, spec: GTOSpec):
        self.spec = spec
        self.tables = GTOTables(spec)

    def transposed(self, X, C):
        if X.device.type == "cpu":
            return (eval_gto(self.spec, X, 0) @ C).T
        return self.kernel_t(X, C)

    def __call__(self, X, C):
        if X.device.type == "cpu":
            return eval_gto(self.spec, X, 0) @ C
        shape = X.shape[:-1]
        return self.kernel_t(X.reshape(-1, 3), C).T.reshape(*shape, C.shape[1])

    def plain_t(self, X, C):
        return (eval_gto(self.spec, X, 0) @ C).T

    def kernel_t(self, X, C):
        dtype = X.dtype
        _check(X, dtype)
        if self.tables.unsupported:
            raise KernelUnsupported(self.tables.unsupported)
        if C.shape[0] != self.tables.nao:
            raise ValueError(f"C has {C.shape[0]} rows for {self.tables.nao} AOs")
        tab, meta, rows = self.tables.get(X.device, dtype)
        Xc = X.to(dtype).contiguous()
        Cr = C.to(dtype)[rows].contiguous()
        M, norb = Xc.shape[0], Cr.shape[1]
        out = torch.empty((norb, M), dtype=dtype, device=X.device)
        if M == 0:
            return out
        _build.launch("pq_value_mo", dtype, Xc.data_ptr(), Cr.data_ptr(), out.data_ptr(),
                      tab.data_ptr(), tab.numel(), meta.data_ptr(), meta.numel(), M, norb,
                      self.tables.nao)
        VALUE_MO_LAUNCHES.add()
        return out


class EvalGTO2:
    """K6. f(X (..., 3)) -> (ao (..., nao), grad (..., 3, nao), lap (..., nao))."""

    def __init__(self, spec: GTOSpec):
        self.spec = spec
        self.tables = GTOTables(spec)

    def __call__(self, X):
        if X.device.type == "cpu":
            return self.plain(X)
        return self.kernel(X)

    def plain(self, X):
        return eval_gto(self.spec, X, 2)

    def kernel(self, X):
        dtype = X.dtype
        _check(X, dtype)
        if self.tables.unsupported:
            raise KernelUnsupported(self.tables.unsupported)
        shape, nao = X.shape[:-1], self.tables.nao
        Xc = X.reshape(-1, 3).contiguous()
        M = Xc.shape[0]
        tab, meta, _ = self.tables.get(X.device, dtype)
        ao = torch.empty((nao, M), dtype=dtype, device=X.device)
        grad = torch.empty((3 * nao, M), dtype=dtype, device=X.device)
        lap = torch.empty((nao, M), dtype=dtype, device=X.device)
        if M > 0:
            _build.launch("pq_gto_eval", dtype, Xc.data_ptr(), ao.data_ptr(), grad.data_ptr(),
                          lap.data_ptr(), tab.data_ptr(), tab.numel(), meta.data_ptr(),
                          meta.numel(), M)
            EVAL_GTO2_LAUNCHES.add()
        return (ao.T.reshape(*shape, nao), grad.reshape(3, nao, M).permute(2, 0, 1).reshape(
            *shape, 3, nao), lap.T.reshape(*shape, nao))

"""Jastrow radial basis functions (counterpart of pyqmc_tpu/models/func3d.py).

Pure functions of distance r returning (value, f'(r)/r, f'' + 2 f'/r), so
callers assemble cartesian gradients as (f'/r) * d_vec. All are C^1-cutoff
at rcut and finite at r = 0 and r >= rcut. The CUDA kernels evaluate the
same formulas (csrc/sj_device.cuh).
"""

import functools
from typing import NamedTuple

import torch


class BasisFn(NamedTuple):
    """Static descriptor: kind 'polypade' | 'cutoffcusp', parameter, rcut."""

    kind: str
    param: float  # beta for polypade, gamma for cutoffcusp
    rcut: float


def polypade_all(r, beta, rcut):
    """PolyPade: f = (1-z)/(1+beta z), z = x^2 (6 - 8x + 3x^2), x = r/rcut."""
    return _polypade(r, beta, 1.0 + beta, 2.0 * beta * (1.0 + beta), rcut)


def _polypade(r, beta, onepb, c2, rcut):
    """polypade_all with 1 + beta and 2 beta (1 + beta) given: floats, or
    tensors of one entry per function that broadcast against r. A number
    over a tensor is computed by torch as the tensor's reciprocal times the
    number, and that is written out here, so tensors holding the floats'
    values give the same bits as the floats."""
    x = torch.clamp(r / rcut, 0.0, 1.0)
    z = x * x * (6.0 - 8.0 * x + 3.0 * x * x)
    dzdx = 12.0 * x * (1.0 - x) ** 2
    d2zdx2 = 12.0 * (1.0 - x) * (1.0 - 3.0 * x)
    den = 1.0 + beta * z
    f = (1.0 - z) / den
    dfdz = torch.reciprocal(den * den) * -onepb
    d2fdz2 = torch.reciprocal(den * den * den) * c2
    fp = dfdz * dzdx / rcut
    fpp = (d2fdz2 * dzdx * dzdx + dfdz * d2zdx2) / (rcut * rcut)
    inside = r < rcut
    small = r > 1e-12
    rsafe = torch.where(small, r, torch.full_like(r, 1e-12))
    # f'/r is finite at r -> 0: dzdx ~ 12 x, so f'/r -> 12 dfdz / rcut^2
    fp_over_r = torch.where(small, fp / rsafe, 12.0 * dfdz / rcut**2)
    zero = torch.zeros_like(r)
    return (torch.where(inside, f, zero),
            torch.where(inside, fp_over_r, zero),
            torch.where(inside, fpp + 2.0 * fp_over_r, zero))


def cutoffcusp_all(r, gamma, rcut):
    """CutoffCusp: f = rcut (p/(1 + gamma p) - c0), p = y - y^2 + y^3/3,
    y = r/rcut; f'(0) = 1, f(rcut) = 0."""
    y = torch.clamp(r / rcut, 0.0, 1.0)
    p = y - y * y + y**3 / 3.0
    pp = (1.0 - y) ** 2
    ppp = -2.0 * (1.0 - y)
    den = 1.0 + gamma * p
    c0 = (1.0 / 3.0) / (1.0 + gamma / 3.0)
    f = rcut * (p / den - c0)
    dfdr = pp / (den * den)
    d2fdr2 = (ppp * den - 2.0 * gamma * pp * pp) / (den**3) / rcut
    inside = r < rcut
    rsafe = torch.where(r > 1e-12, r, torch.full_like(r, 1e-12))
    zero = torch.zeros_like(r)
    return (torch.where(inside, f, zero),
            torch.where(inside, dfdr / rsafe, zero),  # ~1/r at 0 (the cusp)
            torch.where(inside, d2fdr2 + 2.0 * dfdr / rsafe, zero))


def basis_all(b: BasisFn, r):
    if b.kind == "polypade":
        return polypade_all(r, b.param, b.rcut)
    if b.kind == "cutoffcusp":
        return cutoffcusp_all(r, b.param, b.rcut)
    raise ValueError(f"unknown basis kind {b.kind}")


@functools.lru_cache(maxsize=None)
def _polypade_constants(betas, device, dtype):
    """(beta, 1 + beta, 2 beta (1 + beta)) of each beta, formed in Python
    floats as polypade_all forms them, as tensors (nk,)."""
    return tuple(torch.tensor(v, dtype=dtype, device=device)
                 for v in ([b for b in betas], [1.0 + b for b in betas],
                           [2.0 * b * (1.0 + b) for b in betas]))


def eval_basis_all(basis, r):
    """(value, f'/r, lap) of a tuple of BasisFn at r (...,): each (..., nk).
    The polypade functions of one cutoff are evaluated in one broadcast over
    their betas, with the same bits as function by function (a basis of
    them alone returns that broadcast); any other function apart, and the
    columns stacked in the basis order."""
    ladders = {}
    for i, b in enumerate(basis):
        if b.kind == "polypade":
            ladders.setdefault(b.rcut, []).append(i)
    if len(ladders) == 1 and len(next(iter(ladders.values()))) == len(basis):
        consts = _polypade_constants(tuple(b.param for b in basis), r.device, r.dtype)
        return _polypade(r[..., None], *consts, basis[0].rcut)
    cols = [None] * len(basis)
    for rcut, idx in ladders.items():
        consts = _polypade_constants(tuple(basis[i].param for i in idx), r.device, r.dtype)
        out = _polypade(r[..., None], *consts, rcut)
        for j, i in enumerate(idx):
            cols[i] = tuple(o[..., j] for o in out)
    for i, b in enumerate(basis):
        if cols[i] is None:
            cols[i] = basis_all(b, r)
    return tuple(torch.stack([c[k] for c in cols], dim=-1) for k in range(3))


def eval_bases_all(*pairs):
    """[eval_basis_all(basis, r) for (basis, r) in pairs] with the polypade
    functions of one cutoff evaluated in one broadcast over every pair's
    points (the r concatenated along their last axis, so their leading axes
    agree) and the union of their betas: the same bits as eval_basis_all,
    in fewer launches."""
    rcuts = {b.rcut for basis, _ in pairs for b in basis if b.kind == "polypade"}
    if len(rcuts) != 1:
        return [eval_basis_all(basis, r) for basis, r in pairs]
    rcut = rcuts.pop()
    betas = sorted({b.param for basis, _ in pairs for b in basis if b.kind == "polypade"})
    r0 = pairs[0][1]
    consts = _polypade_constants(tuple(betas), r0.device, r0.dtype)
    ladder = _polypade(torch.cat([r for _, r in pairs], dim=-1)[..., None], *consts, rcut)
    out, off = [], 0
    for basis, r in pairs:
        n = r.shape[-1]
        if [b.param for b in basis] == betas and all(b.kind == "polypade" for b in basis):
            out.append(tuple(o[..., off:off + n, :] for o in ladder))  # the ladder itself
        else:
            cols = [tuple(o[..., off:off + n, betas.index(b.param)] for o in ladder)
                    if b.kind == "polypade" else basis_all(b, r) for b in basis]
            out.append(tuple(torch.stack([c[k] for c in cols], dim=-1) for k in range(3)))
        off += n
    return out


def eval_basis_value(basis, r):
    return eval_basis_all(basis, r)[0]


def default_ee_basis(nterms=3, rcut=7.5, gamma=24.0):
    """Cusp function first, then a polypade ladder."""
    basis = [BasisFn("cutoffcusp", gamma, rcut)]
    basis += [BasisFn("polypade", 0.2 * 3.0**k, rcut) for k in range(nterms)]
    return tuple(basis)


def default_ei_basis(nterms=4, rcut=7.5):
    return tuple(BasisFn("polypade", 0.2 * 3.0**k, rcut) for k in range(nterms))

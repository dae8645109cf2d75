"""Variance optimization (counterpart of pyqmc_tpu/method/optvariance.py): a
derivative-free scipy minimization (Powell by default) of Var(E_L) over
fixed walkers and one fixed set of ECP quadrature rotations."""

from __future__ import annotations

import numpy as np
import scipy.optimize
import torch

from .linemin import draw_ecp_streams
from .vmc import downselects


def variance_cost(energy_acc, wf, params, positions, transform, rot=None, u_sel=None):
    """cost(x) = Var(E_L) of the walkers `positions` under the parameters
    transform.deserialize(params, x) (1e6 where an energy is not finite),
    with the rotations `rot` and selection uniforms `u_sel` of every
    evaluation."""

    def cost(x):
        p = transform.deserialize(params, np.asarray(x, dtype=np.float64))
        state = wf.recompute(p, positions)
        e = energy_acc(wf, p, state, positions, rot, u_sel)["total"]
        e = e.to(torch.float64).cpu().numpy()
        if not np.all(np.isfinite(e)):
            return 1e6
        return float(np.var(e))

    return cost


def optvariance(energy_acc, wf, params, configs, transform, generator=None, **kwargs):
    """Returns (the optimized variance, params). The ECP's rotations (and
    selection uniforms) are drawn once, from `generator` (seed 0 unless
    given)."""
    positions = configs.positions
    rot = u_sel = None
    if getattr(energy_acc, "ecp_acc", None) is not None:
        if generator is None:
            generator = torch.Generator(device=positions.device).manual_seed(0)
        nconf, nelec = positions.shape[:2]
        rot, u_sel = draw_ecp_streams(generator, nelec, nconf, positions.device,
                                      positions.dtype, downselects({"energy": energy_acc}))
    cost = variance_cost(energy_acc, wf, params, positions, transform, rot, u_sel)
    x0 = transform.serialize(params).to(torch.float64).cpu().numpy()
    res = scipy.optimize.minimize(cost, x0, method=kwargs.pop("method", "Powell"), **kwargs)
    return res.fun, transform.deserialize(params, res.x)

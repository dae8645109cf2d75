"""Stochastic reconfiguration accumulator and update rule (counterpart of
pyqmc_tpu/observables/sr.py).

Each step's walker averages of (E, dp, E dp, dp_i dp_j) are accumulated in
the VMC block on the device; the (nparam, nparam) solve runs on the host in
float64 numpy.

Nodal regularization (Pathak & Wagner 2020): the parameter gradients are
damped by f(r) = 9(r/c)^2 - 15(r/c)^4 + 7(r/c)^6, r = |grad lnPsi|^-1,
within r < nodal_cutoff of a node. dp and dpH take the regularized
gradients; dpidpj pairs one raw factor with one regularized.

Complex parameters or gradients (complex orbital coefficients, a general
twist) take the complex channel of the JAX package: the gradients arrive as
a real pair (R, I) from LinearTransform.serialize_gradients_pair, and with
O_k = R_k + i I_k and the local energy E_R + i E_I,
    g_k  = 2 [<E_R R_k> - <E_R><R_k> + <E_I I_k> - <E_I><I_k>]
    S_kl = <R_k R_l + I_k I_l> - <R_k><R_l> - <I_k><I_l>,
the conjugated metric Re<O_k* O_l> - Re(<O_k>* <O_l>). The walker means
run on the device in the walkers' dtype (avg's total_im, dpI, dpHI,
dpidpjI beside the real ones), the solve on the host in float64.

Under a walker mesh the VMC block reduces these means over the mesh
(method/vmc.py) before `delta_p`; line_minimization has rank 0 solve and
broadcast the steps, so every rank takes the same parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from .transform import LinearTransform


def nodal_regularization(grad2, nodal_cutoff=1e-3):
    """Damping factor per walker: 1 away from nodes, -> 0 at a node.
    grad2 = sum_e |grad_e lnPsi|^2, so r = 1/grad2 ~ (distance to node)^2."""
    r = 1.0 / torch.clamp(grad2, min=1e-30)
    c2 = nodal_cutoff**2
    x = r / c2
    f = 9.0 * x - 15.0 * x**2 + 7.0 * x**3
    return torch.where(r < c2, f, torch.ones_like(f))


class StochasticReconfiguration:
    """sr(wf, params, state, positions, rot, u_sel=None) -> per-walker
    {total, grad2, dpR}; sr.avg(...) -> walker means {total, dp, dpH,
    dpidpj}."""

    def __init__(self, energy_acc, transform: LinearTransform, eps: float = 1e-3,
                 nodal_cutoff: float = 1e-3):
        self.energy_acc = energy_acc
        self.transform = transform
        self.eps = eps
        self.nodal_cutoff = nodal_cutoff

    @property
    def ecp_acc(self):
        """The energy's ECP, so the VMC block draws what it reads."""
        return getattr(self.energy_acc, "ecp_acc", None)

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None):
        d = self.energy_acc(wf, params, state, positions, rot, u_sel, with_imag=True)
        R, I = self.transform.serialize_gradients_pair(wf.pgradient(params, positions))
        return {"total": d["total"], "total_im": d["total_im"], "grad2": d["grad2"], "dpR": R,
                "dpI": I}

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        """Walker means {total, dp, dpH, dpidpj}, and where the gradients
        have an imaginary part {total_im, dpI, dpHI, dpidpjI}."""
        dat = self(wf, params, state, positions, rot, u_sel)
        eR, R, I = dat["total"], dat["dpR"], dat["dpI"]
        nconf = R.shape[0]
        f = nodal_regularization(dat["grad2"], self.nodal_cutoff)
        Rreg = R * f[:, None]
        out = {
            "total": torch.mean(eR),
            "dp": torch.mean(Rreg, dim=0),
            "dpH": (eR @ Rreg) / nconf,
            "dpidpj": (R.T @ Rreg) / nconf,
        }
        if I is not None:
            eI = dat["total_im"]
            Ireg = I * f[:, None]
            out.update({"total_im": torch.mean(eI), "dpI": torch.mean(Ireg, dim=0),
                        "dpHI": (eI @ Ireg) / nconf, "dpidpjI": (I.T @ Ireg) / nconf})
        return out

    def keys(self):
        return {"total", "dp", "dpH", "dpidpj", "dpI", "dpHI", "dpidpjI"}

    def delta_p(self, taus, block_avg):
        """Parameter steps -tau S_reg^-1 g for each tau, and |g|, from the
        blocks' averages (each a stack over blocks), in float64 numpy."""
        en = np.mean(np.asarray(block_avg["total"], dtype=np.float64))
        dp = np.mean(np.asarray(block_avg["dp"], dtype=np.float64), axis=0)
        dpH = np.mean(np.asarray(block_avg["dpH"], dtype=np.float64), axis=0)
        dpidpj = np.mean(np.asarray(block_avg["dpidpj"], dtype=np.float64), axis=0)
        g = 2.0 * (dpH - en * dp)
        S = dpidpj - np.outer(dp, dp)
        if "dpI" in block_avg:
            mean = lambda k: np.mean(np.asarray(block_avg[k], dtype=np.float64), axis=0)
            enI, dpI = mean("total_im"), mean("dpI")
            g = g + 2.0 * (mean("dpHI") - enI * dpI)
            S = S + mean("dpidpjI") - np.outer(dpI, dpI)
        step = np.linalg.solve(S + self.eps * np.eye(len(dp)), g)
        return [-tau * step for tau in taus], float(np.linalg.norm(g))

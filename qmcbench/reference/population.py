"""The population's reductions in float64: the DMC comb (systematic
resampling) and a block's averages over every walker and step. Plain
PyTorch; each takes the per-walker values it is given and nothing else,
and works in `dtype` (float64; the control's float32)."""

from __future__ import annotations

import torch


def comb(weights, u, dtype=torch.float64):
    """The walkers that a comb of len(weights) teeth, spaced sum(w) / n
    apart with the first at u times the spacing, keeps (each tooth takes
    the first walker whose running sum reaches it), and the weight every
    kept walker gets, the mean."""
    w = weights.to(dtype)
    n = w.shape[0]
    cum = torch.cumsum(w, dim=0)
    spacing = cum[-1] / n
    teeth = (float(u) + torch.arange(n, device=w.device, dtype=dtype)) * spacing
    return torch.clamp(torch.searchsorted(cum, teeth), 0, n - 1), torch.mean(w)


def vmc_averages(energies, dtype=torch.float64):
    """{"energy<key>": the mean over steps and walkers} of per-step
    {key: (nconf,)} local energies."""
    return {f"energy{k}": float(torch.mean(torch.stack([e[k].to(dtype) for e in energies])))
            for k in energies[0]}


def dmc_averages(energies, weights, dtype=torch.float64):
    """{"energy<key>": the mean over steps of the weighted mean over
    walkers, "weight": the mean over steps and walkers} of per-step
    {key: (nconf,)} local energies and (nconf,) weights."""
    w = torch.stack([x.to(dtype) for x in weights])
    out = {f"energy{k}": float(torch.mean(torch.sum(w * torch.stack([e[k].to(dtype)
                                                                     for e in energies]), dim=1)
                                          / torch.sum(w, dim=1)))
           for k in energies[0]}
    out["weight"] = float(torch.mean(w))
    return out

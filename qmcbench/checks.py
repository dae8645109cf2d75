"""The numbers that decide `correct`: each a comparison of what the timed
path produced with what the reference works out from the same inputs.

- walkers_apart: the share of the sampled walkers whose positions at the
  block's end lie more than POSITION_TOL bohr (in any coordinate) from the
  reference's chain: a proposal, drift, ratio or accept decision that went
  another way.
- energy_gap: the largest |E_L - E_L(reference)| / max(1 Ha,
  |E_L(reference)|) over the block's steps and the sampled walkers: in VMC
  the reference's energies at the program's own positions; in DMC, whose
  energies steer the weights, along the reference's chain, over the
  walkers whose positions at that step agree; energy_gap_p99 the 99th
  percentile of the same gaps.
- weight_gap (DMC): over the sampled walkers whose chains agree at every
  step, the largest relative gap of the weights at the block's end.
- comb_apart (DMC): the share of the comb's teeth, over the whole
  population, whose walker after the program's comb lies apart from the
  one a float64 comb of the same weights and u_branch keeps.
- comb_weight_gap (DMC): the largest relative gap between a weight after
  the program's comb and the float64 mean of the weights before it.
- average_gap: the largest gap |a - a_ref| / max(1, |a_ref|) between a
  block average the program reports and the float64 reduction of the
  program's own per-walker values of that block over the whole population
  (inf where they do not cover it).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

POSITION_TOL = 1e-4  # bohr


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def precision(tf32):
    """TF32 matmuls on inside (the control's precision), restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    if tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def apart(R, R_ref, disp=None):
    """(B,) bool: walkers more than POSITION_TOL apart in any coordinate,
    the difference taken by `disp` (the minimal image in a cell); a
    coordinate that is not finite on either side, or after `disp`, is
    apart."""
    d = R_ref.double() - R.to(R_ref.device).double()
    if disp is not None:
        d = disp(d)
    d = torch.nan_to_num(torch.abs(d), nan=np.inf)
    return torch.amax(d.reshape(R.shape[0], -1), dim=1) > POSITION_TOL


def walkers_apart(R, R_ref, disp=None):
    return float(torch.mean(apart(R, R_ref, disp).double()))


def energy_gaps(positions, energies, ref_positions, ref_energies, disp=None, key="total"):
    """The relative gaps |E_L - E_ref| / max(1, |E_ref|) (a flat tensor,
    inf where not finite) over steps and agreeing walkers; lists of
    per-step (B, nelec, 3) positions and {key: (B,)} energies (None at a
    step the reference did not evaluate)."""
    gaps = []
    for R, E, R_ref, E_ref in zip(positions, energies, ref_positions, ref_energies):
        if E is None or E_ref is None:
            continue
        ok = ~apart(R, R_ref, disp) & torch.isfinite(E_ref[key])
        e, e_ref = E[key].double()[ok], E_ref[key].double()[ok]
        gap = torch.abs(e - e_ref) / torch.clamp(torch.abs(e_ref), min=1.0)
        gaps.append(torch.where(torch.isfinite(gap), gap, torch.full_like(gap, float("inf"))))
    return torch.cat(gaps) if gaps else torch.zeros(1, dtype=torch.float64)


def worst_walker(positions, energies, ref_positions, ref_energies, disp=None):
    """A line on the walker of the widest energy gap: its step, gap, local
    energies and the reference's kinetic energy and |grad log psi|^2 (a
    walker near a node has both large)."""
    best = None
    for k, (R, E, R_ref, E_ref) in enumerate(zip(positions, energies, ref_positions,
                                                 ref_energies)):
        if E is None or E_ref is None:
            continue
        ok = ~apart(R, R_ref, disp)
        e, e_ref = E["total"].double(), E_ref["total"].double().to(E["total"].device)
        gap = torch.where(ok.to(e.device), torch.abs(e - e_ref) / torch.clamp(torch.abs(e_ref),
                                                                                min=1.0), -1.0)
        i = int(torch.argmax(gap))
        if best is None or float(gap[i]) > best[0]:
            best = (float(gap[i]), k, i, float(e[i]), float(e_ref[i]),
                    float(E_ref["ke"][i]), float(E_ref["grad2"][i]))
    if best is None:
        return "no walker compared"
    return ("widest energy gap {:.3e} at step {} walker {}: E {:.6f}, reference {:.6f}, its "
            "kinetic {:.3f}, |grad log psi|^2 {:.3f}".format(*best))


def energy_gap(*args, **kwargs):
    """The largest of energy_gaps."""
    return float(torch.max(energy_gaps(*args, **kwargs)))


def energy_gap_p99(*args, **kwargs):
    """The 99th percentile of energy_gaps: the widest gap but for the
    walkers nearest a node, whose float32 laplacian cancels most."""
    return float(torch.quantile(energy_gaps(*args, **kwargs), 0.99))


def weight_gap(w, w_ref, agree):
    if not bool(torch.any(agree)):
        return 0.0
    w, w_ref = w.double()[agree], w_ref.double()[agree]
    gap = torch.abs(w - w_ref) / torch.abs(w_ref)
    return float(torch.max(torch.where(torch.isfinite(gap), gap, torch.full_like(gap, np.inf))))


def comb_apart(R, R_out, keep, disp=None):
    """The share of teeth whose walker R_out[i] lies apart from R[keep[i]]."""
    return walkers_apart(R_out, R[keep.to(R.device)], disp)


def comb_weight_gap(w_out, mean_ref):
    gap = torch.abs(w_out.double() - mean_ref) / torch.abs(mean_ref)
    return float(torch.max(torch.where(torch.isfinite(gap), gap, torch.full_like(gap, np.inf))))


def average_gap(averages, ref):
    """The largest gap over the keys of `ref` (inf where one is missing or
    not finite, or where `ref` is None: the program's per-walker values do
    not cover the population)."""
    if ref is None:
        return np.inf
    gaps = [abs(float(averages.get(k, np.nan)) - v) / max(1.0, abs(v)) for k, v in ref.items()]
    return max((g if np.isfinite(g) else np.inf) for g in gaps)


def verdict(numbers, limits):
    """(correct, [(name, value, limit)]) over the numbers the cell's limits
    name: every one at most its limit."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows

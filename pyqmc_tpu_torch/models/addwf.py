"""Linear superposition Psi = sum_i c_i psi_i (counterpart of
pyqmc_tpu/models/addwf.py).

The components are combined in log space with a per-walker reference
shift: w_i = c_i phase_i exp(log|psi_i| - ref), ref the largest log|psi_i|
of the walker, so that no amplitude overflows. Ratios and gradients weight
each component by its amplitude.

params: {"coeff": (nwf,), "wf0": ..., "wf1": ...}; states are tuples.
"""

import torch

from ..utils.dtypes import real_dtype, resolve_device


class AddWF:
    def __init__(self, *wfs):
        self.wfs = tuple(wfs)
        self.nelec = wfs[0].nelec
        for w in wfs:
            if getattr(w, "ratio_is_modulus", False):
                raise ValueError(
                    "AddWF needs component phases/signed ratios; the real-backend twist paths "
                    "(ratio_is_modulus) report |ratio| only — superpose the complex Slater instead")

    def make_params(self, device=None, dtype=None):
        """Each component's parameters and coeff = 1/sqrt(nwf), on the GPU
        unless `device` says otherwise."""
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
        p = {f"wf{i}": w.make_params(device, dtype) for i, w in enumerate(self.wfs)}
        n = len(self.wfs)
        p["coeff"] = torch.full((n,), 1.0, dtype=dtype, device=device) / float(n) ** 0.5
        return p

    def _split(self, params):
        return [params[f"wf{i}"] for i in range(len(self.wfs))]

    def _parts(self, params, state):
        return zip(self.wfs, self._split(params), state)

    def recompute(self, params, positions):
        return tuple(w.recompute(p, positions) for w, p in zip(self.wfs, self._split(params)))

    def _amplitudes(self, params, state, unit=False):
        """w (nwf, nconf), their sum (nconf,) and the reference shift; with
        unit also phase_i exp(log|psi_i| - ref), the amplitudes before the
        coefficients."""
        values = [w.value(p, s) for w, p, s in self._parts(params, state)]
        phases = torch.stack([ph for ph, _ in values])
        las = torch.stack([la for _, la in values])
        ref = torch.amax(las, dim=0, keepdim=True)
        amp = phases * torch.exp(las - ref)
        w = params["coeff"][:, None] * amp
        return (w, torch.sum(w, dim=0), ref[0]) + ((amp,) if unit else ())

    def value(self, params, state):
        _, denom, ref = self._amplitudes(params, state)
        absd = torch.abs(denom)
        safe = torch.where(absd == 0, torch.full_like(absd, 1e-30), absd)
        return denom / safe, torch.log(safe) + ref

    def testvalue(self, params, state, e, epos):
        w, denom, _ = self._amplitudes(params, state)
        num, saved = None, []
        for i, (wf, p, s) in enumerate(self._parts(params, state)):
            r, sv = wf.testvalue(p, s, e, epos)
            contrib = w[i][:, None] * r if r.ndim == 2 else w[i] * r
            num = contrib if num is None else num + contrib
            saved.append(sv)
        return num / (denom[:, None] if num.ndim == 2 else denom), tuple(saved)

    def testvalue_many(self, params, state, epos):
        w, denom, _ = self._amplitudes(params, state)
        num = None
        for i, (wf, p, s) in enumerate(self._parts(params, state)):
            contrib = w[i][:, None] * wf.testvalue_many(p, s, epos)
            num = contrib if num is None else num + contrib
        return num / denom[:, None]

    def gradient_value(self, params, state, e, epos):
        w, denom, _ = self._amplitudes(params, state)
        num_r = num_g = None
        saved = []
        for i, (wf, p, s) in enumerate(self._parts(params, state)):
            g, r, sv = wf.gradient_value(p, s, e, epos)
            wr = w[i] * r  # the component's amplitude at epos
            num_r = wr if num_r is None else num_r + wr
            num_g = wr[:, None] * g if num_g is None else num_g + wr[:, None] * g
            saved.append(sv)
        return num_g / num_r[:, None], num_r / denom, tuple(saved)

    def gradient(self, params, state, e, epos):
        return self.gradient_value(params, state, e, epos)[0]

    def gradient_current(self, params, state, e, epos):
        """grad log Psi at electron e's current position: each component's
        ratio there is 1, so the amplitudes alone weight the components'
        gradients."""
        w, denom, _ = self._amplitudes(params, state)
        num_g = None
        for i, (wf, p, s) in enumerate(self._parts(params, state)):
            g = (wf.gradient_current(p, s, e, epos) if hasattr(wf, "gradient_current")
                 else wf.gradient(p, s, e, epos))
            num_g = w[i][:, None] * g if num_g is None else num_g + w[i][:, None] * g
        return num_g / denom[:, None]

    def gradient_laplacian(self, params, state, e, epos):
        w, denom, _ = self._amplitudes(params, state)
        num_r = num_g = num_l = None
        for i, (wf, p, s) in enumerate(self._parts(params, state)):
            g, lap = wf.gradient_laplacian(p, s, e, epos)
            wr = w[i] * wf.testvalue(p, s, e, epos)[0]
            num_r = wr if num_r is None else num_r + wr
            num_g = wr[:, None] * g if num_g is None else num_g + wr[:, None] * g
            num_l = wr * lap if num_l is None else num_l + wr * lap
        return num_g / num_r[:, None], num_l / num_r

    def updateinternals(self, params, state, e, epos, mask, saved):
        return tuple(w.updateinternals(p, s, e, epos, mask, sv)
                     for (w, p, s), sv in zip(self._parts(params, state), saved))

    def pgradient(self, params, positions):
        """d log|Psi| / d params per walker: component i's parameters take
        its pgradient weighted by w_i / sum_j w_j, coeff[i] takes
        phase_i exp(log|psi_i| - ref) / sum_j w_j (nconf, nwf)."""
        state = self.recompute(params, positions)
        w, denom, _, amp = self._amplitudes(params, state, unit=True)
        out = {f"wf{i}": _scale_tree(wf.pgradient(p, positions), w[i] / denom)
               for i, (wf, p) in enumerate(zip(self.wfs, self._split(params)))}
        out["coeff"] = (amp / denom).transpose(0, 1)
        return out


def _scale_tree(tree, scale):
    """Every leaf (nconf, ...) of a gradient tree times scale (nconf,)."""
    if isinstance(tree, dict):
        return {k: _scale_tree(v, scale) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_scale_tree(v, scale) for v in tree)
    return tree * scale.reshape((-1,) + (1,) * (tree.dim() - 1))

"""Product wavefunction Psi = prod_i psi_i (counterpart of
pyqmc_tpu/models/multiply.py, without parameter gradients).

Parameters are namespaced {"wf0": ..., "wf1": ...}; states are tuples. The
laplacian cross term uses sum_{i != j} g_i.g_j = |sum_i g_i|^2 - sum_i |g_i|^2.
"""

import torch


def default_move_begin(w, params, state, e, epos):
    """Metropolis move, first half: (grad at the current position, aux for
    the second half). Factors without move_begin fall back to
    gradient_current or gradient."""
    if hasattr(w, "move_begin"):
        return w.move_begin(params, state, e, epos)
    if hasattr(w, "gradient_current"):
        return w.gradient_current(params, state, e, epos), None
    return w.gradient(params, state, e, epos), None


def default_move_finish(w, params, state, e, epos, aux):
    """Metropolis move, second half: (grad_new, ratio, saved) at epos."""
    if hasattr(w, "move_finish"):
        return w.move_finish(params, state, e, epos, aux)
    return w.gradient_value(params, state, e, epos)


def default_testvalue_aux_all(w, params, state, aux):
    """Ratios (nelec, nconf, naux) for moving each electron e to its own
    points aux[e] (nelec, nconf, naux, 3): the dense ECP quadrature.
    Factors whose per-point cost is an electron-independent evaluation
    implement testvalue_aux_all; the rest are called per electron."""
    if hasattr(w, "testvalue_aux_all"):
        return w.testvalue_aux_all(params, state, aux)
    return torch.stack([w.testvalue(params, state, e, aux[e])[0] for e in range(aux.shape[0])])


class MultiplyWF:
    def __init__(self, *wfs):
        self.wfs = tuple(wfs)
        self.nelec = wfs[0].nelec

    def make_params(self, device="cpu", dtype=torch.float64):
        return {f"wf{i}": w.make_params(device, dtype) for i, w in enumerate(self.wfs)}

    def _split(self, params):
        return [params[f"wf{i}"] for i in range(len(self.wfs))]

    def recompute(self, params, positions):
        return tuple(w.recompute(p, positions) for w, p in zip(self.wfs, self._split(params)))

    def value(self, params, state):
        phase = logabs = None
        for w, p, s in zip(self.wfs, self._split(params), state):
            ph, la = w.value(p, s)
            phase = ph if phase is None else phase * ph
            logabs = la if logabs is None else logabs + la
        return phase, logabs

    def testvalue(self, params, state, e, epos):
        ratio, saved = None, []
        for w, p, s in zip(self.wfs, self._split(params), state):
            r, sv = w.testvalue(p, s, e, epos)
            ratio = r if ratio is None else ratio * r
            saved.append(sv)
        return ratio, tuple(saved)

    def testvalue_aux_all(self, params, state, aux):
        ratio = None
        for w, p, s in zip(self.wfs, self._split(params), state):
            ri = default_testvalue_aux_all(w, p, s, aux)
            ratio = ri if ratio is None else ratio * ri
        return ratio

    def move_begin(self, params, state, e, epos):
        g, aux = None, []
        for w, p, s in zip(self.wfs, self._split(params), state):
            gi, ai = default_move_begin(w, p, s, e, epos)
            g = gi if g is None else g + gi
            aux.append(ai)
        return g, tuple(aux)

    def move_finish(self, params, state, e, epos, aux):
        g = ratio = None
        saved = []
        for w, p, s, a in zip(self.wfs, self._split(params), state, aux):
            gi, ri, svi = default_move_finish(w, p, s, e, epos, a)
            g = gi if g is None else g + gi
            ratio = ri if ratio is None else ratio * ri
            saved.append(svi)
        return g, ratio, tuple(saved)

    def gradient_value(self, params, state, e, epos):
        g = ratio = None
        saved = []
        for w, p, s in zip(self.wfs, self._split(params), state):
            gi, ri, svi = w.gradient_value(p, s, e, epos)
            g = gi if g is None else g + gi
            ratio = ri if ratio is None else ratio * ri
            saved.append(svi)
        return g, ratio, tuple(saved)

    def gradient_laplacian(self, params, state, e, epos):
        gs, laps = [], []
        for w, p, s in zip(self.wfs, self._split(params), state):
            gi, li = w.gradient_laplacian(p, s, e, epos)
            gs.append(gi)
            laps.append(li)
        gtot = sum(gs)
        cross = torch.sum(gtot * gtot, dim=-1) - sum(torch.sum(g * g, dim=-1) for g in gs)
        return gtot, sum(laps) + cross

    def updateinternals(self, params, state, e, epos, mask, saved):
        return tuple(w.updateinternals(p, s, e, epos, mask, sv)
                     for w, p, s, sv in zip(self.wfs, self._split(params), state, saved))

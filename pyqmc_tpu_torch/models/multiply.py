"""Product wavefunction Psi = prod_i psi_i (counterpart of
pyqmc_tpu/models/multiply.py, without the (re, im) pair methods of the
complex pair wavefunctions).

Parameters are namespaced {"wf0": ..., "wf1": ...}; states are tuples. The
laplacian cross term uses sum_{i != j} g_i.g_j = |sum_i g_i|^2 - sum_i |g_i|^2.
"""

import torch

from ..utils.dtypes import real_dtype, resolve_device


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


def default_gradient_value_pair(w, params, state, e, epos_old, epos_new):
    """(grad at epos_old, grad at epos_new, ratio, saved) of electron e:
    one call where the factor has gradient_value_pair, else gradient and
    gradient_value."""
    if hasattr(w, "gradient_value_pair"):
        return w.gradient_value_pair(params, state, e, epos_old, epos_new)
    return (w.gradient(params, state, e, epos_old),
            *w.gradient_value(params, state, e, epos_new))


def default_testvalue_aux_all(w, params, state, aux, es=None):
    """Ratios (ne, nconf, naux) for moving electron es[i] to its own points
    aux[i] (ne, nconf, naux, 3), es a static sequence of electron indices
    (None: all electrons in order): the ECP quadrature. Factors whose
    per-point cost is an electron-independent evaluation implement
    testvalue_aux_all; the rest are called per electron."""
    if hasattr(w, "testvalue_aux_all"):
        return w.testvalue_aux_all(params, state, aux, es=es)
    es = range(aux.shape[0]) if es is None else es
    return torch.stack([w.testvalue(params, state, int(e), aux[i])[0] for i, e in enumerate(es)])


def default_gradient_laplacian_many(w, params, state, es, epos):
    """(grad (nconf, k, 3), lap (nconf, k)) of electrons es at epos
    (nconf, k, 3): one batched call where the factor has one, else a loop."""
    if hasattr(w, "gradient_laplacian_many"):
        return w.gradient_laplacian_many(params, state, es, epos)
    outs = [w.gradient_laplacian(params, state, int(e), epos[:, i]) for i, e in enumerate(es)]
    return torch.stack([g for g, _ in outs], dim=1), torch.stack([l for _, l in outs], dim=1)


class MultiplyWF:
    def __init__(self, *wfs):
        self.wfs = tuple(wfs)
        self.nelec = wfs[0].nelec

    def make_params(self, device=None, dtype=None):
        """Parameters of every factor, on the GPU unless `device` says otherwise
        (utils/dtypes.resolve_device); dtype defaults to real_dtype(device)."""
        device = resolve_device(device)
        dtype = dtype or real_dtype(device)
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

    def testvalue_many(self, params, state, epos):
        ratio = None
        for w, p, s in zip(self.wfs, self._split(params), state):
            r = w.testvalue_many(p, s, epos)
            ratio = r if ratio is None else ratio * r
        return ratio

    def gradient(self, params, state, e, epos):
        g = None
        for w, p, s in zip(self.wfs, self._split(params), state):
            gi = w.gradient(p, s, e, epos)
            g = gi if g is None else g + gi
        return g

    def gradient_current(self, params, state, e, epos):
        """grad log Psi at electron e's current position `epos`; factors
        with an orbital cache (Slater.gradient_current) skip their AO
        evaluation, the rest evaluate at epos."""
        g = None
        for w, p, s in zip(self.wfs, self._split(params), state):
            gi = (w.gradient_current(p, s, e, epos) if hasattr(w, "gradient_current")
                  else w.gradient(p, s, e, epos))
            g = gi if g is None else g + gi
        return g

    def gradient_value_pair(self, params, state, e, epos_old, epos_new):
        go = gn = ratio = None
        saved = []
        for w, p, s in zip(self.wfs, self._split(params), state):
            goi, gni, ri, svi = default_gradient_value_pair(w, p, s, e, epos_old, epos_new)
            go = goi if go is None else go + goi
            gn = gni if gn is None else gn + gni
            ratio = ri if ratio is None else ratio * ri
            saved.append(svi)
        return go, gn, ratio, tuple(saved)

    def testvalue_aux_all(self, params, state, aux, es=None):
        ratio = None
        for w, p, s in zip(self.wfs, self._split(params), state):
            ri = default_testvalue_aux_all(w, p, s, aux, es=es)
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

    def gradient_laplacian_many(self, params, state, es, epos):
        gs, laps = [], []
        for w, p, s in zip(self.wfs, self._split(params), state):
            gi, li = default_gradient_laplacian_many(w, p, s, es, epos)
            gs.append(gi)
            laps.append(li)
        gtot = sum(gs)
        cross = torch.sum(gtot * gtot, dim=-1) - sum(torch.sum(g * g, dim=-1) for g in gs)
        return gtot, sum(laps) + cross

    def updateinternals(self, params, state, e, epos, mask, saved):
        return tuple(w.updateinternals(p, s, e, epos, mask, sv)
                     for w, p, s, sv in zip(self.wfs, self._split(params), state, saved))

    def pgradient(self, params, positions):
        return {f"wf{i}": w.pgradient(p, positions)
                for i, (w, p) in enumerate(zip(self.wfs, self._split(params)))}

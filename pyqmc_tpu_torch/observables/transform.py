"""Flatten and unflatten the optimized subset of wavefunction parameters
(counterpart of pyqmc_tpu/observables/transform.py).

A parameter tree is nested dicts and lists of tensors. Its leaves are taken
in the JAX package's flatten order: dict entries by sorted key, list and
tuple entries in order (so {"wf0": {det_coeff, mo_coeff_alpha,
mo_coeff_beta}, "wf1": {acoeff, bcoeff}} flattens wf0 before wf1, acoeff
before bcoeff). Boolean `to_opt` masks pick the optimized entries of each
leaf.

Complex parameters split into independent real and imaginary directions:
the flat vector is [real parts of all selected entries, imaginary parts of
the complex ones], and gradients come as a real (R, I) pair. For a complex
parameter p = a + ib with dlnPsi/dp = O,
    d lnPsi / da = O    -> a slot of the real segment, (R, I) = (Re O, Im O)
    d lnPsi / db = i O  -> a slot of the imaginary segment, (R, I) = (-Im O, Re O)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.constants import index_tensor


def tree_leaves(tree):
    """Leaves of nested dicts (sorted keys), lists and tuples, in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_paths(tree, prefix=()):
    """[(path, leaf)] in tree_leaves order, path the tuple of dict keys and
    list or tuple indices from the root to the leaf (the keys of JAX's
    tree_flatten_with_path)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree) for pl in tree_paths(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_unflatten(template, leaves):
    """A tree of `template`'s structure whose leaves are `leaves`, in
    tree_leaves order."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            out = {k: None for k in t}
            for k in sorted(t):
                out[k] = rec(t[k])
            return out
        if isinstance(t, (list, tuple)):
            return type(t)(rec(x) for x in t)
        return next(it)

    return rec(template)


def _promote(parts):
    """parts cast to the complex dtype of any complex one among them (as a
    concatenation in the JAX package promotes), else as they are."""
    ctype = next((p.dtype for p in parts if torch.is_complex(p)), None)
    return parts if ctype is None else [p.to(ctype) for p in parts]


class LinearTransform:
    def __init__(self, params, to_opt: Dict[str, object] = None):
        """to_opt: a tree prefix of params whose leaves are boolean arrays,
        or True / False broadcast over whole subtrees. Default: all."""
        leaves = tree_leaves(params)
        if to_opt is None:
            masks = [np.ones(tuple(leaf.shape), dtype=bool) for leaf in leaves]
        else:
            masks = self._expand_masks(params, to_opt)
        self.masks = masks
        self.indices = [np.nonzero(m.ravel())[0] for m in masks]
        self.sizes = [len(i) for i in self.indices]
        self.is_complex = [bool(torch.is_complex(leaf)) for leaf in leaves]
        self.nreal = sum(self.sizes)
        self.complex_inds = np.concatenate(
            [np.full(n, c, dtype=bool) for n, c in zip(self.sizes, self.is_complex)]
        ) if self.sizes else np.zeros(0, dtype=bool)
        self.nimag = int(self.complex_inds.sum())
        self.nparams = self.nreal + self.nimag
        self.has_complex_params = self.nimag > 0

    @staticmethod
    def _expand_masks(params, to_opt):
        """One boolean mask per leaf of params from the prefix tree to_opt
        (a bool broadcasts over its whole subtree)."""
        masks = []

        def rec(p, m):
            if isinstance(m, (bool, np.bool_)):
                for leaf in tree_leaves(p):
                    masks.append(np.full(tuple(leaf.shape), bool(m), dtype=bool))
            elif isinstance(m, dict):
                for k in sorted(p):
                    rec(p[k], m[k])
            elif isinstance(m, (list, tuple)):
                for pe, me in zip(p, m):
                    rec(pe, me)
            else:
                masks.append(np.asarray(m, dtype=bool))

        rec(params, to_opt)
        return masks

    def _selected(self, leaves, batch):
        """Selected entries of each leaf with a selection, concatenated
        along the last axis (a leading walker axis kept when `batch`)."""
        parts = []
        for leaf, idx in zip(leaves, self.indices):
            if len(idx):
                flat = leaf.reshape(leaf.shape[0], -1) if batch else leaf.reshape(-1)
                parts.append(flat[..., index_tensor(idx, leaf.device)])
        return parts

    def serialize(self, params):
        """params -> flat real (nparams,) tensor: [re(selected), im(selected
        complex)]."""
        parts = self._selected(tree_leaves(params), False)
        if not parts:
            return torch.zeros(0, dtype=torch.float64)
        flat = torch.cat(_promote(parts))
        if not self.has_complex_params:
            return flat.real if torch.is_complex(flat) else flat
        re = flat.real
        ci = index_tensor(np.nonzero(self.complex_inds)[0], flat.device)
        return torch.cat([re, flat.imag[ci]])

    def serialize_batch(self, tree):
        """Tree of (nconf, ...) gradients -> real (nconf, nparams); raises
        for complex gradients, which need serialize_gradients_pair."""
        R, I = self.serialize_gradients_pair(tree)
        if I is not None:
            raise ValueError("complex parameter gradients need serialize_gradients_pair")
        return R

    def serialize_gradients_pair(self, tree):
        """Tree of (nconf, ...) dlnPsi/dp -> (R, I), real (nconf, nparams):
        the real and imaginary parts of dlnPsi along each real direction. I
        is None when every gradient and every parameter is real."""
        parts = self._selected(tree_leaves(tree), True)
        if not parts:
            return torch.zeros((0, 0), dtype=torch.float64), None
        g = torch.cat(_promote(parts), dim=1)  # (nconf, nreal)
        any_complex = torch.is_complex(g)
        if not any_complex and not self.has_complex_params:
            return g, None
        gr = g.real if any_complex else g
        gi = g.imag if any_complex else torch.zeros_like(g)
        if not self.has_complex_params:
            return gr, gi
        ci = index_tensor(np.nonzero(self.complex_inds)[0], g.device)
        R = torch.cat([gr, -gi[:, ci]], dim=1)
        I = torch.cat([gi, gr[:, ci]], dim=1)
        return R, I

    def deserialize(self, base_params, flat):
        """New tensors of base_params' tree with the selected entries set
        from the flat real vector (real and imaginary segments recombined
        for complex leaves); base_params is left as it was."""
        if not isinstance(flat, torch.Tensor):
            flat = torch.tensor(np.asarray(flat))
        leaves = tree_leaves(base_params)
        out = []
        off, imoff = 0, self.nreal
        for leaf, idx, n, c in zip(leaves, self.indices, self.sizes, self.is_complex):
            if not n:
                out.append(leaf)
                continue
            vals = flat[off:off + n].to(leaf.device)
            if c:
                im = flat[imoff:imoff + n].to(leaf.device)
                vals = torch.complex(vals.to(leaf.real.dtype), im.to(leaf.real.dtype))
                imoff += n
            new = leaf.clone().reshape(-1)
            new.index_put_((index_tensor(idx, leaf.device),), vals.to(leaf.dtype))
            out.append(new.reshape(leaf.shape))
            off += n
        return tree_unflatten(base_params, out)

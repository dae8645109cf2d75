"""Wavefunction contract checks (counterpart of pyqmc_tpu/models/testwf.py).

Any wavefunction implementing the protocol is swept through these
consistency checks, with the JAX package's tolerances and finite-difference
steps; run them in float64. Random moves and masks come from a
torch.Generator on the CPU, so a seed gives the same checks on every
device. Each check raises AssertionError on a mismatch and returns its
largest error where it computes one; `run_all` runs those the
wavefunction has methods for.

    from pyqmc_tpu_torch.models import testwf
    testwf.run_all(wf, params, configs, torch.Generator().manual_seed(0))
"""

from __future__ import annotations

import numpy as np
import torch


def _normal(generator, like, shape):
    return torch.randn(shape, generator=generator, dtype=torch.float64).to(like.device, like.dtype)


def _uniform(generator, like, shape):
    return torch.rand(shape, generator=generator, dtype=torch.float64).to(like.device)


def _max(x):
    return float(torch.max(torch.abs(x)))


def test_updateinternals(wf, params, configs, generator, tol=1e-9):
    """Masked single-electron moves with Sherman-Morrison updates must match
    a full recompute."""
    pos = configs.positions.clone()
    nconf, nelec = pos.shape[:2]
    state = wf.recompute(params, pos)
    errors = []
    for e in range(nelec):
        newpos = pos[:, e, :] + 0.3 * _normal(generator, pos, (nconf, 3))
        newpos, _ = configs.make_irreducible(newpos)
        mask = _uniform(generator, pos, (nconf,)) > 0.5
        _, saved = wf.testvalue(params, state, e, newpos)
        state = wf.updateinternals(params, state, e, newpos, mask, saved)
        pos[:, e, :] = torch.where(mask[:, None], newpos, pos[:, e, :])
        ph_u, la_u = wf.value(params, state)
        ph_r, la_r = wf.value(params, wf.recompute(params, pos))
        errors.append((_max(la_u - la_r), _max(ph_u - ph_r)))
    err = float(np.max(np.asarray(errors)))
    assert err < tol, f"updateinternals mismatch: {errors}"
    return err


def test_testvalue(wf, params, configs, generator, tol=1e-9):
    """testvalue must equal the ratio of recomputed values."""
    pos = configs.positions
    nconf, nelec = pos.shape[:2]
    state = wf.recompute(params, pos)
    ph0, la0 = wf.value(params, state)
    for e in (0, nelec - 1):
        newpos = pos[:, e, :] + 0.4 * _normal(generator, pos, (nconf, 3))
        newpos, _ = configs.make_irreducible(newpos)
        ratio, _ = wf.testvalue(params, state, e, newpos)
        pos2 = pos.clone()
        pos2[:, e, :] = newpos
        ph2, la2 = wf.value(params, wf.recompute(params, pos2))
        ratio_ref = (ph2 / ph0) * torch.exp(la2 - la0)
        err = _max(ratio - ratio_ref)
        assert err < tol * (_max(ratio_ref) + 1), f"testvalue mismatch e={e}: {err}"


def test_testvalue_many(wf, params, configs, generator, tol=1e-9):
    """Each column of testvalue_many must equal testvalue for that electron."""
    pos = configs.positions
    nconf, nelec = pos.shape[:2]
    state = wf.recompute(params, pos)
    epos = pos[:, 0, :] + 0.5 * _normal(generator, pos, (nconf, 3))
    epos, _ = configs.make_irreducible(epos)
    many = wf.testvalue_many(params, state, epos)
    assert tuple(many.shape) == (nconf, nelec)
    for e in range(nelec):
        one, _ = wf.testvalue(params, state, e, epos)
        err = _max(many[:, e] - one)
        assert err < tol * (1 + _max(one)), (e, err)


def test_gradient_value_pair(wf, params, configs, generator, tol=1e-10):
    """gradient_value_pair must agree with separate gradient and
    gradient_value calls."""
    pos = configs.positions
    nconf = pos.shape[0]
    state = wf.recompute(params, pos)
    epos_old = pos[:, 0, :]
    epos_new = epos_old + 0.4 * _normal(generator, pos, (nconf, 3))
    go, gn, ratio, _ = wf.gradient_value_pair(params, state, 0, epos_old, epos_new)
    go_ref = wf.gradient(params, state, 0, epos_old)
    gn_ref, r_ref, _ = wf.gradient_value(params, state, 0, epos_new)
    for a, b in ((go, go_ref), (gn, gn_ref), (ratio, r_ref)):
        assert _max(a - b) < tol * (1 + _max(b))


def test_gradient_current(wf, params, configs, generator, tol=1e-6):
    """gradient_current (the cached-orbital drift) must match gradient at
    each electron's current position, from a fresh recompute and after
    accepted and rejected updateinternals moves."""
    pos = configs.positions.clone()
    nconf, nelec = pos.shape[:2]
    state = wf.recompute(params, pos)

    def check(state, pos, tag):
        for e in range(nelec):
            epos = pos[:, e, :]
            gc = wf.gradient_current(params, state, e, epos)
            gref = wf.gradient(params, state, e, epos)
            err = _max(gc - gref)
            assert err < tol * (1 + _max(gref)), f"gradient_current mismatch {tag} e={e}: {err}"

    check(state, pos, "fresh")
    # move half the walkers for a few electrons through gradient_value +
    # updateinternals (the hot path's cache maintenance)
    for e in range(min(nelec, 3)):
        newpos = pos[:, e, :] + 0.3 * _normal(generator, pos, (nconf, 3))
        newpos, _ = configs.make_irreducible(newpos)
        _, _, saved = wf.gradient_value(params, state, e, newpos)
        mask = torch.arange(nconf, device=pos.device) % 2 == 0
        state = wf.updateinternals(params, state, e, newpos, mask, saved)
        pos[:, e, :] = torch.where(mask[:, None], newpos, pos[:, e, :])
    check(state, pos, "after updates")


def test_gradient(wf, params, configs, generator, delta=1e-5, tol=1e-5):
    """grad log psi against central finite differences of testvalue."""
    pos = configs.positions
    nelec = pos.shape[1]
    state = wf.recompute(params, pos)
    maxerr = 0.0
    for e in (0, nelec - 1):
        epos = pos[:, e, :]
        grad = wf.gradient(params, state, e, epos)
        for ax in range(3):
            shift = torch.zeros(3, dtype=pos.dtype, device=pos.device)
            shift[ax] = delta
            rp, _ = wf.testvalue(params, state, e, epos + shift)
            rm, _ = wf.testvalue(params, state, e, epos - shift)
            # d/dx psi/psi = (r+ - r-) / (2 delta) at ratio ~ 1
            maxerr = max(maxerr, _max(grad[:, ax] - (rp - rm) / (2 * delta)))
    assert maxerr < tol, f"gradient FD mismatch {maxerr}"
    return maxerr


def test_gradient_laplacian(wf, params, configs, generator, delta=1e-4, tol=1e-4):
    """lap psi / psi against finite differences of testvalue; its gradient
    against gradient_value's."""
    pos = configs.positions
    nconf, nelec = pos.shape[:2]
    state = wf.recompute(params, pos)
    maxerr = 0.0
    for e in (0, nelec - 1):
        epos = pos[:, e, :]
        grad, lap = wf.gradient_laplacian(params, state, e, epos)
        gv, ratio, _ = wf.gradient_value(params, state, e, epos)
        maxerr = max(maxerr, _max(gv - grad), _max(ratio - 1.0))
        acc = -6.0 * torch.ones(nconf, dtype=pos.dtype, device=pos.device)
        for ax in range(3):
            shift = torch.zeros(3, dtype=pos.dtype, device=pos.device)
            shift[ax] = delta
            rp, _ = wf.testvalue(params, state, e, epos + shift)
            rm, _ = wf.testvalue(params, state, e, epos - shift)
            acc = acc + rp + rm
        maxerr = max(maxerr, _max(lap - acc / delta**2))
    assert maxerr < tol, f"laplacian FD mismatch {maxerr}"
    return maxerr


def flatten_leaves(tree):
    """Leaves of a parameter tree: dicts by sorted key, lists in order, as
    jax.flatten_util.ravel_pytree orders them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten_leaves(v)]
    return [tree]


def flatten(tree):
    """(flat 1-d tensor of the leaves of a parameter tree, complex if any
    leaf is, unflatten), in flatten_leaves' order."""
    leaves = flatten_leaves(tree)
    flat = torch.cat([x.reshape(-1) for x in leaves])

    def unflatten(f):
        it = iter(torch.split(f, [x.numel() for x in leaves]))

        def build(t):
            if isinstance(t, dict):
                return {k: build(t[k]) for k in sorted(t)}
            if isinstance(t, (list, tuple)):
                return type(t)(build(v) for v in t)
            x = next(it).reshape(t.shape)
            # cat promotes a tree with complex leaves to complex
            return x.real if x.is_complex() and not t.is_complex() else x

        return build(tree)

    return flat, unflatten


def _tree_sum0(tree):
    if isinstance(tree, dict):
        return {k: _tree_sum0(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_sum0(v) for v in tree)
    return torch.sum(tree, dim=0)


def test_pgradient(wf, params, configs, generator, delta=1e-6, tol=1e-5):
    """pgradient against finite differences of log|psi| summed over the
    walkers, on 10 parameters picked by numpy's default_rng(0) (the JAX
    check's picks); for each the best of four steps is taken, as high
    curvature near a node makes any single step unreliable. pgradient is
    holomorphic for a complex parameter, d log psi / dp: along its real
    direction d log|psi| is Re(g), along its imaginary direction -Im(g),
    and both are checked."""
    pos = configs.positions
    flat_p, unflatten = flatten(params)
    flat_g, _ = flatten(_tree_sum0(wf.pgradient(params, pos)))

    def total_logabs(fp):
        p = unflatten(fp)
        return float(torch.sum(wf.value(p, wf.recompute(p, pos))[1]))

    leaf_complex = np.concatenate([np.full(x.numel(), x.is_complex())
                                   for x in flatten_leaves(params)])
    rng = np.random.default_rng(0)
    idx = rng.choice(flat_p.shape[0], size=min(10, flat_p.shape[0]), replace=False)
    maxerr = 0.0
    for i in idx:
        g = complex(flat_g[i]) if flat_g.is_complex() else float(flat_g[i])
        directions = [(1.0, np.real(g))]
        if leaf_complex[i]:
            directions.append((1j, -np.imag(g)))
        for direction, expect in directions:
            best = np.inf
            for d in (1e-4, 1e-5, 1e-6, 1e-7):
                up, dn = flat_p.clone(), flat_p.clone()
                up[i] += direction * d
                dn[i] -= direction * d
                fd = (total_logabs(up) - total_logabs(dn)) / (2 * d)
                best = min(best, abs(expect - fd))
            maxerr = max(maxerr, best)
    assert maxerr < tol, f"pgradient FD mismatch {maxerr}"
    return maxerr


def run_all(wf, params, configs, generator):
    test_updateinternals(wf, params, configs, generator)
    test_testvalue(wf, params, configs, generator)
    if hasattr(wf, "testvalue_many"):
        test_testvalue_many(wf, params, configs, generator)
    if hasattr(wf, "gradient_value_pair"):
        test_gradient_value_pair(wf, params, configs, generator)
    if hasattr(wf, "gradient_current"):
        test_gradient_current(wf, params, configs, generator)
    test_gradient(wf, params, configs, generator)
    test_gradient_laplacian(wf, params, configs, generator)
    test_pgradient(wf, params, configs, generator)

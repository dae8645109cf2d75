"""The port's AOs and wavefunctions against the JAX package, ccECP/cc-pVDZ
H2O (23 AOs, l <= 2), float64 on both sides.

Tolerance 1e-10, absolute and relative: both sides evaluate the same
formulas in float64 and differ only in summation order, which moves the
last few bits. The relative part covers determinant inverses, whose
entries reach O(100) for walkers near a node. The JAX side is jitted (with
a traced electron index) so each function compiles once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.models.multiply import default_move_begin as j_begin
from pyqmc_tpu.models.multiply import default_move_finish as j_finish
from pyqmc_tpu.ops.gto import GTOSpec as JSpec
from pyqmc_tpu.ops.gto import eval_gto as j_eval_gto

from pyqmc_tpu_torch.models.multiply import default_move_begin as t_begin
from pyqmc_tpu_torch.models.multiply import default_move_finish as t_finish
from pyqmc_tpu_torch.ops.gto import GTOSpec as TSpec
from pyqmc_tpu_torch.ops.gto import eval_gto as t_eval_gto

from .torch_parity import F64, assert_trees_close, h2o_pair, h2o_params, h2o_wf_objects, walkers

TOL = 1e-10


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_eval_gto(mode):
    (jmol, _), (tmol, _) = h2o_pair()
    X = np.random.default_rng(1).normal(scale=1.5, size=(7, 5, 3))
    jspec = JSpec.from_molecule(jmol)
    out_j = jax.jit(lambda x: j_eval_gto(jspec, x, mode))(jnp.asarray(X))
    tspec = TSpec.from_molecule(tmol)
    out_t = t_eval_gto(tspec, torch.as_tensor(X, dtype=F64), mode)
    assert_trees_close(out_j, out_t, atol=TOL)
    assert tspec.nao == 23


@functools.lru_cache(maxsize=None)
def _jax_fns():
    jwf, _ = h2o_wf_objects()

    def move(p, s, e, old, new, mask):
        g_old, aux = j_begin(jwf, p, s, e, old)
        g_new, ratio, saved = j_finish(jwf, p, s, e, new, aux)
        return g_old, g_new, ratio, jwf.updateinternals(p, s, e, new, mask, saved)

    def lap_tv(p, s, e, at, aux):
        return jwf.gradient_laplacian(p, s, e, at), jwf.testvalue(p, s, e, aux)[0]

    return jax.jit(jwf.recompute), jax.jit(jwf.value), jax.jit(move), jax.jit(lap_tv)


def _states(seed, nconf=5):
    rng = np.random.default_rng(seed)
    jwf, twf = h2o_wf_objects()
    jp, tp = h2o_params(rng)
    pos = walkers(rng, nconf)
    js = _jax_fns()[0](jp, jnp.asarray(pos))
    ts = twf.recompute(tp, torch.as_tensor(pos, dtype=F64))
    return rng, (jp, js), (twf, tp, ts), pos


def test_recompute_and_value():
    _, (jp, js), (twf, tp, ts), _ = _states(2)
    assert_trees_close(js, ts, atol=TOL, rtol=TOL)
    assert_trees_close(_jax_fns()[1](jp, js), twf.value(tp, ts), atol=TOL)


@pytest.mark.parametrize("e", [0, 3, 4, 7])
def test_move_halves_and_updateinternals(e):
    """move_begin / move_finish at a proposal, then a masked
    updateinternals: gradients, ratio and every state leaf."""
    rng, (jp, js), (twf, tp, ts), pos = _states(10 + e)
    new = pos[:, e, :] + rng.normal(scale=0.4, size=(pos.shape[0], 3))
    mask = np.array([True, False, True, True, False])
    g_old_j, g_new_j, r_j, js2 = _jax_fns()[2](
        jp, js, jnp.int32(e), jnp.asarray(pos[:, e, :]), jnp.asarray(new), jnp.asarray(mask))
    g_old_t, aux_t = t_begin(twf, tp, ts, e, torch.as_tensor(pos[:, e, :], dtype=F64))
    g_new_t, r_t, sv_t = t_finish(twf, tp, ts, e, torch.as_tensor(new, dtype=F64), aux_t)
    ts2 = twf.updateinternals(tp, ts, e, torch.as_tensor(new, dtype=F64),
                              torch.as_tensor(mask), sv_t)
    assert_trees_close((g_old_j, g_new_j, r_j), (g_old_t, g_new_t, r_t), atol=TOL)
    assert_trees_close(js2, ts2, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("e", [1, 6])
def test_gradient_laplacian_and_testvalue(e):
    rng, (jp, js), (twf, tp, ts), pos = _states(20 + e)
    at = pos[:, e, :] + rng.normal(scale=0.3, size=(pos.shape[0], 3))
    aux = pos[:, e, None, :] + rng.normal(scale=0.5, size=(pos.shape[0], 6, 3))
    out_j = _jax_fns()[3](jp, js, jnp.int32(e), jnp.asarray(at), jnp.asarray(aux))
    gl_t = twf.gradient_laplacian(tp, ts, e, torch.as_tensor(at, dtype=F64))
    tv_t, _ = twf.testvalue(tp, ts, e, torch.as_tensor(aux, dtype=F64))
    assert_trees_close(out_j, (gl_t, tv_t), atol=TOL)

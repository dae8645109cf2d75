"""Wavefunction optimization of the port against the JAX package, float64,
on shared numpy inputs: ccECP/cc-pVDZ H2O, generate_wf's Slater x
two-body Jastrow (33 free Jastrow coefficients), the energy with the dense
nonlocal ECP.

(1) LinearTransform: flat vectors, gradient pairs and deserialize, exact,
    on the H2O parameters (generate_wf's to_opt and all of them) and on
    dicts with complex leaves;
(2) one VMC block with the SR accumulator on shared streams, 4 walkers and
    2 steps: every block average (dp, dpH, dpidpj included) to 1e-8;
(3) nodal_regularization across the cutoff;
(4) the SR step and |g| from the same block averages, to 1e-12;
(5) correlated-sampling energies and effective sample sizes of 3
    candidates on 8 walkers with the same rotations, to 1e-9;
(6) select_candidate and update_tau_grid on a table of cases;
(7) the variance cost of optvariance, to 1e-9;
(8) a CPU line_minimization of 2 short iterations on 16 walkers;
(9) EnergyAccumulator(ewald=) and gradient_generator's Ewald arguments.

The JAX functions that run once are compiled with XLA's backend
optimisation off (compile_quick).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method import linemin as jlinemin
from pyqmc_tpu.method.vmc import make_vmc_block as j_make_vmc_block
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.sr import StochasticReconfiguration as JSR
from pyqmc_tpu.observables.sr import nodal_regularization as j_nodal
from pyqmc_tpu.observables.transform import LinearTransform as JTransform
from pyqmc_tpu.wftools import generate_wf as j_generate_wf

from pyqmc_tpu_torch.configs import Configs, Geometry
from pyqmc_tpu_torch.convert import params_from_numpy
from pyqmc_tpu_torch.method import linemin as tlinemin
from pyqmc_tpu_torch.method.optvariance import optvariance, variance_cost
from pyqmc_tpu_torch.method.vmc import make_vmc_block
from pyqmc_tpu_torch.models.slater import DeterminantExpansion
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator, gradient_generator
from pyqmc_tpu_torch.observables.ewald import Ewald
from pyqmc_tpu_torch.observables.sr import StochasticReconfiguration, nodal_regularization
from pyqmc_tpu_torch.observables.transform import LinearTransform
from pyqmc_tpu_torch.wftools import generate_slater, generate_wf

from .test_torch_vmc import NCONF, NSTEPS, TSTEP
from .torch_parity import (F64, compile_quick, diamond_cells, h2o_pair, jax_ecp_draws,
                           jax_rotations, to_np, walkers)

# the keys of the JAX package's iteration records (method/linemin.py:251-259)
RECORD_KEYS = {"iteration", "energy", "energy_err", "gnorm", "tau", "stalled", "line_energies"}


@functools.lru_cache(maxsize=None)
def h2o_opt():
    """generate_wf on both sides, with the same random Jastrow
    coefficients: (jax wf, jax params, jax to_opt, port wf, port params,
    port to_opt)."""
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    jwf, jp, jto = j_generate_wf(jmol, jmf)
    twf, tp0, tto = generate_wf(tmol, tmf, device="cpu")
    assert tp0["wf1"]["acoeff"].dtype == F64
    rng = np.random.default_rng(91)
    jp["wf1"]["acoeff"] = jnp.asarray(rng.normal(scale=0.1, size=jp["wf1"]["acoeff"].shape))
    jp["wf1"]["bcoeff"] = jp["wf1"]["bcoeff"] + jnp.asarray(
        rng.normal(scale=0.05, size=jp["wf1"]["bcoeff"].shape))
    tp = params_from_numpy(jax.device_get(jp), device="cpu", dtype=F64)
    return jwf, jp, jto, twf, tp, tto


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def random_tree(rng, params, nconf=None):
    """numpy arrays shaped as params' leaves (with a leading nconf axis
    when given), complex where the leaf is."""
    def leaf(x):
        shape = ((nconf,) if nconf else ()) + tuple(np.shape(x))
        out = rng.normal(size=shape)
        return out + 1j * rng.normal(size=shape) if np.iscomplexobj(x) else out
    if isinstance(params, dict):
        return {k: random_tree(rng, v, nconf) for k, v in params.items()}
    return leaf(params)


def t_tree(tree):
    if isinstance(tree, dict):
        return {k: t_tree(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


# --- (1) LinearTransform -------------------------------------------------------

def _complex_params():
    return {"a": np.array([1.0, 2.0, 3.0]), "c": np.array([1.0 + 2.0j, -0.5 + 0.25j])}


def _factory_params(jastrow3, jastrow=True):
    """generate_wf's JAX parameters and to_opt with the new factors' leaves:
    the 5-d ccoeff, GPS's 0-d f and (s, 2, 3) Xsupport, geminal's gcoeff."""
    from pyqmc_tpu.wftools import generate_geminal_jastrow, generate_gps_jastrow

    (jmol, jmf), _ = h2o_pair()
    if jastrow == "factories":
        jastrow = [generate_gps_jastrow, generate_geminal_jastrow]
    _, jp, jto = j_generate_wf(jmol, jmf, jastrow=jastrow, jastrow3=jastrow3)
    return jp, jto


TRANSFORM_CASES = {
    "h2o_to_opt": lambda: (h2o_opt()[1], h2o_opt()[2]),
    "j3_to_opt": lambda: _factory_params(True),
    "j3_ccoeff_only": lambda: (_factory_params(True)[0],
                               {"wf0": False, "wf1": False, "wf2": {"ccoeff": True}}),
    "factories_to_opt": lambda: _factory_params(True, "factories"),
    "h2o_all": lambda: (h2o_opt()[1], None),
    "complex_all": lambda: (_complex_params(), None),
    "complex_masked": lambda: (_complex_params(),
                               {"a": np.array([True, False, True]), "c": np.array([False, True])}),
    "complex_leaf_frozen": lambda: (_complex_params(), {"a": True, "c": False}),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_linear_transform_matches_jax(case):
    params, to_opt = TRANSFORM_CASES[case]()
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = t_tree(jax.device_get(jparams))
    jt, tt = JTransform(jparams, to_opt), LinearTransform(tparams, to_opt)
    assert (tt.nparams, tt.nreal, tt.nimag) == (jt.nparams, jt.nreal, jt.nimag)
    for a, b in zip(tt.masks, jt.masks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt.serialize(tparams).numpy(), np.asarray(jt.serialize(jparams)))
    rng = np.random.default_rng(17)
    grads = random_tree(rng, jax.device_get(jparams), nconf=3)
    jR, jI = jt.serialize_gradients_pair(jax.tree.map(jnp.asarray, grads))
    tR, tI = tt.serialize_gradients_pair(t_tree(grads))
    np.testing.assert_array_equal(tR.numpy(), np.asarray(jR))
    assert (tI is None) == (jI is None)
    if jI is not None:
        np.testing.assert_array_equal(tI.numpy(), np.asarray(jI))
        with pytest.raises(ValueError, match="serialize_gradients_pair"):
            tt.serialize_batch(t_tree(grads))
    else:
        np.testing.assert_array_equal(tt.serialize_batch(t_tree(grads)).numpy(), np.asarray(jR))
    flat = rng.normal(size=jt.nparams)
    before = [x.clone() for x in to_np_tensors(tparams)]
    jnew = jt.deserialize(jparams, jnp.asarray(flat))
    tnew = tt.deserialize(tparams, flat)
    for a, b in zip(to_np(tnew), to_np(jnew)):
        np.testing.assert_array_equal(a, b)
    # the caller's parameters are left as they were
    for a, b in zip(to_np_tensors(tparams), before):
        assert torch.equal(a, b)
    if case == "h2o_to_opt":
        assert tt.nparams == 33 and tt.sizes == [0, 0, 0, 24, 9]


def to_np_tensors(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in to_np_tensors(tree[k])]
    return [tree]


# --- (2) one VMC block with the SR accumulator -------------------------------

@functools.partial(jax.jit, static_argnums=(1, 2))
def jax_block_draws(key, nelec, nconf):
    """The draws of method/vmc.py's block for one accumulator (as
    tests/test_torch_vmc.py:jax_block_streams makes them), in one jitted
    call: gauss, unif and each step's ECP rotations."""
    kg, ku, ka = jax.random.split(key, 3)
    gauss = jax.random.normal(kg, (NSTEPS, nelec, nconf, 3), jnp.float64) * jnp.sqrt(TSTEP)
    unif = jax.random.uniform(ku, (NSTEPS, nelec, nconf), jnp.float64)
    akeys = jax.random.split(ka, NSTEPS).reshape((NSTEPS, 1) + ka.shape)
    rot = jax.vmap(lambda k: jax_ecp_draws(k, nelec, nconf)[0])(akeys[:, 0])
    return {"gauss": gauss, "unif": unif, "rot": rot}


@functools.lru_cache(maxsize=None)
def sr_blocks():
    """One 2-step VMC block with {"pgrad": SR} on both sides, on the JAX
    block's streams: (jax averages as numpy, port averages, port
    positions, jax positions)."""
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, jp, jto, twf, tp, tto = h2o_opt()
    pos = walkers(np.random.default_rng(23), NCONF)
    key = jax.random.PRNGKey(29)
    jsr = JSR(JEnergy(jmol), JTransform(jp, jto))
    jblock = j_make_vmc_block(jwf, {"pgrad": jsr}, JGeometry(None), tstep=TSTEP, nsteps=NSTEPS,
                              fused=False)
    args = (jp, jnp.array(pos), jnp.zeros((NCONF, 8, 3), jnp.int32), key)
    p_j, _, avg_j = compile_quick(jblock, *args)(*args)
    streams = {k: t64(v) for k, v in jax_block_draws(key, 8, NCONF).items()}
    tsr = StochasticReconfiguration(EnergyAccumulator(tmol), LinearTransform(tp, tto))
    block = make_vmc_block(twf, {"pgrad": tsr}, Geometry(), tstep=TSTEP, nsteps=NSTEPS)
    p_t, _, avg_t = block(tp, t64(pos), torch.zeros((NCONF, 8, 3), dtype=torch.int32), None,
                          streams)
    return {k: np.asarray(v) for k, v in avg_j.items()}, avg_t, p_t, np.asarray(p_j)


def test_sr_vmc_block_matches_jax():
    avg_j, avg_t, p_t, p_j = sr_blocks()
    np.testing.assert_allclose(p_t.numpy(), p_j, atol=1e-9)
    assert set(avg_t) == set(avg_j) == {"acceptance", "pgradtotal", "pgraddp", "pgraddpH",
                                         "pgraddpidpj"}
    assert avg_t["pgraddp"].shape == (33,) and avg_t["pgraddpH"].shape == (33,)
    assert avg_t["pgraddpidpj"].shape == (33, 33) and avg_t["pgradtotal"].shape == ()
    for k in avg_j:
        np.testing.assert_allclose(avg_t[k].numpy(), avg_j[k], atol=1e-8, rtol=1e-8, err_msg=k)
    assert np.max(np.abs(avg_j["pgraddpidpj"])) > 1e-2


def test_vmc_returns_array_averages():
    """vmc() hands array-valued averages back as numpy arrays, 0-d ones as
    floats, in one copy per block."""
    (_, _), (tmol, _) = h2o_pair()
    _, _, _, twf, tp, tto = h2o_opt()
    from pyqmc_tpu_torch.method.vmc import vmc

    configs = Configs.create(t64(walkers(np.random.default_rng(3), 4)), Geometry())
    sr = StochasticReconfiguration(EnergyAccumulator(tmol), LinearTransform(tp, tto))
    data, _ = vmc(twf, tp, configs, nblocks=2, nsteps_per_block=1, accumulators={"pgrad": sr},
                  generator=torch.Generator().manual_seed(4))
    for d in data:
        assert isinstance(d["pgradtotal"], float) and isinstance(d["acceptance"], float)
        assert isinstance(d["pgraddpidpj"], np.ndarray) and d["pgraddpidpj"].shape == (33, 33)
        assert d["pgraddp"].shape == (33,) and np.all(np.isfinite(d["pgraddpidpj"]))


# --- (3), (4) nodal regularization and the SR step -----------------------------

def test_nodal_regularization_matches_jax():
    cutoff = 1e-3
    grad2 = np.concatenate([np.logspace(3, 9, 41), [1.0 / cutoff**2]])
    np.testing.assert_allclose(nodal_regularization(t64(grad2), cutoff).numpy(),
                               np.asarray(j_nodal(jnp.asarray(grad2), cutoff)),
                               rtol=1e-14, atol=0)
    f = nodal_regularization(t64(grad2), cutoff).numpy()
    assert np.all(f[grad2 <= 1 / cutoff**2] == 1.0) and np.all(f[grad2 > 10 / cutoff**2] < 1.0)


def test_delta_p_matches_jax():
    avg_j = sr_blocks()[0]
    (jmol, _), (tmol, _) = h2o_pair()
    _, jp, jto, _, tp, tto = h2o_opt()
    # two blocks: the block's averages and a perturbed copy
    rng = np.random.default_rng(5)
    block_avg = {k: np.stack([avg_j[f"pgrad{k}"],
                              avg_j[f"pgrad{k}"] * (1 + 0.01 * rng.normal(size=np.shape(
                                  avg_j[f"pgrad{k}"])))])
                 for k in ("total", "dp", "dpH", "dpidpj")}
    taus = [0.0, 0.02, 0.1, 0.4]
    js, jg = JSR(JEnergy(jmol), JTransform(jp, jto), eps=1e-3).delta_p(taus, block_avg)
    ts, tg = StochasticReconfiguration(EnergyAccumulator(tmol), LinearTransform(tp, tto),
                                       eps=1e-3).delta_p(taus, block_avg)
    np.testing.assert_allclose(tg, jg, rtol=1e-12)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-12 * np.max(np.abs(b)))
    assert np.max(np.abs(ts[-1])) > 0


# --- (5) correlated sampling ---------------------------------------------------

def _candidates(rng, jp, jto, tp, tto, n=3, scale=0.05):
    jt, tt = JTransform(jp, jto), LinearTransform(tp, tto)
    x0 = np.asarray(jt.serialize(jp))
    xs = [x0 + scale * (i + 1) * rng.normal(size=x0.shape) for i in range(n)]
    return [jt.deserialize(jp, jnp.asarray(x)) for x in xs], [tt.deserialize(tp, x) for x in xs]


@functools.lru_cache(maxsize=None)
def jax_sampler():
    """The JAX package's correlated sampler on 8 walkers, compiled once:
    (sampler, walkers, key); optvariance's cost is the variance of its
    local energies."""
    (jmol, _), _ = h2o_pair()
    jwf, jp = h2o_opt()[:2]
    pos = jnp.asarray(walkers(np.random.default_rng(31), 8))
    key = jax.random.PRNGKey(37)
    sampler = jlinemin.make_correlated_sampler(jwf, JEnergy(jmol), JGeometry(None))
    return compile_quick(sampler, jp, pos, key), pos, key


def test_correlated_energies_match_jax():
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, jp, jto, twf, tp, tto = h2o_opt()
    sampler, pos, ckey = jax_sampler()
    pos = np.asarray(pos)
    jc, tc = _candidates(np.random.default_rng(33), jp, jto, tp, tto)
    je, jess = jlinemin.correlated_energies(sampler, jp, jc, jnp.asarray(pos), ckey)
    rot = t64(jax_rotations(ckey, 8, 8))
    te, tess = tlinemin.correlated_energies(
        tlinemin.make_correlated_sampler(twf, EnergyAccumulator(tmol)), tp, tc, t64(pos), rot)
    np.testing.assert_allclose(te, je, rtol=1e-9)
    np.testing.assert_allclose(tess, jess, rtol=1e-9, atol=1e-12)
    assert np.all(tess < 1.0) and np.all(tess > 0.0)


def test_correlated_weights_do_not_overflow():
    """A candidate whose log-amplitudes lie 1000 above the reference's
    (exp(2000) overflows float64) gets finite weights: the maximum is
    subtracted before the exponential."""
    la0 = torch.zeros(4, dtype=torch.float32)
    la = torch.tensor([1000.0, 999.0, 998.0, 1000.0])
    el = torch.tensor([-17.0, -17.2, -16.9, -17.1])

    def sampler(p, positions, rot, u_sel=None):
        return (la0, el) if p == "p0" else (la, el)

    e, ess = tlinemin.correlated_energies(sampler, "p0", ["p1"], torch.zeros(4, 8, 3), None)
    w = np.exp(2.0 * (la.double().numpy() - 1000.0))
    np.testing.assert_allclose(e, [np.sum(w * el.double().numpy()) / np.sum(w)], rtol=1e-12)
    np.testing.assert_allclose(ess, [np.sum(w) ** 2 / (np.sum(w * w) * 4)], rtol=1e-12)


# --- (6) the line search's bookkeeping ------------------------------------------

SELECT_CASES = [
    ([-17.0, -17.1, -17.05], [0.9, 0.8, 0.95], [0.0, 0.1, 0.2]),
    ([-17.0, -17.3, -17.05], [0.9, 0.2, 0.95], [0.0, 0.1, 0.2]),  # best fails the guard
    ([-17.0, -17.3, -17.05], [0.1, 0.2, 0.3], [0.0, 0.1, 0.2]),  # all fail: a stall
    ([-17.0, -17.0, -17.05], [0.31, 0.31, 0.29], [0.0, 0.05, 0.4]),
    ([-17.2, -17.1], [1.0, 1.0], [0.0, 0.02]),  # tau 0 wins
]


@pytest.mark.parametrize("energies,ess,taus", SELECT_CASES)
def test_select_candidate_matches_jax(energies, ess, taus):
    assert (tlinemin.select_candidate(np.array(energies), np.array(ess), list(taus))
            == jlinemin.select_candidate(np.array(energies), np.array(ess), list(taus)))


TAU_CASES = [
    ([0.0, 0.1, 0.2], [0.0, 0.1, 0.2], 0, False, 2),
    ([0.0, 0.05, 0.1], [0.0, 0.1, 0.2], 0, False, 2),
    ([0.0, 0.05, 0.1], [0.0, 0.1, 0.2], 1, False, 2),  # recovers: doubled
    ([0.0, 0.05, 0.1], [0.0, 0.1, 0.2], 1, True, 2),  # a stall resets the streak
    ([0.0, 0.025, 0.05], [0.0, 0.1, 0.2], 0, False, 1),
    ([0.0, 0.075, 0.15], [0.0, 0.1, 0.2], 3, False, 2),  # capped at taus0
]


@pytest.mark.parametrize("taus,taus0,streak,stalled,recover", TAU_CASES)
def test_update_tau_grid_matches_jax(taus, taus0, streak, stalled, recover):
    assert (tlinemin.update_tau_grid(list(taus), list(taus0), streak, stalled, recover)
            == jlinemin.update_tau_grid(list(taus), list(taus0), streak, stalled, recover))


# --- (7) optvariance ---------------------------------------------------------

def test_variance_cost_matches_jax():
    """The JAX optvariance's cost, the variance of the local energies with
    its key's rotations, is that of the correlated sampler's energies."""
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, jp, jto, twf, tp, tto = h2o_opt()
    sampler, jpos, key = jax_sampler()
    pos = np.asarray(jpos)
    jt, tt = JTransform(jp, jto), LinearTransform(tp, tto)
    tenergy = EnergyAccumulator(tmol)
    rot = t64(jax_rotations(key, 8, 8))
    cost = variance_cost(tenergy, twf, tp, t64(pos), tt, rot)
    x0 = np.asarray(jt.serialize(jp))
    for x in (x0, x0 + 0.05 * np.random.default_rng(41).normal(size=x0.shape)):
        jc = float(np.var(np.asarray(sampler(jt.deserialize(jp, jnp.asarray(x)), jpos, key)[1])))
        np.testing.assert_allclose(cost(x), jc, rtol=1e-9)
    # a short Powell run never ends above its start (on its own rotations)
    gen = torch.Generator().manual_seed(7)
    fun, p = optvariance(tenergy, twf, tp, Configs.create(t64(pos), Geometry()), tt,
                         generator=gen, options={"maxfev": 3})
    rot7, _ = tlinemin.draw_ecp_streams(torch.Generator().manual_seed(7), 8, 8, "cpu", F64)
    x0_cost = variance_cost(tenergy, twf, tp, t64(pos), tt, rot7)(x0)
    assert fun <= x0_cost + 1e-12 and set(p) == set(tp)


# --- (8) line_minimization on the CPU ------------------------------------------

def test_line_minimization_on_cpu():
    """2 iterations of 3 x 2 SR steps on 16 walkers: records with the JAX
    package's keys, finite, and each iteration's step -tau S_reg^-1 g
    from its own block averages (handed to the callback)."""
    (_, _), (tmol, _) = h2o_pair()
    _, _, _, twf, tp, tto = h2o_opt()
    seen = []
    configs = Configs.create(t64(walkers(np.random.default_rng(47), 16)), Geometry())
    tt = LinearTransform(tp, tto)
    params, cfg, records = tlinemin.line_minimization(
        twf, tp, configs, tt, EnergyAccumulator(tmol), generator=torch.Generator().manual_seed(53),
        max_iterations=2, vmc_blocks=3, vmc_steps_per_block=2,
        callback=lambda rec, info: seen.append(info))
    assert len(records) == len(seen) == 2
    step = np.zeros(tt.nparams)
    for rec, info in zip(records, seen):
        assert set(rec) == RECORD_KEYS
        assert all(np.all(np.isfinite(rec[k])) for k in ("energy", "energy_err", "gnorm",
                                                            "line_energies"))
        assert len(rec["line_energies"]) == 6 and rec["tau"] in (0.0, 0.02, 0.05, 0.1, 0.2, 0.4)
        avg = info["block_avg"]
        assert avg["dpidpj"].shape == (3, 33, 33) and avg["total"].shape == (3,)
        en = np.mean(avg["total"])
        dp, dpH = np.mean(avg["dp"], axis=0), np.mean(avg["dpH"], axis=0)
        S = np.mean(avg["dpidpj"], axis=0) - np.outer(dp, dp)
        g = 2.0 * (dpH - en * dp)
        np.testing.assert_allclose(rec["gnorm"], np.linalg.norm(g), rtol=1e-12)
        step += -rec["tau"] * np.linalg.solve(S + 1e-3 * np.eye(len(dp)), g)
        assert set(info["seconds"]) == {"vmc", "solve", "correlated"}
        assert len(info["candidates"]) == 6 and info["rot"].shape == (8, 16, 3, 3)
    np.testing.assert_allclose((tt.serialize(params) - tt.serialize(tp)).numpy(), step,
                               atol=1e-12)
    assert cfg.positions.shape == (16, 8, 3)


# --- (9) the accumulators' arguments and the factories ---------------------------

def test_energy_accumulator_takes_the_given_ewald():
    _, _, tcell = diamond_cells()
    ew = Ewald(tcell, alpha=1.3)
    acc = EnergyAccumulator(tcell, ecp_acc=False, ewald=ew)
    assert acc.coulomb is ew
    assert EnergyAccumulator(tcell, ecp_acc=False).coulomb.alpha != 1.3
    x = t64(np.random.default_rng(59).uniform(0, 1, size=(2, 8, 3)) @ tcell.lattice)
    ee = acc.coulomb.energy(x)
    for a, b in zip(ee, ew.energy(x)):
        assert torch.equal(a, b)
    # gradient_generator builds its Ewald from the keywords it is given
    sr = gradient_generator(tcell, None, {"a": torch.zeros(2, dtype=F64)}, alpha=1.3)
    assert sr.energy_acc.coulomb.alpha == 1.3 and sr.transform.nparams == 2
    assert sr.energy_acc.ecp_acc is not None


def test_factories(tmp_path):
    (_, _), (tmol, tmf) = h2o_pair()
    wf, params, to_opt = generate_wf(tmol, tmf, device="cpu")
    assert to_opt["wf0"] == {"det_coeff": False, "mo_coeff_alpha": False, "mo_coeff_beta": False}
    assert to_opt["wf1"]["acoeff"] is True and not to_opt["wf1"]["bcoeff"][0].any()
    assert to_opt["wf1"]["bcoeff"][1:].all()
    exp = DeterminantExpansion.single(4, 4)
    sl = generate_slater(tmol, tmf, mc=(exp, np.array([0.5])))
    assert sl.make_params("cpu")["det_coeff"].tolist() == [0.5]
    # any other CI object goes through interpret_ci, as in the JAX package:
    # a pyscf-style dense CI array over the CAS orbitals 3 and 4 (ncore 3)
    from pyqmc_tpu.system.ci_import import interpret_ci as j_interpret_ci

    mc = types.SimpleNamespace(ci=np.array([[0.9, 0.0], [0.0, -0.4]]), ncas=2, nelecas=(1, 1),
                               ncore=3)
    sl = generate_slater(tmol, tmf, mc=mc)
    jexp, jcoeff = j_interpret_ci(mc, 1e-8)
    for a, b in ((sl.expansion.occ_up, jexp.occ_up), (sl.expansion.occ_dn, jexp.occ_dn),
                 (sl.expansion.map_up, jexp.map_up), (sl.expansion.map_dn, jexp.map_dn)):
        np.testing.assert_array_equal(a, b)
    assert sl.expansion.occ_up.tolist() == [[0, 1, 2, 3], [0, 1, 2, 4]]
    assert sl.make_params("cpu")["det_coeff"].tolist() == [0.9, -0.4] == list(jcoeff)
    assert sl.orbitals.norb == (5, 5)
    with pytest.raises(AttributeError):
        generate_slater(tmol, tmf, mc=object())
    # the three-body Jastrow and the factories: JAX's to_opt layout and make_params
    from pyqmc_tpu.wftools import generate_geminal_jastrow as j_geminal
    from pyqmc_tpu.wftools import generate_gps_jastrow as j_gps
    from pyqmc_tpu_torch.wftools import (generate_geminal_jastrow, generate_gps_jastrow,
                                         read_superposition)

    (jmol, jmf), _ = h2o_pair()
    cases = [({"jastrow3": True}, {"jastrow3": True}),
             ({"jastrow": [generate_gps_jastrow, generate_geminal_jastrow],
               "jastrow_kws": [{"n_support": 3}, {}], "jastrow3": True},
              {"jastrow": [j_gps, j_geminal], "jastrow_kws": [{"n_support": 3}, {}],
               "jastrow3": True}),
             ({"jastrow": generate_gps_jastrow, "jastrow_kws": {"seed": 2}},
              {"jastrow": j_gps, "jastrow_kws": {"seed": 2}})]
    for tkw, jkw in cases:
        twf, tp, tto = generate_wf(tmol, tmf, device="cpu", **tkw)
        _, jp, jto = j_generate_wf(jmol, jmf, **jkw)
        assert len(twf.wfs) == len(jto) and set(tto) == set(jto)
        for k in jto:
            assert set(tto[k]) == set(jto[k]), k
            for leaf in jto[k]:
                np.testing.assert_array_equal(np.asarray(tto[k][leaf]),
                                              np.asarray(jto[k][leaf]))
        for a, b in zip(to_np(tp), to_np(jp)):
            np.testing.assert_array_equal(a, b)
    assert twf.make_params("cpu")["wf1"]["f"].shape == ()
    # read_superposition of two parameter files (written by the port) equals
    # the JAX package's of the same files
    import h5py

    from pyqmc_tpu.wftools import read_superposition as j_read_superposition
    from pyqmc_tpu_torch.wftools import save_wf_params

    files = [str(tmp_path / f"wf{i}.h5") for i in range(2)]
    for i, name in enumerate(files):
        _, p_i, _ = generate_wf(tmol, tmf, device="cpu")
        p_i["wf1"]["acoeff"] = p_i["wf1"]["acoeff"] + 0.1 * (i + 1)
        with h5py.File(name, "w") as f:
            save_wf_params(f.require_group("wf"), p_i)
    swf, sp, sto = read_superposition(tmol, tmf, files, [0.6, 0.8], device="cpu")
    _, jsp, jsto = j_read_superposition(jmol, jmf, files, [0.6, 0.8])
    assert len(swf.wfs) == 2 and sto["coeff"] is False and set(sto) == set(jsto)
    for a, b in zip(to_np(sp), to_np(jsp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    sl_only, p_only, t_only = generate_wf(tmol, tmf, jastrow=False, device="cpu")
    assert set(p_only) == set(t_only) == {"det_coeff", "mo_coeff_alpha", "mo_coeff_beta"}

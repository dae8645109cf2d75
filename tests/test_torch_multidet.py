"""The multi-determinant Slater-Jastrow path of the port against the JAX
package, float64 on the CPU: the full-valence CASCI(8e,8o) expansion of
ccECP/cc-pVDZ H2O (1,098 determinants over 70 x 70 unique
spin-determinants, pyqmc_tpu_torch/data/h2o_ccecp_cas88.npz), the same
numpy inputs on both sides.

(a) the multi-determinant Slater's state, values, ratios, gradients,
    laplacians and updates to 1e-10;
(b) testvalue_many, gradient, gradient_value_pair and pgradient of Slater,
    JastrowSpin and MultiplyWF to 1e-10;
(c) the port's testwf.run_all on the three, and its failure on a
    pgradient scaled by 1.01;
(d) one VMC block and one DMC block with T-moves of the
    multi-Slater-Jastrow on shared streams: positions, state leaves (each
    step's, averaged over the block), energies and weights to 1e-9,
    acceptance exactly;
(e) the kernels' gates: the expansion is outside K1, K2, K4 and K5; an
    explicit single determinant through the general constructor is inside.

The JAX functions of (a) and (b) run eagerly; the blocks of (d) are
compiled with XLA's backend optimisation off (compile_quick).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method import dmc as jdmc
from pyqmc_tpu.method.vmc import make_vmc_block as j_make_vmc_block
from pyqmc_tpu.models.jastrow import JastrowSpin as JJastrow
from pyqmc_tpu.models.multiply import MultiplyWF as JMultiply
from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
from pyqmc_tpu.models.slater import Slater as JSlater
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy

from pyqmc_tpu_torch.configs import Geometry, initial_guess
from pyqmc_tpu_torch.convert import (dmc_streams_from_numpy, params_from_numpy,
                                     slater_state_from_numpy)
from pyqmc_tpu_torch.entry import h2o_casci_setup
from pyqmc_tpu_torch.method import dmc as tdmc
from pyqmc_tpu_torch.method.vmc import make_vmc_block
from pyqmc_tpu_torch.models import testwf
from pyqmc_tpu_torch.models.jastrow import JastrowSpin
from pyqmc_tpu_torch.models.multiply import MultiplyWF
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
from pyqmc_tpu_torch.ops.ecp_energy import build_fused_ecp_energy
from pyqmc_tpu_torch.ops.linalg import sherman_morrison_row
from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep
from pyqmc_tpu_torch.ops.tmove_sweep import build_fused_tmove_sweep
from pyqmc_tpu_torch.system.io import load_expansion_npz

from .test_torch_dmc import NSTEPS, TSTEP, jax_dmc_block
from .torch_parity import F64, h2o_pair, jax_vmc_block, jrun, to_np, walkers

NCONF = 8
TOL = 1e-10


def t64(x):
    return torch.tensor(np.array(x), dtype=F64)


@functools.lru_cache(maxsize=None)
def cas_objects():
    """The CASCI expansion on both sides and the wavefunctions built from
    it: {"slater", "jastrow", "multiply"} -> (jax wf, port wf), with the
    parameters (jax, port) of each (random Jastrow coefficients)."""
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    d = load_expansion_npz()
    jexp = JExpansion(occ_up=d["occ_up"], occ_dn=d["occ_dn"], map_up=d["map_up"],
                      map_dn=d["map_dn"])
    texp = DeterminantExpansion(occ_up=d["occ_up"], occ_dn=d["occ_dn"], map_up=d["map_up"],
                                map_dn=d["map_dn"])
    ca = np.asarray(jmf.mo_coeff[0])[:, :d["ncas"]]
    np.testing.assert_array_equal(ca, tmf.mo_coeff[0][:, :d["ncas"]])
    js = JSlater(jmol, None, jexp, (ca, ca), det_coeff=d["det_coeff"])
    ts = Slater(tmol, None, texp, (ca, ca), det_coeff=d["det_coeff"])
    wfs = {"slater": (js, ts), "jastrow": (JJastrow(jmol), JastrowSpin(tmol))}
    wfs["multiply"] = (JMultiply(js, wfs["jastrow"][0]), MultiplyWF(ts, wfs["jastrow"][1]))
    rng = np.random.default_rng(41)
    jj = wfs["jastrow"][0].make_params()
    jj["acoeff"] = jnp.asarray(rng.normal(scale=0.1, size=jj["acoeff"].shape))
    jj["bcoeff"] = jj["bcoeff"] + jnp.asarray(rng.normal(scale=0.05, size=jj["bcoeff"].shape))
    jparams = {"slater": js.make_params(), "jastrow": jj}
    jparams["multiply"] = {"wf0": jparams["slater"], "wf1": jj}
    params = {k: (p, params_from_numpy(jax.device_get(p), device="cpu", dtype=F64))
              for k, p in jparams.items()}
    return wfs, params, d


def _pair(name):
    wfs, params, _ = cas_objects()
    return wfs[name] + params[name]


def _positions(seed, nconf=NCONF):
    return walkers(np.random.default_rng(seed), nconf)


def close(a, b, tol=TOL):
    for x, y in zip(to_np(a), to_np(b)):
        np.testing.assert_allclose(x, y, atol=tol, rtol=tol)


# --- (a) the multi-determinant Slater ---------------------------------------

def _states(name, pos):
    """(jax state, port state) of wavefunction `name` at pos (numpy)."""
    jwf, twf, jp, tp = _pair(name)
    return (jrun((name, "recompute"), jwf.recompute, jp, jnp.asarray(pos)),
            twf.recompute(tp, t64(pos)))


SLATER_METHODS = ["recompute", "value", "testvalue", "testvalue_aux_all",
                  "testvalue_aux_all_mixed", "gradient_value", "gradient_current",
                  "gradient_laplacian", "updateinternals"]


@pytest.mark.parametrize("method", SLATER_METHODS)
def test_multidet_slater_matches_jax(method):
    """Each method of the multi-determinant Slater against the JAX
    package's on shared walkers (one spin-up and one spin-down electron
    where it takes one); testvalue_aux_all for all electrons and for a
    mixed-spin chunk es = (5, 1, 6); updateinternals with half the walkers
    moving, from a testvalue `saved` (orbitals re-evaluated) and from a
    gradient_value one."""
    jwf, twf, jp, tp = _pair("slater")
    rng = np.random.default_rng(43)
    pos = _positions(42)
    jst, tst = _states("slater", pos)
    assert tst.inv_up.shape == (NCONF, 70, 4, 4) and tst.logdet_dn.shape == (NCONF, 70)
    if method == "recompute":
        close(tst, jst)
        return
    if method == "value":
        close(twf.value(tp, tst), jrun(("slater", "value"), jwf.value, jp, jst))
        return
    if method.startswith("testvalue_aux_all"):
        es = None if method == "testvalue_aux_all" else (5, 1, 6)
        ne = 8 if es is None else len(es)
        aux = pos[:, :ne].transpose(1, 0, 2)[:, :, None, :] + rng.normal(
            scale=0.5, size=(ne, NCONF, 6, 3))
        close(twf.testvalue_aux_all(tp, tst, t64(aux), es=es),
              jrun(("slater", method), lambda p, s, a: jwf.testvalue_aux_all(p, s, a, es=es),
                   jp, jst, jnp.asarray(aux)))
        return
    jfn = {
        "testvalue": lambda p, s, e, x: jwf.testvalue(p, s, e, x)[0],
        "gradient_value": lambda p, s, e, x: jwf.gradient_value(p, s, e, x)[:2],
        "gradient_current": lambda p, s, e, x: jwf.gradient_current(p, s, e),
        "gradient_laplacian": jwf.gradient_laplacian,
        "updateinternals": lambda p, s, e, x, m: [
            jwf.updateinternals(p, s, e, x, m, jwf.testvalue(p, s, e, x)[1]),
            jwf.updateinternals(p, s, e, x, m, jwf.gradient_value(p, s, e, x)[2])],
    }[method]
    mask = np.arange(NCONF) % 2 == 1
    for e in (2, 6):
        epos = pos[:, e] + rng.normal(scale=0.4, size=(NCONF, 3))
        te, jargs = t64(epos), (jp, jst, jnp.int32(e), jnp.asarray(epos))
        if method == "testvalue":
            close(twf.testvalue(tp, tst, e, te)[0], jrun(("slater", method), jfn, *jargs))
            aux = epos[:, None] + rng.normal(scale=0.3, size=(NCONF, 5, 3))
            close(twf.testvalue(tp, tst, e, t64(aux))[0],
                  jrun(("slater", method, "aux"), jfn, *jargs[:3], jnp.asarray(aux)))
        elif method == "gradient_value":
            close(twf.gradient_value(tp, tst, e, te)[:2], jrun(("slater", method), jfn, *jargs))
        elif method == "gradient_current":
            close(twf.gradient_current(tp, tst, e), jrun(("slater", method), jfn, *jargs))
        elif method == "gradient_laplacian":
            close(twf.gradient_laplacian(tp, tst, e, te), jrun(("slater", method), jfn, *jargs))
        else:
            jnew = jrun(("slater", method), jfn, *jargs, jnp.asarray(mask))
            tm = torch.as_tensor(mask)
            tnew = [twf.updateinternals(tp, tst, e, te, tm, twf.testvalue(tp, tst, e, te)[1]),
                    twf.updateinternals(tp, tst, e, te, tm, twf.gradient_value(tp, tst, e, te)[2])]
            close(tnew, jnew)
            # the moved walkers' determinants changed, the others' did not
            inv_t = (tnew[0].inv_up if e < 4 else tnew[0].inv_dn).numpy()
            inv_0 = (tst.inv_up if e < 4 else tst.inv_dn).numpy()
            assert np.array_equal(inv_t[~mask], inv_0[~mask])
            assert not np.allclose(inv_t[mask], inv_0[mask])


def test_singular_determinant_is_held():
    """A move that makes one unique determinant exactly singular (its
    orbitals all zero at the new point, so its ratio is 0) holds it at zero
    until the next recompute: phase 0, log|det| -inf, a zero inverse. The
    other determinants take the ordinary update, the value and the next
    ratios stay finite, and a later move leaves the determinant held. (In
    float32 such a zero ratio happens on the card within a block; without
    the hold its inverse's inf entries make the energies nan.)"""
    _, twf, _, tp = _pair("slater")
    pos = t64(_positions(42))
    st = twf.recompute(tp, pos)
    occ0 = twf.expansion.occ_up[0]
    mo = torch.as_tensor(np.random.default_rng(44).normal(size=(NCONF, 8)), dtype=F64)
    mo[:, occ0] = 0.0  # unique up-determinant 0 has a zero row at the new point
    g = torch.zeros((NCONF, 3, 8), dtype=F64)
    saved = {"mo_up": mo, "mo_dn": mo, "gmo_up": g, "gmo_dn": g}
    mask = torch.ones(NCONF, dtype=torch.bool)
    held = twf.updateinternals(tp, st, 1, pos[:, 1], mask, saved)
    assert bool(torch.all(held.phase_up[:, 0] == 0)) and bool(torch.all(held.inv_up[:, 0] == 0))
    assert bool(torch.all(held.logdet_up[:, 0] == -torch.inf))
    rows = mo[:, twf.expansion.occ_up.reshape(-1)].reshape(NCONF, -1, 4)
    ratio, inv_new = sherman_morrison_row(st.inv_up, rows, 1)
    np.testing.assert_array_equal(held.inv_up[:, 1:].numpy(), inv_new[:, 1:].numpy())
    np.testing.assert_allclose(held.logdet_up[:, 1:].numpy(),
                               (st.logdet_up + torch.log(torch.abs(ratio)))[:, 1:].numpy())
    phase, logabs = twf.value(tp, held)
    assert bool(torch.all(torch.isfinite(logabs))) and bool(torch.all(phase != 0))
    ratio, saved2 = twf.testvalue(tp, held, 2, pos[:, 2] + 0.1)
    assert bool(torch.all(torch.isfinite(ratio)))
    again = twf.updateinternals(tp, held, 2, pos[:, 2] + 0.1, mask, saved2)
    assert bool(torch.all(again.phase_up[:, 0] == 0)) and bool(torch.all(again.inv_up[:, 0] == 0))
    assert bool(torch.all(torch.isfinite(twf.value(tp, again)[1])))


# --- (b) the protocol methods of the three wavefunctions ----------------------

@pytest.mark.parametrize("method", ["testvalue_many", "gradient", "gradient_value_pair",
                                    "pgradient"])
@pytest.mark.parametrize("name", ["slater", "jastrow", "multiply"])
def test_protocol_matches_jax(name, method):
    jwf, twf, jp, tp = _pair(name)
    rng = np.random.default_rng(47)
    pos = _positions(42)
    jpos, tpos = jnp.asarray(pos), t64(pos)
    if method == "pgradient":
        tg = twf.pgradient(tp, tpos)
        close(tg, jrun((name, method), jwf.pgradient, jp, jpos))
        if name == "slater":
            assert tg["det_coeff"].shape == (NCONF, 1098)
            assert tg["mo_coeff_alpha"].shape == (NCONF, 23, 8)
        return
    jst, tst = _states(name, pos)
    epos = pos[:, 3] + rng.normal(scale=0.5, size=(NCONF, 3))
    if method == "testvalue_many":
        close(twf.testvalue_many(tp, tst, t64(epos)),
              jrun((name, method), jwf.testvalue_many, jp, jst, jnp.asarray(epos)))
        return
    for e in (1, 7):
        jargs = (jp, jst, jnp.int32(e))
        if method == "gradient":
            close(twf.gradient(tp, tst, e, t64(epos)),
                  jrun((name, method), jwf.gradient, *jargs, jnp.asarray(epos)))
        else:
            close(twf.gradient_value_pair(tp, tst, e, tpos[:, e], t64(epos))[:3],
                  jrun((name, method), lambda *a: jwf.gradient_value_pair(*a)[:3], *jargs,
                       jpos[:, e], jnp.asarray(epos)))


# --- (c) run_all --------------------------------------------------------------

def _configs(seed, nconf=6):
    """Walkers as the JAX package's run_all tests make them (initial_guess:
    electrons near the nuclei), not random points near the origin, where
    a finite difference across a near-node walker misses the pgradient
    tolerance on the JAX side as well."""
    (_, _), (tmol, _) = h2o_pair()
    return initial_guess(tmol, nconf, generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("name", ["slater", "jastrow", "multiply"])
def test_run_all_passes(name):
    _, twf, _, tp = _pair(name)
    testwf.run_all(twf, tp, _configs(51), torch.Generator().manual_seed(52))


class ScaledPgradient:
    """A wavefunction whose pgradient is off by 1%."""

    def __init__(self, wf):
        self.wf = wf
        self.nelec = wf.nelec

    def __getattr__(self, name):
        return getattr(self.wf, name)

    def pgradient(self, params, positions):
        g = self.wf.pgradient(params, positions)
        return {k: {k2: 1.01 * v for k2, v in sub.items()} for k, sub in g.items()}


def test_run_all_fails_on_a_broken_pgradient():
    _, twf, _, tp = _pair("multiply")
    broken = ScaledPgradient(twf)
    configs, gen = _configs(51), torch.Generator().manual_seed(52)
    testwf.test_gradient_laplacian(broken, tp, configs, gen)  # the rest still holds
    with pytest.raises(AssertionError, match="pgradient"):
        testwf.run_all(broken, tp, configs, gen)


# --- (d) whole blocks on shared streams ----------------------------------------

class JProbe:
    """JAX accumulator whose outputs are the state's leaves (per walker)."""

    def avg(self, wf, params, state, positions, key=None):
        return {f"{i:02d}": x for i, x in enumerate(jax.tree.leaves(state))}

    __call__ = avg


class TProbe:
    """The port's counterpart: keeps each step's leaves (VMC, whose block
    averages reduce every axis) or returns them (DMC, whose block takes
    their weighted mean over the walkers as the JAX block does)."""

    def __init__(self):
        self.steps = []

    def avg(self, wf, params, state, positions, rot=None, u_sel=None):
        self.steps.append(to_np(state))
        return {}

    def __call__(self, wf, params, state, positions, rot=None, u_sel=None):
        return {f"{i:02d}": x for i, x in enumerate(_leaves(state))}


def _leaves(state):
    if isinstance(state, torch.Tensor):
        return [state]
    return [x for s in state for x in _leaves(s)]


def test_vmc_block_matches_jax():
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf, jp, tp = _pair("multiply")
    nconf, nsteps, tstep = 6, 2, 0.5
    pos = _positions(55, nconf)
    key = jax.random.PRNGKey(56)
    jblock = j_make_vmc_block(jwf, {"energy": JEnergy(jmol), "probe": JProbe()}, JGeometry(None),
                              tstep=tstep, nsteps=nsteps, fused=False)
    args = (jp, jnp.array(pos), jnp.zeros((nconf, 8, 3), jnp.int32), key)
    # the block and its draws (two accumulators, the rotations the first's)
    (p_j, _, avg_j), streams = jax_vmc_block(("multiply", "vmc block"), jblock, args, 8, nconf,
                                             nsteps, tstep, naccumulators=2)
    probe = TProbe()
    block = make_vmc_block(twf, {"energy": EnergyAccumulator(tmol), "probe": probe}, Geometry(),
                           tstep=tstep, nsteps=nsteps)
    p_t, _, avg_t = block(tp, t64(pos), torch.zeros((nconf, 8, 3), dtype=torch.int32), None,
                          streams)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    leaves_t = [np.mean(np.stack(s), axis=0) for s in zip(*probe.steps)]
    leaves_j = [np.asarray(avg_j[k]) for k in sorted(avg_j) if k.startswith("probe")]
    assert len(leaves_t) == len(leaves_j) == 10
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=1e-9)
    for k in avg_t:
        np.testing.assert_allclose(float(avg_t[k]), float(avg_j[k]), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    assert float(avg_t["acceptance"]) == float(avg_j["acceptance"])
    assert 0.0 < float(avg_t["acceptance"]) < 1.0 and abs(float(avg_t["energyecp"])) > 1e-3


def test_dmc_block_matches_jax():
    """One DMC block with T-moves at tstep 0.3, electrons started inside the
    O core so that T-moves happen: positions, the state leaves' weighted
    walker means per step, energies and weights to 1e-9; acceptance
    exactly."""
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf, jp, tp = _pair("multiply")
    nconf = 8
    rng = np.random.default_rng(57)
    pos = walkers(rng, nconf, scale=0.7)
    weights = rng.uniform(0.8, 1.2, size=nconf)
    e_trial, e_est, esigma = -17.05, -17.0, 0.5
    key = jax.random.PRNGKey(58)
    jblock, _ = jdmc.make_dmc_block(jwf, JEnergy(jmol), JGeometry(None), TSTEP, NSTEPS,
                                    accumulators={"probe": JProbe()}, fused=False)
    args = (jp, jnp.array(pos), jnp.zeros((nconf, 8, 3), jnp.int32), jnp.asarray(weights), key,
            jnp.float64(e_trial), jnp.float64(e_est), jnp.float64(esigma))
    (p_j, _, w_j, avg_j), draws = jax_dmc_block(("multiply", "dmc block"), jblock, args, 8,
                                                nconf, True)
    streams = dmc_streams_from_numpy(draws, device="cpu", dtype=F64)
    block, _ = tdmc.make_dmc_block(twf, EnergyAccumulator(tmol), Geometry(), TSTEP, NSTEPS,
                                   accumulators={"probe": TProbe()})
    p_t, _, w_t, avg_t = block(tp, t64(pos), torch.zeros((nconf, 8, 3), dtype=torch.int32),
                               t64(weights), None, t64(e_trial), t64(e_est), t64(esigma),
                               streams=streams)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-9)
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        if k == "acceptance":
            assert float(avg_t[k]) == float(avg_j[k])
        else:
            np.testing.assert_allclose(avg_t[k].numpy(), np.asarray(avg_j[k]), atol=1e-9,
                                       rtol=1e-9, err_msg=k)
    assert float(avg_t["acceptance"]) < 1.0
    # the T-moves moved some electron: the chain without them differs
    p_n = tdmc.make_dmc_block(twf, EnergyAccumulator(tmol), Geometry(), TSTEP, NSTEPS,
                              tmoves=False)[0](
        tp, t64(pos), torch.zeros((nconf, 8, 3), dtype=torch.int32), t64(weights), None,
        t64(e_trial), t64(e_est), t64(esigma), streams=streams)[0]
    assert bool(torch.any(torch.abs(p_n - p_t) > 1e-3))


# --- (e) the kernels' gates ------------------------------------------------------

def test_gates_reject_the_expansion():
    """K1/K4 (the sweeps), K5 (T-moves) and K2 (ECP energy) take the
    determinant of the first n orbitals only, as in the JAX package: their
    build_fused_* functions return None for the CASCI expansion, so its
    blocks run the plain versions; the same single determinant written out
    through the general constructor stays inside every gate."""
    (_, _), (tmol, tmf) = h2o_pair()
    ecp = ECPAccumulator(tmol)
    _, twf, _, _ = _pair("multiply")
    _, tslater, _, _ = _pair("slater")
    single = DeterminantExpansion(occ_up=np.arange(4)[None], occ_dn=np.arange(4)[None],
                                  map_up=np.zeros(1, np.int64), map_dn=np.zeros(1, np.int64))
    explicit = MultiplyWF(Slater(tmol, None, single, (tmf.mo_coeff[0][:, :4],
                                                      tmf.mo_coeff[1][:, :4]),
                                 det_coeff=np.ones(1)), JastrowSpin(tmol))
    for wf, inside in ((twf, False), (tslater, False), (explicit, True)):
        built = [build_fused_sweep(wf, Geometry(), 0.5),
                 build_fused_sweep(wf, Geometry(), 0.02, mode="dmc"),
                 build_fused_tmove_sweep(wf, Geometry(), ecp, 0.02),
                 build_fused_ecp_energy(wf, ecp)]
        assert all((b is not None) == inside for b in built), (inside, built)
    assert single == DeterminantExpansion.single(4, 4)
    assert hash(single) == hash(DeterminantExpansion.single(4, 4))
    assert tslater.expansion != single


def test_casci_setup_and_state_conversion():
    """h2o_casci_setup on the CPU: the expansion's shapes, the bare
    Slater of jastrow=False, and a JAX multi-determinant state converted
    leaf for leaf."""
    mol, wf, params, configs, acc = h2o_casci_setup(4, device="cpu")
    d = load_expansion_npz()
    assert len(d["det_coeff"]) == 1098 and d["e_casci"] < d["e_hf"] - 0.03
    assert params["wf0"]["det_coeff"].shape == (1098,)
    assert params["wf0"]["mo_coeff_alpha"].shape == (23, 8)
    _, bare, bparams, _, _ = h2o_casci_setup(4, device="cpu", jastrow=False)
    assert isinstance(bare, Slater) and set(bparams) == {"det_coeff", "mo_coeff_alpha",
                                                        "mo_coeff_beta"}
    _, twf, _, tp = _pair("slater")
    pos = _positions(42)
    jst, tst = _states("slater", pos)
    conv = slater_state_from_numpy(jax.device_get(jst), device="cpu", dtype=F64)
    assert conv.inv_up.shape == (NCONF, 70, 4, 4)
    close(conv, tst)
    close(twf.value(tp, conv), twf.value(tp, tst))

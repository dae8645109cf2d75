"""The three-body Jastrow of the port against the JAX package, float64 on
the CPU, the same numpy inputs on both sides: ccECP/cc-pVDZ H2O,
generate_jastrow3's basis (3 polypade e-ion and 3 polypade e-e functions,
ccoeff (3, 3, 3, 3, 3)).

(a) every ThreeBodyJastrow method to 1e-10: the state, value, testvalue
    (one point and a point axis), testvalue_aux_all (all electrons and a
    mixed-spin chunk, against the JAX package's per-electron default),
    testvalue_many, gradient, gradient_value, gradient_value_pair,
    move_begin/move_finish, gradient_laplacian(_many) (the batched one
    against JAX's per-electron calls), updateinternals and pgradient, whose
    (k, l)-antisymmetric part is zero;
(b) the port's run_all, and U under the swap of two same-spin electrons;
    func3d's broadcast polypade basis, bit for bit the per-function one;
    MultiplyWF(Slater, JastrowSpin, ThreeBodyJastrow)'s testvalue_many,
    testvalue_aux_all, gradient_value_pair, gradient_laplacian_many and
    pgradient to 1e-10, and its run_all;
(c) the K1, K2, K4 and K5 gates return None for a third factor;
(d) one 3-step VMC block and one 2-step DMC block with T-moves of
    MultiplyWF(Slater, JastrowSpin, ThreeBodyJastrow) on shared streams
    (the CASCI's 20 largest determinants, 8 walkers): positions, state
    leaves, energies and weights to 1e-9, acceptance exactly; the VMC
    block carries the SR accumulator of the 276 free Jastrow
    coefficients, every SR average to 1e-8;
(e) the committed coefficients of BASELINE config 3 give the same value on
    both sides to 1e-10, and h2o_casci_j3_setup builds it on the CPU.

The JAX functions are compiled with XLA's backend optimisation off
(compile_quick, jrun): called eagerly they take ten times as long.
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
from pyqmc_tpu.models.multiply import default_testvalue_aux_all as j_aux_all
from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.sr import StochasticReconfiguration as JSR
from pyqmc_tpu.observables.transform import LinearTransform as JTransform
from pyqmc_tpu.wftools import generate_jastrow3 as j_generate_jastrow3
from pyqmc_tpu.wftools import generate_wf as j_generate_wf

from pyqmc_tpu_torch.configs import Geometry, initial_guess
from pyqmc_tpu_torch.convert import dmc_streams_from_numpy, params_from_numpy, state_from_numpy
from pyqmc_tpu_torch.entry import h2o_casci_j3_setup
from pyqmc_tpu_torch.method import dmc as tdmc
from pyqmc_tpu_torch.method.vmc import make_vmc_block
from pyqmc_tpu_torch.models import testwf
from pyqmc_tpu_torch.models.jastrow3 import Jastrow3State, ThreeBodyJastrow
from pyqmc_tpu_torch.models.slater import DeterminantExpansion
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
from pyqmc_tpu_torch.observables.sr import StochasticReconfiguration
from pyqmc_tpu_torch.observables.transform import LinearTransform
from pyqmc_tpu_torch.ops.ecp_energy import build_fused_ecp_energy
from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep
from pyqmc_tpu_torch.ops.tmove_sweep import build_fused_tmove_sweep
from pyqmc_tpu_torch.system.io import H2O_J3_PARAMS, load_expansion_npz
from pyqmc_tpu_torch.wftools import generate_jastrow3, generate_wf

from .test_torch_dmc import NSTEPS as DMC_NSTEPS
from .test_torch_dmc import TSTEP as DMC_TSTEP
from .test_torch_dmc import jax_dmc_streams
from .test_torch_multidet import JProbe, TProbe
from .torch_parity import F64, assert_trees_close, compile_quick, h2o_pair, jrun, walkers

NCONF = 8
TOL = 1e-10


def t64(x):
    return torch.tensor(np.array(x), dtype=F64)


def close(a, b, tol=TOL):
    assert_trees_close(a, b, atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def j3_objects():
    """generate_jastrow3 on both sides with the same random ccoeff: (jax
    wf, port wf, jax params, port params)."""
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf = j_generate_jastrow3(jmol)[0], generate_jastrow3(tmol)[0]
    c = np.random.default_rng(81).normal(scale=0.1, size=jwf.make_params()["ccoeff"].shape)
    return jwf, twf, {"ccoeff": jnp.asarray(c)}, {"ccoeff": t64(c)}


@functools.lru_cache(maxsize=None)
def states():
    """The walkers and both states: (positions, jax state, port state)."""
    jwf, twf, jp, tp = j3_objects()
    pos = walkers(np.random.default_rng(82), NCONF)
    return (pos, jrun(("j3", "recompute"), jwf.recompute, jp, jnp.asarray(pos)),
            twf.recompute(tp, t64(pos)))


METHODS = ["recompute", "value", "testvalue", "testvalue_point_axis", "testvalue_aux_all",
           "testvalue_aux_all_mixed", "testvalue_many", "gradient", "gradient_value",
           "gradient_value_pair", "move_begin_finish", "gradient_laplacian",
           "gradient_laplacian_many", "updateinternals"]


@pytest.mark.parametrize("method", METHODS)
def test_three_body_matches_jax(method):
    jwf, twf, jp, tp = j3_objects()
    pos, jst, tst = states()
    rng = np.random.default_rng(83)
    if method == "recompute":
        close(tst, jst)
        close(state_from_numpy(Jastrow3State, jax.device_get(jst), device="cpu", dtype=F64), tst)
        return
    if method == "value":
        close(twf.value(tp, tst), jrun(("j3", method), jwf.value, jp, jst))
        return
    if method.startswith("testvalue_aux_all"):
        es = None if method == "testvalue_aux_all" else (5, 1, 6)
        ne = 8 if es is None else len(es)
        cur = pos if es is None else pos[:, list(es)]
        aux = cur.transpose(1, 0, 2)[:, :, None, :] + rng.normal(scale=0.5, size=(ne, NCONF, 6, 3))
        close(twf.testvalue_aux_all(tp, tst, t64(aux), es=es),
              jrun(("j3", method), lambda p, s, a: j_aux_all(jwf, p, s, a, es=es), jp, jst,
                   jnp.asarray(aux)))
        return
    epos = pos[:, 3] + rng.normal(scale=0.5, size=(NCONF, 3))
    if method == "testvalue_many":
        close(twf.testvalue_many(tp, tst, t64(epos)),
              jrun(("j3", method), jwf.testvalue_many, jp, jst, jnp.asarray(epos)))
        return
    if method == "gradient_laplacian_many":
        es = (6, 0, 3)
        ep = pos[:, list(es)] + rng.normal(scale=0.3, size=(NCONF, 3, 3))
        g, lap = twf.gradient_laplacian_many(tp, tst, es, t64(ep))
        for i, e in enumerate(es):
            close((g[:, i], lap[:, i]), jrun(("j3", "gradient_laplacian"), jwf.gradient_laplacian,
                                             jp, jst, jnp.int32(e), jnp.asarray(ep[:, i])))
        return
    mask = np.arange(NCONF) % 2 == 1
    jfn = {
        "testvalue": lambda p, s, e, x: jwf.testvalue(p, s, e, x)[0],
        "testvalue_point_axis": lambda p, s, e, x: jwf.testvalue(p, s, e, x)[0],
        "gradient": jwf.gradient,
        "gradient_value": lambda p, s, e, x: jwf.gradient_value(p, s, e, x)[:2],
        "gradient_value_pair": lambda p, s, e, x0, x: jwf.gradient_value_pair(p, s, e, x0, x)[:3],
        "move_begin_finish": lambda p, s, e, x0, x: (
            jwf.move_begin(p, s, e, x0)[0],
            jwf.move_finish(p, s, e, x, jwf.move_begin(p, s, e, x0)[1])[:2]),
        "gradient_laplacian": jwf.gradient_laplacian,
        "updateinternals": lambda p, s, e, x, m: jwf.updateinternals(
            p, s, e, x, m, jwf.testvalue(p, s, e, x)[1]),
    }[method]
    for e in (1, 6):
        E, te, je = jnp.int32(e), t64(epos), jnp.asarray(epos)
        args = (jp, jst, E)
        if method == "testvalue":
            close(twf.testvalue(tp, tst, e, te)[0], jrun(("j3", method), jfn, *args, je))
        elif method == "testvalue_point_axis":
            aux = epos[:, None] + rng.normal(scale=0.3, size=(NCONF, 5, 3))
            close(twf.testvalue(tp, tst, e, t64(aux))[0],
                  jrun(("j3", method), jfn, *args, jnp.asarray(aux)))
        elif method == "gradient":
            close(twf.gradient(tp, tst, e, te), jrun(("j3", method), jfn, *args, je))
        elif method == "gradient_value":
            close(twf.gradient_value(tp, tst, e, te)[:2], jrun(("j3", method), jfn, *args, je))
        elif method == "gradient_value_pair":
            close(twf.gradient_value_pair(tp, tst, e, t64(pos[:, e]), te)[:3],
                  jrun(("j3", method), jfn, *args, jnp.asarray(pos[:, e]), je))
        elif method == "move_begin_finish":
            g0, aux = twf.move_begin(tp, tst, e, t64(pos[:, e]))
            close((g0,) + twf.move_finish(tp, tst, e, te, aux)[:2],
                  jrun(("j3", method), jfn, *args, jnp.asarray(pos[:, e]), je))
        elif method == "gradient_laplacian":
            close(twf.gradient_laplacian(tp, tst, e, te), jrun(("j3", method), jfn, *args, je))
        else:
            tm = torch.as_tensor(mask)
            close(twf.updateinternals(tp, tst, e, te, tm, twf.testvalue(tp, tst, e, te)[1]),
                  jrun(("j3", method), jfn, *args, je, jnp.asarray(mask)))


def test_cusp_b_basis_matches_jax():
    """A b basis with the cutoffcusp function (f'/r large at the self pair's
    r = 0) through func3d's per-function path: the state, gradient and
    laplacian stay finite and match JAX to 1e-10."""
    from pyqmc_tpu.models.func3d import default_ee_basis as j_ee_basis
    from pyqmc_tpu.models.jastrow3 import ThreeBodyJastrow as JThreeBody
    from pyqmc_tpu_torch.models.func3d import default_ee_basis

    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf = JThreeBody(jmol, b_basis=j_ee_basis(2)), ThreeBodyJastrow(tmol,
                                                                       b_basis=default_ee_basis(2))
    c = np.random.default_rng(98).normal(scale=0.1, size=jwf.make_params()["ccoeff"].shape)
    jp, tp = {"ccoeff": jnp.asarray(c)}, {"ccoeff": t64(c)}
    pos = states()[0]
    jst = jrun(("cusp", "recompute"), jwf.recompute, jp, jnp.asarray(pos))
    tst = twf.recompute(tp, t64(pos))
    close(tst, jst)
    epos = pos[:, 4] + 0.2
    g, lap = twf.gradient_laplacian(tp, tst, 4, t64(epos))
    assert bool(torch.all(torch.isfinite(g))) and bool(torch.all(torch.isfinite(lap)))
    close((g, lap), jrun(("cusp", "gradient_laplacian"), jwf.gradient_laplacian, jp, jst,
                         jnp.int32(4), jnp.asarray(epos)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_polypade_broadcast_keeps_bits(dtype):
    """func3d evaluates a one-cutoff polypade basis (generate_jastrow3's a
    and b bases, JastrowSpin's e-ion basis) in one broadcast over its betas:
    the same bits as function by function, r = 0 and r = rcut included."""
    from pyqmc_tpu_torch.models import func3d

    r = torch.tensor(np.random.default_rng(99).uniform(0.0, 9.0, size=(5, 40)), dtype=dtype)
    r[0, :4], r[1, :4] = 0.0, 7.5
    for basis in (func3d.default_ei_basis(4), func3d.default_ei_basis(3),
                  func3d.default_ei_basis(1)):
        one_by_one = [func3d.basis_all(b, r) for b in basis]
        for i, out in enumerate(func3d.eval_basis_all(basis, r)):
            assert torch.equal(out, torch.stack([o[i] for o in one_by_one], dim=-1)), (basis, i)
        assert torch.equal(func3d.eval_basis_value(basis, r),
                           torch.stack([o[0] for o in one_by_one], dim=-1))


def test_pgradient_matches_jax():
    """dU/dccoeff per walker to 1e-10; its (k, l)-antisymmetric part is
    zero on both sides (autodiff through the symmetrization in JAX)."""
    jwf, twf, jp, tp = j3_objects()
    pos = states()[0]
    tg = twf.pgradient(tp, t64(pos))
    jg = jrun(("j3", "pgradient"), jwf.pgradient, jp, jnp.asarray(pos))
    close(tg, jg)
    c = tg["ccoeff"].numpy()
    assert c.shape == (NCONF, 3, 3, 3, 3, 3) and np.max(np.abs(c)) > 1e-3
    np.testing.assert_array_equal(c - c.transpose(0, 1, 3, 2, 4, 5), 0.0)
    ja = np.asarray(jg["ccoeff"])
    assert np.max(np.abs(ja - ja.transpose(0, 1, 3, 2, 4, 5))) < 1e-14


def _configs(seed, nconf=6):
    (_, _), (tmol, _) = h2o_pair()
    return initial_guess(tmol, nconf, generator=torch.Generator().manual_seed(seed), device="cpu")


def test_run_all_passes():
    _, twf, _, tp = j3_objects()
    testwf.run_all(twf, tp, _configs(84), torch.Generator().manual_seed(85))


def test_pair_symmetry():
    """U is the same after two same-spin electrons swap places."""
    _, twf, _, tp = j3_objects()
    pos = t64(states()[0])
    for a, b in ((0, 1), (5, 7)):
        swapped = pos.clone()
        swapped[:, [a, b]] = pos[:, [b, a]]
        close(twf.recompute(tp, swapped).u, twf.recompute(tp, pos).u, tol=1e-12)


@functools.lru_cache(maxsize=None)
def sj3_objects():
    """generate_wf(mol, mf, jastrow3=True) on both sides with the same
    random Jastrow coefficients: (jax wf, jax params, port wf, port
    params)."""
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    jwf, jp, _ = j_generate_wf(jmol, jmf, jastrow3=True)
    twf = generate_wf(tmol, tmf, jastrow3=True, device="cpu")[0]
    rng = np.random.default_rng(91)
    jp["wf1"]["acoeff"] = jnp.asarray(rng.normal(scale=0.1, size=jp["wf1"]["acoeff"].shape))
    jp["wf2"]["ccoeff"] = jnp.asarray(rng.normal(scale=0.05, size=jp["wf2"]["ccoeff"].shape))
    tp = params_from_numpy(jax.device_get(jp), device="cpu", dtype=F64)
    return jwf, jp, twf, tp


@pytest.mark.parametrize("method", ["testvalue_many", "testvalue_aux_all", "gradient_value_pair",
                                    "gradient_laplacian_many", "pgradient"])
def test_product_matches_jax(method):
    """MultiplyWF(Slater, JastrowSpin, ThreeBodyJastrow) composes the three
    factors as the JAX package's does."""
    jwf, jp, twf, tp = sj3_objects()
    rng = np.random.default_rng(94)
    pos = walkers(rng, NCONF)
    jpos = jnp.asarray(pos)
    if method == "pgradient":
        tg = twf.pgradient(tp, t64(pos))
        close(tg, jrun(("sj3", method), jwf.pgradient, jp, jpos))
        assert set(tg) == {"wf0", "wf1", "wf2"}
        return
    jst, tst = jrun(("sj3", "recompute"), jwf.recompute, jp, jpos), twf.recompute(tp, t64(pos))
    epos = pos[:, 2] + rng.normal(scale=0.5, size=(NCONF, 3))
    if method == "testvalue_many":
        close(twf.testvalue_many(tp, tst, t64(epos)),
              jrun(("sj3", method), jwf.testvalue_many, jp, jst, jnp.asarray(epos)))
    elif method == "testvalue_aux_all":
        aux = pos.transpose(1, 0, 2)[:, :, None, :] + rng.normal(scale=0.5, size=(8, NCONF, 6, 3))
        close(twf.testvalue_aux_all(tp, tst, t64(aux)),
              jrun(("sj3", method), jwf.testvalue_aux_all, jp, jst, jnp.asarray(aux)))
    elif method == "gradient_value_pair":
        close(twf.gradient_value_pair(tp, tst, 5, t64(pos[:, 5]), t64(epos))[:3],
              jrun(("sj3", method), lambda *a: jwf.gradient_value_pair(*a)[:3], jp, jst,
                   jnp.int32(5), jpos[:, 5], jnp.asarray(epos)))
    else:
        g, lap = twf.gradient_laplacian_many(tp, tst, (2, 7), t64(pos[:, [2, 7]]))
        for i, e in enumerate((2, 7)):
            close((g[:, i], lap[:, i]), jrun(("sj3", method), jwf.gradient_laplacian, jp, jst,
                                             jnp.int32(e), jpos[:, e]))


def test_product_run_all_passes():
    _, _, twf, tp = sj3_objects()
    testwf.run_all(twf, tp, _configs(95), torch.Generator().manual_seed(96))


# --- (c) the gates ------------------------------------------------------------

def test_gates_reject_a_third_factor():
    """K1/K4, K5 and K2 take MultiplyWF(Slater, JastrowSpin) or either
    alone: each build_fused_* returns None once a ThreeBodyJastrow joins
    (as the JAX package's _match_sj does), and not without it."""
    (_, _), (tmol, tmf) = h2o_pair()
    ecp = ECPAccumulator(tmol)
    with_j3 = generate_wf(tmol, tmf, jastrow3=True, device="cpu")[0]
    without = generate_wf(tmol, tmf, device="cpu")[0]
    assert isinstance(with_j3.wfs[2], ThreeBodyJastrow)
    for wf, inside in ((with_j3, False), (without, True)):
        built = [build_fused_sweep(wf, Geometry(), 0.5),
                 build_fused_sweep(wf, Geometry(), 0.02, mode="dmc"),
                 build_fused_tmove_sweep(wf, Geometry(), ecp, 0.02),
                 build_fused_ecp_energy(wf, ecp)]
        assert all((b is not None) == inside for b in built), (inside, built)


# --- (d) whole blocks of Slater x J2 x J3 -----------------------------------------

def top_expansion(d, n):
    """The n determinants of largest |det_coeff| of an expansion dict, with
    their unique spin-determinants renumbered: (occ_up, occ_dn, map_up,
    map_dn, det_coeff)."""
    keep = np.sort(np.argsort(-np.abs(d["det_coeff"]))[:n])
    out = []
    for s in ("up", "dn"):
        uniq, inv = np.unique(d[f"map_{s}"][keep], return_inverse=True)
        out += [d[f"occ_{s}"][uniq], inv.astype(np.int64)]
    return out[0], out[2], out[1], out[3], d["det_coeff"][keep]


@functools.lru_cache(maxsize=None)
def product_objects():
    """generate_wf(mol, mf, mc=(20 determinants), jastrow3=True) on both
    sides with the same random Jastrow coefficients: (jax wf, jax params,
    jax to_opt, port wf, port params, port to_opt)."""
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    occ_up, occ_dn, map_up, map_dn, coeff = top_expansion(load_expansion_npz(), 20)
    jexp = JExpansion(occ_up=occ_up, occ_dn=occ_dn, map_up=map_up, map_dn=map_dn)
    texp = DeterminantExpansion(occ_up=occ_up, occ_dn=occ_dn, map_up=map_up, map_dn=map_dn)
    jwf, jp, jto = j_generate_wf(jmol, jmf, mc=(jexp, coeff), jastrow3=True)
    twf, _, tto = generate_wf(tmol, tmf, mc=(texp, coeff), jastrow3=True, device="cpu")
    rng = np.random.default_rng(86)
    jp["wf1"]["acoeff"] = jnp.asarray(rng.normal(scale=0.1, size=jp["wf1"]["acoeff"].shape))
    jp["wf1"]["bcoeff"] = jp["wf1"]["bcoeff"] + jnp.asarray(
        rng.normal(scale=0.05, size=jp["wf1"]["bcoeff"].shape))
    jp["wf2"]["ccoeff"] = jnp.asarray(rng.normal(scale=0.05, size=jp["wf2"]["ccoeff"].shape))
    return jwf, jp, jto, twf, params_from_numpy(jax.device_get(jp), device="cpu", dtype=F64), tto


@functools.lru_cache(maxsize=None)
def vmc_blocks():
    """One 3-step VMC block of the product with {"pgrad": SR over the 276
    free Jastrow coefficients, "probe": the state leaves} on both sides, on
    the JAX block's streams (method/vmc.py:136-145, two accumulators, the
    rotations of the first): one JAX compile serves the VMC and the SR
    checks. Returns (jax positions, jax averages, port positions, port
    averages, port probe)."""
    from .torch_parity import jax_ecp_draws

    (jmol, _), (tmol, _) = h2o_pair()
    jwf, jp, jto, twf, tp, tto = product_objects()
    nsteps, tstep = 3, 0.5
    pos = walkers(np.random.default_rng(87), NCONF)
    key = jax.random.PRNGKey(88)
    jt, tt = JTransform(jp, jto), LinearTransform(tp, tto)
    assert tt.nparams == jt.nparams == 276
    jblock = j_make_vmc_block(jwf, {"pgrad": JSR(JEnergy(jmol), jt), "probe": JProbe()},
                              JGeometry(None), tstep=tstep, nsteps=nsteps, fused=False)
    args = (jp, jnp.array(pos), jnp.zeros((NCONF, 8, 3), jnp.int32), key)
    p_j, _, avg_j = compile_quick(jblock, *args)(*args)
    kg, ku, ka = jax.random.split(key, 3)
    akeys = jax.random.split(ka, nsteps * 2).reshape((nsteps, 2) + ka.shape)
    streams = {
        "gauss": t64(jax.random.normal(kg, (nsteps, 8, NCONF, 3), jnp.float64) * np.sqrt(tstep)),
        "unif": t64(jax.random.uniform(ku, (nsteps, 8, NCONF), jnp.float64)),
        "rot": t64(jax.vmap(lambda k: jax_ecp_draws(k, 8, NCONF)[0])(akeys[:, 0]))}
    probe = TProbe()
    block = make_vmc_block(twf, {"pgrad": StochasticReconfiguration(EnergyAccumulator(tmol), tt),
                                 "probe": probe}, Geometry(), tstep=tstep, nsteps=nsteps)
    p_t, _, avg_t = block(tp, t64(pos), torch.zeros((NCONF, 8, 3), dtype=torch.int32), None,
                          streams)
    return np.asarray(p_j), jax.device_get(avg_j), p_t.numpy(), avg_t, probe


def test_vmc_block_matches_jax():
    """Positions, the state leaves' step means, the energy and acceptance
    (exactly) of the VMC block to 1e-9."""
    p_j, avg_j, p_t, avg_t, probe = vmc_blocks()
    np.testing.assert_allclose(p_t, p_j, atol=1e-9)
    leaves_t = [np.mean(np.stack(s), axis=0) for s in zip(*probe.steps)]
    leaves_j = [np.asarray(avg_j[k]) for k in sorted(avg_j) if k.startswith("probe")]
    assert len(leaves_t) == len(leaves_j) == 12  # Slater 8, JastrowSpin 2, J3 2
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a, b, atol=1e-9, rtol=1e-9)
    for k in ("pgradtotal", "acceptance"):
        np.testing.assert_allclose(float(avg_t[k]), float(avg_j[k]), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    assert float(avg_t["acceptance"]) == float(avg_j["acceptance"])
    assert 0.0 < float(avg_t["acceptance"]) < 1.0


def test_sr_vmc_block_matches_jax():
    """Every SR average of the same block (dp, dpH, dpidpj over the 276
    coefficients) to 1e-8."""
    _, avg_j, _, avg_t, _ = vmc_blocks()
    keys = {k for k in avg_j if k.startswith("pgrad")}
    assert keys == {k for k in avg_t if k.startswith("pgrad")}
    assert keys >= {"pgradtotal", "pgraddp", "pgraddpH", "pgraddpidpj"}
    assert avg_t["pgraddpidpj"].shape == (276, 276)
    for k in keys:
        np.testing.assert_allclose(np.asarray(avg_t[k]), np.asarray(avg_j[k]), atol=1e-8,
                                   rtol=1e-8, err_msg=k)


def test_dmc_block_matches_jax():
    """A DMC block with T-moves, electrons started inside the O core so that
    T-moves happen: positions, the state leaves' weighted means, energies
    and weights to 1e-9, acceptance exactly."""
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, jp, _, twf, tp, _ = product_objects()
    rng = np.random.default_rng(89)
    pos = walkers(rng, NCONF, scale=0.7)
    weights = rng.uniform(0.8, 1.2, size=NCONF)
    e_trial, e_est, esigma = -17.05, -17.0, 0.5
    key = jax.random.PRNGKey(90)
    jblock, _ = jdmc.make_dmc_block(jwf, JEnergy(jmol), JGeometry(None), DMC_TSTEP, DMC_NSTEPS,
                                    accumulators={"probe": JProbe()}, fused=False)
    args = (jp, jnp.array(pos), jnp.zeros((NCONF, 8, 3), jnp.int32), jnp.asarray(weights), key,
            jnp.float64(e_trial), jnp.float64(e_est), jnp.float64(esigma))
    p_j, _, w_j, avg_j = compile_quick(jblock, *args)(*args)
    streams = dmc_streams_from_numpy(jax_dmc_streams(key, 8, NCONF, True), device="cpu",
                                     dtype=F64)
    block, _ = tdmc.make_dmc_block(twf, EnergyAccumulator(tmol), Geometry(), DMC_TSTEP,
                                   DMC_NSTEPS, accumulators={"probe": TProbe()})
    p_t, _, w_t, avg_t = block(tp, t64(pos), torch.zeros((NCONF, 8, 3), dtype=torch.int32),
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


# --- (e) BASELINE config 3 -----------------------------------------------------------

def test_committed_parameters_match_jax():
    """The committed two- and three-body coefficients, loaded into both
    packages' generate_wf(jastrow3=True), for which they were optimized,
    give the same state and log|psi| to 1e-10; h2o_casci_j3_setup puts
    them, unchanged, on the CASCI expansion's wavefunction."""
    mol, twf, tp, configs, acc = h2o_casci_j3_setup(4, device="cpu")
    assert len(twf.wfs) == 3 and isinstance(twf.wfs[2], ThreeBodyJastrow)
    assert tp["wf0"]["det_coeff"].shape == (1098,) and tp["wf2"]["ccoeff"].shape == (3, 3, 3, 3, 3)
    with np.load(H2O_J3_PARAMS) as z:
        ref = {k: z[k] for k in ("acoeff", "bcoeff", "ccoeff")}
    for leaf, k in (("wf1", "acoeff"), ("wf1", "bcoeff"), ("wf2", "ccoeff")):
        np.testing.assert_array_equal(tp[leaf][k].numpy(), ref[k])
    assert np.max(np.abs(ref["ccoeff"])) > 1e-4  # the three-body part was optimized
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    jwf, jp, _ = j_generate_wf(jmol, jmf, jastrow3=True)
    twf, sp, _ = generate_wf(tmol, tmf, jastrow3=True, device="cpu")
    jp["wf1"] = {"acoeff": jnp.asarray(ref["acoeff"]), "bcoeff": jnp.asarray(ref["bcoeff"])}
    jp["wf2"] = {"ccoeff": jnp.asarray(ref["ccoeff"])}
    sp = {"wf0": sp["wf0"], "wf1": tp["wf1"], "wf2": tp["wf2"]}
    pos = walkers(np.random.default_rng(93), 4)
    jst = jrun(("committed", "recompute"), jwf.recompute, jp, jnp.asarray(pos))
    tst = twf.recompute(sp, t64(pos))
    close(tst, jst)
    close(twf.value(sp, tst), jrun(("committed", "value"), jwf.value, jp, jst))

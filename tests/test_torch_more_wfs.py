"""The geminal and GPS Jastrows and AddWF of the port against the JAX
package, float64 on the CPU, the same numpy inputs on both sides.

(a) GeminalJastrow (the AOs of ccECP/cc-pVDZ H2O, 23 features) and
    GPSJastrow (3 support pairs): the state, testvalue (one point and a
    point axis), testvalue_many, gradient, gradient_value,
    gradient_laplacian, updateinternals and pgradient to 1e-10, and the
    port's run_all;
(b) the periodic GeminalJastrow on tests/files/h_pbc_casscf.npz: its
    feature map (the gamma-point supercell AOs) is periodic and equals
    JAX's with its derivatives, its state matches, and run_all passes;
(c) AddWF of H2O's ground determinant and a single excitation: value,
    testvalue (one point and a point axis), testvalue_many,
    gradient_value, gradient_current, gradient_laplacian, updateinternals
    and pgradient (coeff and each component's parameters) to 1e-10; the
    JAX package's contract subset (tests/unit/test_more_wfs.py:39-49) on
    the port; a modulus-ratio factor is refused.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.models.addwf import AddWF as JAddWF
from pyqmc_tpu.models.generic_jastrow import GeminalJastrow as JGeminal
from pyqmc_tpu.models.generic_jastrow import GPSJastrow as JGPS
from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
from pyqmc_tpu.models.slater import Slater as JSlater

from pyqmc_tpu_torch.configs import Configs, Geometry, initial_guess
from pyqmc_tpu_torch.convert import params_from_numpy, state_from_numpy
from pyqmc_tpu_torch.models import testwf
from pyqmc_tpu_torch.models.addwf import AddWF
from pyqmc_tpu_torch.models.generic_jastrow import (GeminalJastrow, GenericJastrowState,
                                                     GPSJastrow)
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater

from .torch_parity import F64, assert_trees_close, h2o_pair, jrun, walkers

NCONF = 6
TOL = 1e-10


def t64(x):
    return torch.tensor(np.array(x), dtype=F64)


def close(a, b, tol=TOL):
    assert_trees_close(a, b, atol=tol, rtol=tol)


@functools.lru_cache(maxsize=None)
def generic(name):
    """(jax wf, port wf, jax params, port params) with seeded nonzero
    coefficients."""
    (jmol, _), (tmol, _) = h2o_pair()
    rng = np.random.default_rng(101)
    if name == "geminal":
        jwf, twf = JGeminal(jmol), GeminalJastrow(tmol)
        jp = {"gcoeff": jnp.asarray(rng.normal(scale=0.02, size=(jmol.nao, jmol.nao)))}
    else:
        jwf, twf = JGPS(jmol, n_support=3), GPSJastrow(tmol, n_support=3)
        jp = jwf.make_params()
        close(twf.make_params("cpu"), jp, tol=0.0)  # the same support points from the seed
        jp["alpha"] = jnp.asarray(rng.normal(scale=0.1, size=3))
        jp["f"] = jnp.asarray(0.7)
    return jwf, twf, jp, params_from_numpy(jax.device_get(jp), device="cpu", dtype=F64)


GENERIC_METHODS = ["recompute", "testvalue", "testvalue_point_axis", "testvalue_many",
                   "gradient", "gradient_value", "gradient_laplacian", "updateinternals",
                   "pgradient"]


@pytest.mark.parametrize("method", GENERIC_METHODS)
@pytest.mark.parametrize("name", ["geminal", "gps"])
def test_generic_matches_jax(name, method):
    jwf, twf, jp, tp = generic(name)
    rng = np.random.default_rng(102)
    pos = walkers(rng, NCONF)
    if method == "pgradient":
        tg = twf.pgradient(tp, t64(pos))
        close(tg, jrun((name, method), jwf.pgradient, jp, jnp.asarray(pos)))
        if name == "gps":
            assert tg["f"].shape == (NCONF,) and tg["Xsupport"].shape == (NCONF, 3, 2, 3)
        return
    jst = jrun((name, "recompute"), jwf.recompute, jp, jnp.asarray(pos))
    tst = twf.recompute(tp, t64(pos))
    if method == "recompute":
        close(tst, jst)
        close(state_from_numpy(GenericJastrowState, jax.device_get(jst), device="cpu", dtype=F64),
              tst)
        return
    epos = pos[:, 2] + rng.normal(scale=0.5, size=(NCONF, 3))
    te, je = t64(epos), jnp.asarray(epos)
    if method == "testvalue_many":
        close(twf.testvalue_many(tp, tst, te),
              jrun((name, method), jwf.testvalue_many, jp, jst, je))
        return
    jfn = {"testvalue": jwf.testvalue, "testvalue_point_axis": jwf.testvalue,
           "gradient": jwf.gradient, "gradient_value": jwf.gradient_value,
           "gradient_laplacian": jwf.gradient_laplacian,
           "updateinternals": lambda p, s, e, x, m: jwf.updateinternals(
               p, s, e, x, m, jwf.testvalue(p, s, e, x)[1])}[method]
    tfn = {"testvalue": twf.testvalue, "testvalue_point_axis": twf.testvalue,
           "gradient": twf.gradient, "gradient_value": twf.gradient_value,
           "gradient_laplacian": twf.gradient_laplacian,
           "updateinternals": lambda p, s, e, x, m: twf.updateinternals(
               p, s, e, x, m, twf.testvalue(p, s, e, x)[1])}[method]
    mask = np.arange(NCONF) % 2 == 0
    for e in (0, 7):
        x = epos
        if method == "testvalue_point_axis":
            x = epos[:, None] + rng.normal(scale=0.3, size=(NCONF, 4, 3))
        extra_t = (torch.as_tensor(mask),) if method == "updateinternals" else ()
        extra_j = (jnp.asarray(mask),) if method == "updateinternals" else ()
        close(tfn(tp, tst, e, t64(x), *extra_t),
              jrun((name, method), jfn, jp, jst, jnp.int32(e), jnp.asarray(x), *extra_j))


def _configs(mol, seed, nconf=5):
    return initial_guess(mol, nconf, generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("name", ["geminal", "gps"])
def test_generic_run_all(name):
    (_, _), (tmol, _) = h2o_pair()
    _, twf, _, tp = generic(name)
    testwf.run_all(twf, tp, _configs(tmol, 103), torch.Generator().manual_seed(104))


# --- (b) the periodic geminal ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def h_cells():
    """tests/files/h_pbc_casscf.npz on both sides: (jax cell, port cell)."""
    from pyqmc_tpu_torch.system.mole import Cell

    from .fixtures_pbc import FILES, load_cell

    jcell, _ = load_cell("h_pbc_casscf")
    with np.load(f"{FILES}/h_pbc_casscf.npz") as z:
        tcell = Cell(list(zip([s.decode() for s in z["atom_symbols"]], z["atom_coords"])),
                     z["lattice"], basis=json.loads(bytes(z["basis_json"]).decode()),
                     spin=int(z["spin"]))
    return jcell, tcell


def test_geminal_periodic_matches_jax():
    jcell, tcell = h_cells()
    jwf, twf = JGeminal(jcell), GeminalJastrow(tcell)
    assert twf.spec.nao == jwf.spec.nao and twf.nao == jwf.nao
    rng = np.random.default_rng(105)
    g = rng.normal(scale=0.02, size=(jwf.nao, jwf.nao))
    jp, tp = {"gcoeff": jnp.asarray(g)}, {"gcoeff": t64(g)}
    X = rng.normal(size=(6, 3))
    f0 = twf.features(tp, t64(X))
    close(f0, jrun(("pbc", "features"), jwf.features, jp, jnp.asarray(X)))
    for a in np.asarray(tcell.lattice):  # periodic: chi(r + A) = chi(r)
        np.testing.assert_allclose(twf.features(tp, t64(X + a[None])).numpy(), f0.numpy(),
                                   rtol=1e-9, atol=1e-11)
    pos = rng.uniform(-0.3, 1.3, size=(4, 2, 3)) @ np.asarray(tcell.lattice)
    jst = jrun(("pbc", "recompute"), jwf.recompute, jp, jnp.asarray(pos))
    tst = twf.recompute(tp, t64(pos))
    close(tst, jst)
    # the derivatives of the folded, image-summed features against JAX's autodiff
    epos = X[:4] + np.asarray(tcell.lattice)[0]
    close(twf.gradient_laplacian(tp, tst, 1, t64(epos)),
          jrun(("pbc", "gradient_laplacian"), jwf.gradient_laplacian, jp, jst, jnp.int32(1),
               jnp.asarray(epos)))
    configs = Configs.create(t64(pos), Geometry(tcell.lattice))
    testwf.run_all(twf, tp, configs, torch.Generator().manual_seed(106))


# --- (c) AddWF ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def addwf_pair():
    """AddWF(ground determinant, single excitation 3 -> 4 of the up spin) of
    H2O on both sides, coeff (0.9, 0.35): (jax wf, port wf, jax params,
    port params)."""
    (jmol, jmf), (tmol, tmf) = h2o_pair()
    ca = np.asarray(jmf.mo_coeff[0])
    occ = (np.array([[0, 1, 2, 4]]), np.array([[0, 1, 2, 3]]))
    zero = np.zeros(1, dtype=np.int64)
    jex = JSlater(jmol, None, JExpansion(occ_up=occ[0], occ_dn=occ[1], map_up=zero, map_dn=zero),
                  (ca[:, :5], ca[:, :4]))
    tex = Slater(tmol, None, DeterminantExpansion(occ_up=occ[0], occ_dn=occ[1], map_up=zero,
                                                  map_dn=zero), (ca[:, :5], ca[:, :4]))
    jwf = JAddWF(JSlater.from_mean_field(jmf), jex)
    twf = AddWF(Slater.from_mean_field(tmf), tex)
    jp = jwf.make_params()
    jp["coeff"] = jnp.asarray([0.9, 0.35])
    return jwf, twf, jp, params_from_numpy(jax.device_get(jp), device="cpu", dtype=F64)


ADDWF_METHODS = ["value", "testvalue", "testvalue_point_axis", "testvalue_many",
                 "gradient_value", "gradient_current", "gradient_laplacian", "updateinternals",
                 "pgradient"]


@pytest.mark.parametrize("method", ADDWF_METHODS)
def test_addwf_matches_jax(method):
    jwf, twf, jp, tp = addwf_pair()
    rng = np.random.default_rng(107)
    pos = walkers(rng, NCONF)
    if method == "pgradient":
        tg = twf.pgradient(tp, t64(pos))
        close(tg, jrun(("add", method), jwf.pgradient, jp, jnp.asarray(pos)))
        assert tg["coeff"].shape == (NCONF, 2)
        return
    jst = jrun(("add", "recompute"), jwf.recompute, jp, jnp.asarray(pos))
    tst = twf.recompute(tp, t64(pos))
    if method == "value":
        close(twf.value(tp, tst), jrun(("add", method), jwf.value, jp, jst))
        return
    epos = pos[:, 1] + rng.normal(scale=0.5, size=(NCONF, 3))
    te, je = t64(epos), jnp.asarray(epos)
    if method == "testvalue_many":
        close(twf.testvalue_many(tp, tst, te),
              jrun(("add", method), jwf.testvalue_many, jp, jst, je))
        return
    jfn = {
        "testvalue": lambda p, s, e, x: jwf.testvalue(p, s, e, x)[0],
        "testvalue_point_axis": lambda p, s, e, x: jwf.testvalue(p, s, e, x)[0],
        "gradient_value": lambda p, s, e, x: jwf.gradient_value(p, s, e, x)[:2],
        "gradient_current": jwf.gradient_current,
        "gradient_laplacian": jwf.gradient_laplacian,
        "updateinternals": lambda p, s, e, x, m: jwf.value(p, jwf.updateinternals(
            p, s, e, x, m, jwf.gradient_value(p, s, e, x)[2])),
    }[method]
    tfn = {
        "testvalue": lambda p, s, e, x: twf.testvalue(p, s, e, x)[0],
        "testvalue_point_axis": lambda p, s, e, x: twf.testvalue(p, s, e, x)[0],
        "gradient_value": lambda p, s, e, x: twf.gradient_value(p, s, e, x)[:2],
        "gradient_current": twf.gradient_current,
        "gradient_laplacian": twf.gradient_laplacian,
        "updateinternals": lambda p, s, e, x, m: twf.value(p, twf.updateinternals(
            p, s, e, x, m, twf.gradient_value(p, s, e, x)[2])),
    }[method]
    mask = np.arange(NCONF) % 2 == 0
    for e in (1, 6):
        x = pos[:, e] if method == "gradient_current" else epos
        if method == "testvalue_point_axis":
            x = epos[:, None] + rng.normal(scale=0.3, size=(NCONF, 4, 3))
        extra_t = (torch.as_tensor(mask),) if method == "updateinternals" else ()
        extra_j = (jnp.asarray(mask),) if method == "updateinternals" else ()
        close(tfn(tp, tst, e, t64(x), *extra_t),
              jrun(("add", method), jfn, jp, jst, jnp.int32(e), jnp.asarray(x), *extra_j))


def test_addwf_contract():
    """The JAX package's AddWF checks (tests/unit/test_more_wfs.py:39-49)
    on the port."""
    (_, _), (tmol, _) = h2o_pair()
    _, twf, _, tp = addwf_pair()
    configs = _configs(tmol, 108, nconf=6)
    for i, check in enumerate((testwf.test_updateinternals, testwf.test_testvalue,
                               testwf.test_testvalue_many, testwf.test_gradient,
                               testwf.test_gradient_laplacian)):
        check(twf, tp, configs, torch.Generator().manual_seed(109 + i))


def test_addwf_refuses_a_modulus_ratio():
    _, twf, _, _ = addwf_pair()

    class Modulus:
        ratio_is_modulus = True
        nelec = 8

    with pytest.raises(ValueError, match="ratio_is_modulus"):
        AddWF(twf.wfs[0], Modulus())

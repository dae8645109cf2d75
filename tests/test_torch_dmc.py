"""The port's fixed-node DMC (method/dmc.py, ops/tmove_sweep.py and the dmc
mode of ops/move_sweep.py) against the JAX package, float64 on the CPU.

The JAX side runs its XLA path (make_dmc_block(fused=False)), as its own
CPU tests do. Its block draws its numbers from a key (method/dmc.py:227-254);
the tests redraw them with the same JAX calls and pass them to the port as
`streams`, so both sides run the same chain. Tolerances: positions 1e-9,
weights rtol 1e-9, block averages 1e-8 (energies sum kinetic terms of
O(10) Ha along a chain whose rounding grows through the inverse updates);
the small closed-form pieces 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method import dmc as jdmc
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.ecp import ECPAccumulator as JECP
from pyqmc_tpu.observables.ecp import random_rotations

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.convert import dmc_streams_from_numpy
from pyqmc_tpu_torch.entry import h2o_setup
from pyqmc_tpu_torch.method import dmc as tdmc
from pyqmc_tpu_torch.models.jastrow import JastrowSpin
from pyqmc_tpu_torch.models.multiply import MultiplyWF
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep
from pyqmc_tpu_torch.ops.tmove_sweep import FusedTmoveSweep, build_fused_tmove_sweep
from pyqmc_tpu_torch.utils.dtypes import NoCudaDeviceError

from .torch_parity import (F64, bc_pair, compile_quick, diamond_cells, gamma_params,
                           gamma_wf_objects, h2o_pair, h2o_params, h2o_wf_objects, jax_ecp_draws,
                           walkers)

TSTEP, NSTEPS, NCONF = 0.3, 2, 48


def t64(x):
    return torch.tensor(np.array(x), dtype=F64)


# --- the closed-form pieces ---------------------------------------------------

@pytest.mark.parametrize("tau", [0.02, 0.5])
def test_limdrift_umrigar(tau):
    g = np.random.default_rng(1).normal(scale=3.0, size=(7, 3))
    g[0] = 0.0  # the taueff floor
    np.testing.assert_allclose(tdmc.limdrift_umrigar(t64(g), tau).numpy(),
                               np.asarray(jdmc.limdrift_umrigar(jnp.asarray(g), tau)),
                               atol=1e-12, rtol=1e-12)


def test_compute_S():
    """compute_S is a closure inside the JAX make_dmc_block; its formula
    (method/dmc.py:206-214) is written out here with numpy."""
    rng = np.random.default_rng(2)
    eloc, grad2 = rng.normal(-17.0, 2.0, size=9), rng.uniform(5.0, 200.0, size=9)
    e_trial, e_est, esigma, tstep, nelec = -17.1, -17.0, 0.4, 0.02, 8
    cutoff = esigma * np.sqrt(2.0 / tstep)
    ref = e_trial - e_est + (np.clip(e_est - eloc, -cutoff, cutoff)
                             / np.sqrt(1.0 + (grad2 * tstep / nelec) ** 2))
    assert np.any(np.abs(e_est - eloc) > cutoff)  # the clip is taken
    for scalar in (float, t64):  # host floats and device scalars
        got = tdmc.compute_S(scalar(e_trial), scalar(e_est), scalar(esigma), t64(eloc),
                             t64(grad2), tstep, nelec)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=1e-12)


def test_popctrl_update_matches_jax():
    """Five updates of a 3-slot window: the ring wraps around."""
    feedback, ewin = 0.7, 3
    jup, tup = jdmc.make_popctrl_update(feedback, ewin), tdmc.make_popctrl_update(feedback, ewin)
    rng = np.random.default_rng(3)
    jring, jn = jnp.zeros(ewin).at[0].set(-17.0), jnp.asarray(1, jnp.int32)
    tring, tn = t64(np.asarray(jring)), torch.ones((), dtype=torch.int64)
    for eb, wavg in zip(rng.normal(-17.0, 0.1, size=5), rng.uniform(0.8, 1.2, size=5)):
        jring, jn, jtrial, jest = jup(jring, jn, jnp.asarray(eb), jnp.asarray(wavg))
        tring, tn, ttrial, test = tup(tring, tn, t64(eb), t64(wavg))
        np.testing.assert_allclose(tring.numpy(), np.asarray(jring), atol=1e-12)
        assert int(tn) == int(jn)
        assert float(ttrial) == pytest.approx(float(jtrial), abs=1e-12)
        assert float(test) == pytest.approx(float(jest), abs=1e-12)
    assert int(tn) == 6


@pytest.mark.parametrize("seed", [4, 5])
def test_branch_matches_jax(seed):
    """Same weights and the same comb uniform: the same walkers survive
    and every weight is reset to the mean."""
    rng = np.random.default_rng(seed)
    nconf = 12
    pos, wrap = rng.normal(size=(nconf, 8, 3)), rng.integers(-1, 2, size=(nconf, 8, 3))
    weights = rng.uniform(0.05, 3.0, size=nconf)
    key = jax.random.PRNGKey(seed)
    _, jbranch = _jax_block(True)
    p_j, r_j, w_j = jbranch(jnp.asarray(pos), jnp.asarray(wrap, jnp.int32), jnp.asarray(weights),
                            key)
    u_branch = t64(jax.random.uniform(key, ()))
    p_t, r_t, w_t = tdmc.branch(t64(pos), torch.as_tensor(wrap, dtype=torch.int32),
                                t64(weights), u_branch)
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-12)
    assert len(np.unique(np.asarray(p_j)[:, 0, 0])) < nconf  # a walker was duplicated


# --- the T-move quadrature ---------------------------------------------------

def _systems(name):
    """(jax mol, jax wf, jax params, port mol, port wf, port params)."""
    if name == "bc":
        return bc_pair()
    if name == "gamma":
        jcell, _, tcell = diamond_cells()
        jwf, twf = gamma_wf_objects()
        jp, tp = gamma_params(np.random.default_rng(6))
        return jcell, jwf, jp, tcell, twf, tp
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf = h2o_wf_objects()
    jp, tp = h2o_params(np.random.default_rng(6))
    return jmol, jwf, jp, tmol, twf, tp


@pytest.mark.parametrize("name", ["h2o", "bc", "gamma"])
def test_tmove_quadrature_matches_jax(name):
    """Points, weights w_q = -tau T_q and ratios r_q of every electron to
    1e-10. On B + C the two atoms have grids of 12 and 6 points, and the
    quadrature runs C's first: this fixes the category order that the
    shared u_sel stream selects from. On the gamma-point diamond primitive
    cell the quadrature is dense (12 points, no downselection) and each
    sphere sits on the nearest image of its atom; walkers near the origin
    lie partly outside the cell."""
    jmol, jwf, jp, tmol, twf, tp = _systems(name)
    rng = np.random.default_rng(7)
    nconf, tau = 3, 0.05
    pos = walkers(rng, nconf, nelec=jwf.nelec, scale=0.8)  # electrons inside the cores
    jacc, tacc = JECP(jmol, fused=False), ECPAccumulator(tmol)
    assert tacc.active and tacc.atom_naip == list(jacc.atom_naip)
    assert tacc.nselect is None and jacc.nselect is None  # dense
    jpos = jnp.asarray(pos)
    jstate = compile_quick(jax.jit(jwf.recompute), jp, jpos)(jp, jpos)
    keys = [jax.random.fold_in(jax.random.PRNGKey(8), e) for e in range(jwf.nelec)]
    jquad = compile_quick(jax.jit(lambda state, e, key: jacc.tmove_quadrature(
        jwf, jp, state, jpos, e, key, tau)), jstate, jnp.int32(0), keys[0])
    tstate = twf.recompute(tp, t64(pos))
    wmax = 0.0
    for e in range(jwf.nelec):
        key = keys[e]
        aux_j, w_j, r_j = jquad(jstate, jnp.int32(e), key)
        rot = t64(random_rotations(key, (nconf,)))
        aux_t, w_t, r_t = tacc.tmove_quadrature(twf, tp, tstate, t64(pos), e, rot, tau)
        assert aux_t.shape == (nconf, sum(tacc.atom_naip), 3)
        for a, b in ((aux_t, aux_j), (w_t, w_j), (r_t, r_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=1e-10)
        wmax = max(wmax, float(torch.max(torch.abs(w_t))))
    assert wmax > 1e-3  # some electron feels a nonlocal channel


# --- one whole block -----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_block(tmoves):
    """The JAX (block, branch) of H2O on its XLA path, built once per process."""
    (jmol, _), _ = h2o_pair()
    jwf, _ = h2o_wf_objects()
    return jdmc.make_dmc_block(jwf, JEnergy(jmol), JGeometry(None), TSTEP, NSTEPS,
                               tmoves=tmoves, fused=False)


def jax_dmc_streams(key, nelec, nconf, tmoves, dtype=jnp.float64):
    """The draws of method/dmc.py's block (:220-250), as numpy."""
    return {k: np.asarray(v) for k, v in _jax_dmc_draws(key, nelec, nconf, tmoves, dtype).items()}


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _jax_dmc_draws(key, nelec, nconf, tmoves, dtype):
    kg, ku, kt, ke, _ = jax.random.split(key, 5)

    def rotations(k):  # the energy's: one per electron from fold_in(k, 1000 + e)
        return jax_ecp_draws(k, nelec, nconf)[0]

    streams = {
        "gauss": jax.random.normal(kg, (NSTEPS, nelec, nconf, 3), dtype) * jnp.sqrt(TSTEP),
        "unif": jax.random.uniform(ku, (NSTEPS, nelec, nconf), dtype),
        "erot": jax.vmap(rotations)(jax.random.split(ke, NSTEPS)),
        "erot0": rotations(jax.random.fold_in(key, 999)),
    }
    if tmoves:
        kt1, kt2, kt3 = jax.random.split(kt, 3)
        tqkeys = jax.random.split(kt1, NSTEPS * nelec).reshape((NSTEPS, nelec) + kt1.shape)
        streams["tqrot"] = jax.vmap(jax.vmap(lambda k: random_rotations(k, (nconf,))))(tqkeys)
        streams["u_sel"] = jax.random.uniform(kt2, (NSTEPS, nelec, nconf), dtype)
        streams["u_acc"] = jax.random.uniform(kt3, (NSTEPS, nelec, nconf), dtype)
    return streams


@pytest.mark.parametrize("tmoves", [True, False])
def test_dmc_block_matches_jax(tmoves):
    """tmoves=False isolates the dmc-mode sweep (Umrigar drift, fixed node,
    r2p/r2a); tmoves=True puts the T-move sweep before it."""
    rng = np.random.default_rng(9)
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf = h2o_wf_objects()
    jp, tp = h2o_params(rng)
    pos = walkers(rng, NCONF, scale=0.7)  # electrons inside the O core: T-moves happen
    weights = rng.uniform(0.8, 1.2, size=NCONF)
    e_trial, e_est, esigma = -17.05, -17.0, 0.5
    key = jax.random.PRNGKey(10)
    jblock, _ = _jax_block(tmoves)
    p_j, _, w_j, avg_j = jblock(jp, jnp.array(pos), jnp.zeros((NCONF, 8, 3), jnp.int32),
                                jnp.asarray(weights), key, jnp.float64(e_trial),
                                jnp.float64(e_est), jnp.float64(esigma))

    streams = dmc_streams_from_numpy(jax_dmc_streams(key, 8, NCONF, tmoves), device="cpu",
                                     dtype=F64)
    block, _ = tdmc.make_dmc_block(twf, EnergyAccumulator(tmol), Geometry(), TSTEP, NSTEPS,
                                   tmoves=tmoves)
    tpos = t64(pos)
    p_t, _, w_t, avg_t = block(tp, tpos, torch.zeros((NCONF, 8, 3), dtype=torch.int32),
                               t64(weights), None, t64(e_trial), t64(e_est), t64(esigma),
                               streams=streams)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-9)
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        np.testing.assert_allclose(float(avg_t[k]), float(avg_j[k]), atol=1e-8, rtol=1e-8,
                                   err_msg=k)
    # a move was rejected, so r2a < r2p and the effective time step is taken
    assert float(avg_t["acceptance"]) < 1.0
    assert torch.equal(tpos, t64(pos))  # inputs untouched
    if tmoves:
        # the T-move sweep moved some electron: without it the chain differs
        p_n = tdmc.make_dmc_block(twf, EnergyAccumulator(tmol), Geometry(), TSTEP, NSTEPS,
                                  tmoves=False)[0](
            tp, tpos, torch.zeros((NCONF, 8, 3), dtype=torch.int32), t64(weights), None,
            t64(e_trial), t64(e_est), t64(esigma), streams=streams)[0]
        differ = torch.any(torch.abs(p_n - p_t) > 1e-3, dim=-1)
        # enough T-moves that a fault in the reverse amplitudes flips one
        assert int(torch.sum(torch.any(differ, dim=1))) >= 8


def test_dmc_sweep_fixed_node_and_r2():
    """The dmc-mode plain sweep on its own: a walker started across the
    node of its first move is rejected there (ratio <= 0) whatever the
    uniform, r2p counts every proposal and r2a only the accepted ones."""
    rng = np.random.default_rng(11)
    _, twf = h2o_wf_objects()
    _, tp = h2o_params(rng)
    nconf = 64
    pos = t64(walkers(rng, nconf))
    wrap = torch.zeros((nconf, 8, 3), dtype=torch.int32)
    st = twf.recompute(tp, pos)
    gauss = t64(rng.normal(size=(8, nconf, 3)) * 1.2)  # long moves: some cross the node
    unif = torch.zeros((8, nconf), dtype=F64)  # accept whatever the node allows
    sweep = build_fused_sweep(twf, Geometry(), 0.3, mode="dmc")
    p2, _, st2, (acc, r2p, r2a) = sweep(tp, pos, wrap, st, gauss, unif)
    moved = torch.any(p2 != pos, dim=-1)  # (nconf, nelec)
    assert 0 < int(torch.sum(~moved))  # only the node rejects when unif = 0
    assert float(acc) == pytest.approx(float(torch.sum(moved)) / nconf, abs=1e-12)
    assert bool(torch.all(r2a <= r2p)) and bool(torch.any(r2a < r2p))
    full = torch.all(moved, dim=1)
    np.testing.assert_allclose(r2a[full].numpy(), r2p[full].numpy(), rtol=1e-12)
    # the sign of the wavefunction never changes under fixed-node moves
    ph0, ph2 = twf.value(tp, st)[0], twf.value(tp, st2)[0]
    assert torch.equal(ph0, ph2)
    with pytest.raises(ValueError):
        build_fused_sweep(twf, Geometry(), 0.3, mode="rmc")


# --- gates ---------------------------------------------------------------------

def test_tmove_gate():
    """build_fused_tmove_sweep follows the JAX gate: the _match_sj pattern,
    an ECP with nonlocal channels, and nelec * (nq + 2) <= 2 * max_aux_evals."""
    (_, _), (tmol, tmf) = h2o_pair()
    _, twf = h2o_wf_objects()
    acc = ECPAccumulator(tmol)
    assert isinstance(build_fused_tmove_sweep(twf, Geometry(), acc, 0.02), FusedTmoveSweep)
    assert build_fused_tmove_sweep(twf, Geometry(), None, 0.02) is None
    # 8 electrons x (6 + 2) = 64 evaluations: inside 2 * 32, outside 2 * 31
    assert build_fused_tmove_sweep(twf, Geometry(), acc, 0.02, max_aux_evals=32) is not None
    assert build_fused_tmove_sweep(twf, Geometry(), acc, 0.02, max_aux_evals=31) is None
    assert build_fused_tmove_sweep(JastrowSpin(tmol), Geometry(), acc, 0.02) is None
    wide = Slater(tmol, None, DeterminantExpansion.single(4, 4),
                  (tmf.mo_coeff[0][:, :6], tmf.mo_coeff[1][:, :4]))
    assert build_fused_sweep(MultiplyWF(wide, JastrowSpin(tmol)), Geometry(), 0.02,
                             mode="dmc") is None
    assert build_fused_tmove_sweep(MultiplyWF(wide, JastrowSpin(tmol)), Geometry(), acc,
                                   0.02) is None
    # an ECP without nonlocal channels is not active: no T-moves at all
    local_only = ECPAccumulator(tmol)
    local_only.nl_atoms = []
    assert not local_only.active
    assert build_fused_tmove_sweep(twf, Geometry(), local_only, 0.02) is None


# --- rundmc ----------------------------------------------------------------------

def test_rundmc_on_cpu():
    """rundmc through the entry point, on the CPU with the plain versions."""
    mol, wf, params, configs, acc = h2o_setup(6, device="cpu")
    blocks, final, weights = tdmc.rundmc(
        wf, params, configs, nblocks=2, nsteps_per_block=2, tstep=0.02,
        energy_acc=acc["energy"], generator=torch.Generator().manual_seed(12),
        warmup_vmc_blocks=1)
    assert [b["block"] for b in blocks] == [0, 1]
    for b in blocks:
        for k in ("energytotal", "energyke", "energyecp", "weight", "e_trial", "e_est",
                  "acceptance", "block time"):
            assert np.isfinite(b[k]), k
        assert b["weight"] > 0 and 0 < b["acceptance"] <= 1
    assert final.positions.shape == (6, 8, 3) and final.positions.device.type == "cpu"
    assert weights.shape == (6,) and bool(torch.all(weights > 0))
    assert not torch.equal(final.positions, configs.positions)
    with pytest.raises(ValueError):
        tdmc.rundmc(wf, params, configs, nblocks=1)  # energy_acc is required


def test_default_device_is_the_gpu():
    """Entry points take the GPU unless told otherwise: without one the
    default raises a named error and does not fall back to the CPU."""
    _, twf = h2o_wf_objects()
    if torch.cuda.is_available():
        assert h2o_setup(4)[3].positions.device.type == "cuda"
        assert twf.make_params()["wf1"]["bcoeff"].dtype == torch.float32
    else:
        with pytest.raises(NoCudaDeviceError):
            h2o_setup(4)
        with pytest.raises(NoCudaDeviceError):
            twf.make_params()
    mol, wf, params, configs, acc = h2o_setup(4, device="cpu")
    assert configs.positions.device.type == "cpu" and configs.positions.dtype == F64

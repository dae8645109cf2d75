"""The port's periodic DMC path against the JAX package, float64, shared
streams, on the diamond-C gamma-point primitive cell (8 electrons, 489
replicated-shell AOs), 5 walkers.

- The plain periodic dmc sweep (ops/move_sweep.py:sweep_plain with mode
  "dmc" and the periodic Geometry.enforce, what K7's dmc-mode wrapper runs
  for CPU tensors) against a literal copy of method/dmc.py's drift-diffusion
  sweep: positions, wrap counts, every state leaf, the acceptance, r2p and
  r2a to 1e-9. The proposals are drawn long, so that some wrap and some
  cross a node.
- One whole DMC block with T-moves and the ECP downselected to 8 of 12
  points for the energy, against make_dmc_block(fused=False): positions,
  wraps, weights and every block average to 1e-9. The JAX block draws from
  a key; the test redraws its numbers with the same JAX calls and passes
  them as `streams`, the energy's selection uniforms as esel0 and esel.
  Both JAX functions run once and are compiled with XLA's backend
  optimisation off (torch_parity.compile_quick), which halves the time.
- draw_dmc_streams draws esel and esel0 only for a downselecting ECP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method import dmc as jdmc
from pyqmc_tpu.models.multiply import default_move_begin, default_move_finish
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.ecp import ECPAccumulator as JECP
from pyqmc_tpu.observables.ecp import random_rotations

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.convert import (dmc_streams_from_numpy, slater_state_from_numpy,
                                     state_from_numpy, wrap_from_numpy)
from pyqmc_tpu_torch.method import dmc as tdmc
from pyqmc_tpu_torch.models.jastrow import JastrowState
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep, sweep_plain

from .torch_parity import (F64, assert_trees_close, cell_walkers, compile_quick, diamond_cells,
                           gamma_params, gamma_wf_objects, jax_ecp_draws)

TSTEP, NSTEPS, NCONF, NELEC = 0.02, 1, 5, 8


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _jax_dmc_sweep():
    """A literal copy of method/dmc.py's drift-diffusion sweep on the
    periodic geometry (as tests/unit/test_move_pallas_pbc.py has it), after
    the recompute of its starting state, jitted: returns (starting state,
    positions, wrap, state, (acc, r2p, r2a))."""
    jwf, _ = gamma_wf_objects()
    jcell, _, _ = diamond_cells()
    geometry = JGeometry(jcell.lattice)

    def sweep(params, positions, wrap, gauss_step, unif_step):
        state0 = jwf.recompute(params, positions)

        def ebody(e, carry):
            positions, wrap, state, (acc, r2p, r2a) = carry
            epos = positions[:, e, :]
            grad_old, aux = default_move_begin(jwf, params, state, e, epos)
            drift_old = jdmc.limdrift_umrigar(grad_old, TSTEP)
            gauss = gauss_step[e]
            newpos, wrapdelta = geometry.enforce(epos + gauss + TSTEP * drift_old)
            grad_new, ratio, saved = default_move_finish(jwf, params, state, e, newpos, aux)
            drift_new = jdmc.limdrift_umrigar(grad_new, TSTEP)
            forward = jnp.sum(gauss * gauss, axis=-1)
            backward = jnp.sum((gauss + TSTEP * (drift_old + drift_new)) ** 2, axis=-1)
            accept_prob = jnp.abs(ratio) ** 2 * jnp.exp((forward - backward) / (2.0 * TSTEP))
            accept_prob = jnp.where(ratio <= 0, 0.0, accept_prob)
            accept = accept_prob > unif_step[e]
            state = jwf.updateinternals(params, state, e, newpos, accept, saved)
            positions = positions.at[:, e, :].set(jnp.where(accept[:, None], newpos, epos))
            wrap = wrap.at[:, e, :].set(jnp.where(accept[:, None], wrap[:, e, :] + wrapdelta,
                                                  wrap[:, e, :]))
            r2 = jnp.sum((gauss + TSTEP * drift_old) ** 2, axis=-1)
            return positions, wrap, state, (acc + jnp.mean(accept.astype(positions.dtype)),
                                            r2p + r2, r2a + jnp.where(accept, r2, 0.0))

        z = jnp.zeros(positions.shape[0])
        return (state0,) + jax.lax.fori_loop(0, NELEC, ebody,
                                             (positions, wrap, state0, (jnp.zeros(()), z, z)))

    return jax.jit(sweep)


def test_pbc_dmc_sweep_matches_jax():
    jwf, twf = gamma_wf_objects()
    jcell, _, tcell = diamond_cells()
    rng = np.random.default_rng(31)
    jp, tp = gamma_params(rng)
    pos = cell_walkers(rng, jcell.lattice, NCONF, lo=0.0, hi=1.0)
    # long proposals (about 0.7 bohr): some cross the cell, some a node
    gauss = rng.normal(scale=5 * np.sqrt(TSTEP), size=(NELEC, NCONF, 3))
    unif = rng.uniform(size=(NELEC, NCONF))
    unif[:, :2] = 0.0  # walkers 0 and 1 take every move that the node allows
    wrap0 = rng.integers(-2, 3, size=(NCONF, NELEC, 3)).astype(np.int32)
    jargs = (jp, jnp.asarray(pos), jnp.asarray(wrap0), jnp.asarray(gauss), jnp.asarray(unif))
    js, pj, wj, sj, (aj, r2pj, r2aj) = compile_quick(_jax_dmc_sweep(), *jargs)(*jargs)
    tpos = t64(pos)
    jnp_s = jax.device_get(js)
    ts = (slater_state_from_numpy(jnp_s[0], device="cpu", dtype=F64),
          state_from_numpy(JastrowState, jnp_s[1], device="cpu", dtype=F64))
    twrap = wrap_from_numpy(wrap0, device="cpu")
    out = sweep_plain(twf, Geometry(tcell.lattice), TSTEP, 1.0, tp, tpos, twrap, ts, t64(gauss),
                      t64(unif), mode="dmc")
    pt, wt, st, (at, r2pt, r2at) = out
    assert float(at) == pytest.approx(float(aj), abs=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-9)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert_trees_close(st, sj, atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(r2pt.numpy(), np.asarray(r2pj), atol=1e-9)
    np.testing.assert_allclose(r2at.numpy(), np.asarray(r2aj), atol=1e-9)
    moved = torch.any(pt != tpos, dim=-1)  # (nconf, nelec)
    assert not np.array_equal(wt.numpy(), wrap0)  # some accepted moves crossed the cell
    assert 0 < int(torch.sum(~moved[:2]))  # with unif = 0 only the node rejects
    assert bool(torch.all(r2at <= r2pt)) and bool(torch.any(r2at < r2pt))
    # K7's dmc-mode wrapper runs exactly this plain sweep for CPU tensors
    fused = build_fused_sweep(twf, Geometry(tcell.lattice), TSTEP, mode="dmc")
    assert type(fused).__name__ == "FusedSweepPBC" and fused.mode == "dmc"
    pf, wf_, sf, (af, r2pf, r2af) = fused(tp, tpos, twrap, ts, t64(gauss), t64(unif))
    assert torch.equal(pf, pt) and torch.equal(wf_, wt) and float(af) == float(at)
    assert torch.equal(r2pf, r2pt) and torch.equal(r2af, r2at)
    assert_trees_close(sf, st, atol=0.0)


def _jax_block():
    """The JAX periodic DMC block (XLA path, T-moves, downselected ECP)."""
    jwf, _ = gamma_wf_objects()
    jcell, _, _ = diamond_cells()
    energy = JEnergy(jcell, ecp_acc=JECP(jcell, nselect=8))
    block, _ = jdmc.make_dmc_block(jwf, energy, JGeometry(jcell.lattice), TSTEP, NSTEPS,
                                   tmoves=True, fused=False)
    return block


def jax_pbc_dmc_streams(key):
    """The draws of method/dmc.py's block (:220-250) with a downselecting
    ECP, as numpy: the energies' rotations and selection uniforms come from
    the ECP's own draws of fold_in(key, 999) (the block's first energy) and
    of each step's energy key. One jitted call, run once."""
    draws = compile_quick(jax.jit(_jax_pbc_dmc_draws), key)(key)
    return {k: np.asarray(v) for k, v in draws.items()}


def _jax_pbc_dmc_draws(key):
    kg, ku, kt, ke, _ = jax.random.split(key, 5)
    ekeys = jax.random.split(ke, NSTEPS)
    kt1, kt2, kt3 = jax.random.split(kt, 3)
    tqkeys = jax.random.split(kt1, NSTEPS * NELEC).reshape((NSTEPS, NELEC) + kt1.shape)
    erot0, esel0 = jax_ecp_draws(jax.random.fold_in(key, 999), NELEC, NCONF)
    erot, esel = jax.vmap(lambda k: jax_ecp_draws(k, NELEC, NCONF))(ekeys)
    return {
        "gauss": jax.random.normal(kg, (NSTEPS, NELEC, NCONF, 3), jnp.float64) * jnp.sqrt(TSTEP),
        "unif": jax.random.uniform(ku, (NSTEPS, NELEC, NCONF), jnp.float64),
        "erot": erot, "esel": esel, "erot0": erot0, "esel0": esel0,
        "tqrot": jax.vmap(jax.vmap(lambda k: random_rotations(k, (NCONF,))))(tqkeys),
        "u_sel": jax.random.uniform(kt2, (NSTEPS, NELEC, NCONF), jnp.float64),
        "u_acc": jax.random.uniform(kt3, (NSTEPS, NELEC, NCONF), jnp.float64),
    }


def test_pbc_dmc_block_matches_jax():
    jwf, twf = gamma_wf_objects()
    jcell, _, tcell = diamond_cells()
    rng = np.random.default_rng(32)
    jp, tp = gamma_params(rng)
    pos = cell_walkers(rng, jcell.lattice, NCONF, lo=0.0, hi=1.0)
    weights = rng.uniform(0.8, 1.2, size=NCONF)
    e_trial, e_est, esigma = -10.3, -10.2, 0.5
    key = jax.random.PRNGKey(33)
    zeros = np.zeros((NCONF, NELEC, 3), np.int32)
    jargs = (jp, jnp.asarray(pos), jnp.asarray(zeros), jnp.asarray(weights), key,
             jnp.float64(e_trial), jnp.float64(e_est), jnp.float64(esigma))
    p_j, w_j, wt_j, avg_j = compile_quick(_jax_block(), *jargs)(*jargs)
    streams = dmc_streams_from_numpy(jax_pbc_dmc_streams(key), device="cpu", dtype=F64)
    ecp = ECPAccumulator(tcell, nselect=8)
    block, _ = tdmc.make_dmc_block(twf, EnergyAccumulator(tcell, ecp_acc=ecp),
                                   Geometry(tcell.lattice), TSTEP, NSTEPS)
    p_t, w_t, wt_t, avg_t = block(tp, t64(pos), torch.as_tensor(zeros), t64(weights), None,
                                  t64(e_trial), t64(e_est), t64(esigma), streams=streams)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    np.testing.assert_allclose(wt_t.numpy(), np.asarray(wt_j), rtol=1e-9)
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        np.testing.assert_allclose(float(avg_t[k]), float(avg_j[k]), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    assert abs(float(avg_t["energyecp"])) > 1e-3
    # some T-move was taken: without the T-move sweep the chain differs
    p_n = tdmc.make_dmc_block(twf, EnergyAccumulator(tcell, ecp_acc=ecp),
                              Geometry(tcell.lattice), TSTEP, NSTEPS, tmoves=False)[0](
        tp, t64(pos), torch.as_tensor(zeros), t64(weights), None, t64(e_trial), t64(e_est),
        t64(esigma), streams=streams)[0]
    assert bool(torch.any(torch.abs(p_n - p_t) > 1e-3))


def test_dmc_streams_draw_esel_only_for_a_downselected_ecp():
    """The energy's selection uniforms are drawn last and only where an
    ECP downselects: the H2O streams keep their keys and values, and the
    T-moves' u_sel is a stream of its own."""
    from pyqmc_tpu_torch.method.vmc import downselects

    from .torch_parity import h2o_pair

    _, (tmol, _) = h2o_pair()
    _, _, tcell = diamond_cells()
    assert not downselects({"energy": EnergyAccumulator(tmol)})
    assert downselects({"energy": EnergyAccumulator(tcell, ecp_acc=ECPAccumulator(tcell,
                                                                                 nselect=8))})

    def draw(downselect):
        gen = torch.Generator().manual_seed(5)
        return tdmc.draw_dmc_streams(gen, 2, 8, 3, 0.02, "cpu", F64, downselect=downselect)

    plain, sel = draw(False), draw(True)
    assert set(plain) == {"gauss", "unif", "erot", "erot0", "tqrot", "u_sel", "u_acc"}
    assert set(sel) == set(plain) | {"esel", "esel0"}
    for k in plain:
        assert torch.equal(plain[k], sel[k]), k
    assert sel["esel"].shape == (2, 8, 3) and sel["esel0"].shape == (8, 3)
    assert not torch.equal(sel["esel"], sel["u_sel"])

"""The port's periodic VMC path against the JAX package, float64, shared
streams: the diamond-C gamma-point primitive cell (8 electrons, 489
replicated-shell AOs), 5 walkers, tstep 0.5.

- The plain periodic sweep (ops/move_sweep.py:sweep_plain with the
  periodic Geometry.enforce, what K7's wrapper runs for CPU tensors)
  against a copy of method/vmc.py's sweep: positions, wrap counts, every
  state leaf and the acceptance to 1e-9.
- One whole 2-step block against make_vmc_block(fused=False), with Ewald
  energies and the downselected ECP (nselect=8): positions, wraps and every
  block average to 1e-9. The JAX block draws from a key; the test redraws
  its numbers with the same JAX calls and passes them as `streams`.
- diamond_setup and vmc() at the 2x2x2 supercell on the CPU, and K7's
  host half (its gate, its tables, its dmc mode's own launch counter).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method.vmc import limdrift as j_limdrift
from pyqmc_tpu.method.vmc import make_vmc_block as j_make_vmc_block
from pyqmc_tpu.models.multiply import default_move_begin, default_move_finish
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.ecp import ECPAccumulator as JECP

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.convert import (slater_state_from_numpy, state_from_numpy,
                                     wrap_from_numpy)
from pyqmc_tpu_torch.method.vmc import make_vmc_block, vmc
from pyqmc_tpu_torch.models.jastrow import JastrowState
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
from pyqmc_tpu_torch.ops.move_sweep import build_fused_sweep, sweep_plain

from .torch_parity import (F64, assert_trees_close, cell_walkers, diamond_cells, gamma_params,
                           gamma_jax_recompute, gamma_wf_objects, jax_ecp_streams)

TSTEP, NSTEPS, NCONF, NELEC = 0.5, 2, 5, 8


@functools.lru_cache(maxsize=None)
def _jax_sweep():
    """method/vmc.py's sweep on the periodic geometry, jitted once."""
    jwf, _ = gamma_wf_objects()
    jcell, _, _ = diamond_cells()
    geometry = JGeometry(jcell.lattice)

    def sweep(params, positions, wrap, state, gauss_step, unif_step):
        def ebody(e, carry):
            positions, wrap, state, acc = carry
            epos = positions[:, e, :]
            grad_old, aux = default_move_begin(jwf, params, state, e, epos)
            drift_old = j_limdrift(grad_old)
            gauss = gauss_step[e]
            newpos, wrapdelta = geometry.enforce(epos + gauss + TSTEP * drift_old)
            grad_new, ratio, saved = default_move_finish(jwf, params, state, e, newpos, aux)
            drift_new = j_limdrift(grad_new)
            forward = jnp.sum(gauss * gauss, axis=-1)
            backward = jnp.sum((gauss + TSTEP * (drift_old + drift_new)) ** 2, axis=-1)
            accept = jnp.abs(ratio) ** 2 * jnp.exp((forward - backward) / (2.0 * TSTEP)) > unif_step[e]
            state = jwf.updateinternals(params, state, e, newpos, accept, saved)
            positions = positions.at[:, e, :].set(jnp.where(accept[:, None], newpos, epos))
            wrap = wrap.at[:, e, :].set(jnp.where(accept[:, None], wrap[:, e, :] + wrapdelta,
                                                  wrap[:, e, :]))
            return positions, wrap, state, acc + jnp.mean(accept.astype(positions.dtype))

        return jax.lax.fori_loop(0, NELEC, ebody, (positions, wrap, state, jnp.zeros(())))

    return jax.jit(sweep)


def test_plain_sweep_matches_jax():
    jwf, twf = gamma_wf_objects()
    jcell, _, tcell = diamond_cells()
    rng = np.random.default_rng(21)
    jp, tp = gamma_params(rng)
    pos = cell_walkers(rng, jcell.lattice, NCONF, lo=0.0, hi=1.0)
    gauss = rng.normal(scale=np.sqrt(TSTEP), size=(NELEC, NCONF, 3))
    unif = rng.uniform(size=(NELEC, NCONF))
    wrap0 = rng.integers(-2, 3, size=(NCONF, NELEC, 3)).astype(np.int32)
    js = gamma_jax_recompute()(jp, jnp.asarray(pos))
    pj, wj, sj, aj = _jax_sweep()(jp, jnp.asarray(pos), jnp.asarray(wrap0), js, jnp.asarray(gauss),
                                  jnp.asarray(unif))
    tpos = torch.as_tensor(pos, dtype=F64)
    # the JAX state and wrap counts carried over by the converters
    jnp_s = jax.device_get(js)
    ts = (slater_state_from_numpy(jnp_s[0], device="cpu", dtype=F64),
          state_from_numpy(JastrowState, jnp_s[1], device="cpu", dtype=F64))
    assert_trees_close(ts, twf.recompute(tp, tpos), atol=1e-9, rtol=1e-9)
    twrap = wrap_from_numpy(wrap0, device="cpu")
    pt, wt, st, at = sweep_plain(twf, Geometry(tcell.lattice), TSTEP, 1.0, tp, tpos, twrap, ts,
                                 torch.as_tensor(gauss, dtype=F64),
                                 torch.as_tensor(unif, dtype=F64))
    assert 0 < float(at) < NELEC and float(at) == pytest.approx(float(aj), abs=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-9)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    assert not np.array_equal(wt.numpy(), wrap0)  # some proposals crossed the cell
    assert_trees_close(st, sj, atol=1e-9, rtol=1e-9)
    # K7's wrapper runs exactly this plain sweep for CPU tensors
    fused = build_fused_sweep(twf, Geometry(tcell.lattice), TSTEP)
    assert type(fused).__name__ == "FusedSweepPBC"
    pf, wf_, sf, af = fused(tp, tpos, twrap, ts, torch.as_tensor(gauss, dtype=F64),
                            torch.as_tensor(unif, dtype=F64))
    assert torch.equal(pf, pt) and torch.equal(wf_, wt) and float(af) == float(at)


def jax_block_streams(key, nconf):
    """The draws of method/vmc.py's block for one accumulator, as numpy:
    gauss, unif, and per step the ECP rotations and selection uniforms."""
    kg, ku, ka = jax.random.split(key, 3)
    gauss = jax.random.normal(kg, (NSTEPS, NELEC, nconf, 3), jnp.float64) * jnp.sqrt(TSTEP)
    unif = jax.random.uniform(ku, (NSTEPS, NELEC, nconf), jnp.float64)
    ecp = [jax_ecp_streams(k, NELEC, nconf) for k in jax.random.split(ka, NSTEPS)]
    return {"gauss": np.array(gauss), "unif": np.array(unif),
            "rot": np.stack([r for r, _ in ecp]), "u_sel": np.stack([u for _, u in ecp])}


def test_vmc_block_matches_jax():
    jwf, twf = gamma_wf_objects()
    jcell, _, tcell = diamond_cells()
    rng = np.random.default_rng(22)
    jp, tp = gamma_params(rng)
    pos = cell_walkers(rng, jcell.lattice, NCONF, lo=0.0, hi=1.0)
    key = jax.random.PRNGKey(23)
    jacc = {"energy": JEnergy(jcell, ecp_acc=JECP(jcell, nselect=8))}
    jblock = j_make_vmc_block(jwf, jacc, JGeometry(jcell.lattice), tstep=TSTEP, nsteps=NSTEPS,
                              fused=False)
    p_j, w_j, avg_j = jblock(jp, jnp.asarray(pos), jnp.zeros((NCONF, NELEC, 3), jnp.int32), key)
    streams = {k: torch.tensor(v, dtype=F64) for k, v in jax_block_streams(key, NCONF).items()}
    tacc = {"energy": EnergyAccumulator(tcell, ecp_acc=ECPAccumulator(tcell, nselect=8))}
    block = make_vmc_block(twf, tacc, Geometry(tcell.lattice), tstep=TSTEP, nsteps=NSTEPS)
    p_t, w_t, avg_t = block(tp, torch.as_tensor(pos, dtype=F64),
                            torch.zeros((NCONF, NELEC, 3), dtype=torch.int32), None, streams)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        np.testing.assert_allclose(float(avg_t[k]), float(avg_j[k]), atol=1e-9, rtol=1e-9,
                                   err_msg=k)
    assert abs(float(avg_t["energyecp"])) > 1e-3


def test_diamond_setup_and_vmc_on_cpu():
    """diamond_setup at the 2x2x2 supercell (64 electrons, 16 atoms) and one
    vmc() block on the CPU; K7's gate and host tables for it; the default
    device is the GPU."""
    from pyqmc_tpu_torch.entry import diamond_setup
    from pyqmc_tpu_torch.ops import move_sweep_pbc
    from pyqmc_tpu_torch.ops.gto_kernels import GTOTables
    from pyqmc_tpu_torch.ops.move_sweep_pbc import P_I_KORB, P_NAO, P_NELEC, PBCTables
    from pyqmc_tpu_torch.utils.dtypes import NoCudaDeviceError

    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDeviceError):
            diamond_setup(2)
    sup, wf, params, configs, acc = diamond_setup(3, device="cpu")
    assert sup.nelec == (32, 32) and sup.natom == 16 and configs.positions.shape == (3, 64, 3)
    orb = wf.wfs[0].orbitals
    assert orb._repl_spec.nao == 489 and len(orb.images) == 47 and orb.nk == 8
    ecp = acc["energy"].ecp_acc
    assert ecp.nq_total == 96 and ecp.nselect == 24 and ecp._mic_fast
    fused = build_fused_sweep(wf, configs.geometry, TSTEP)
    dmc = build_fused_sweep(wf, configs.geometry, 0.02, mode="dmc")
    assert type(fused).__name__ == "FusedSweepPBC" and dmc.mode == "dmc"
    # K7's dmc mode has a launch counter of its own; for CPU tensors the
    # wrapper runs the plain dmc sweep and launches nothing
    assert move_sweep_pbc.DMC_LAUNCHES is not move_sweep_pbc.LAUNCHES
    n0 = (move_sweep_pbc.LAUNCHES.n, move_sweep_pbc.DMC_LAUNCHES.n)
    gen = torch.Generator().manual_seed(4)
    gauss = torch.randn((64, 3, 3), generator=gen, dtype=F64) * 0.1
    state = wf.recompute(params, configs.positions)
    p1, _, _, (_, r2p, r2a) = dmc(params, configs.positions, configs.wrap, state, gauss,
                                  torch.rand((64, 3), generator=gen, dtype=F64))
    assert (move_sweep_pbc.LAUNCHES.n, move_sweep_pbc.DMC_LAUNCHES.n) == n0
    assert p1.shape == (3, 64, 3) and r2p.shape == (3,) and bool(torch.all(r2a <= r2p))
    tables = PBCTables(configs.geometry, wf.wfs[0], wf.wfs[1], orb)
    assert tables.unsupported is None
    assert (tables._meta[P_NELEC], tables._meta[P_NAO]) == (64, 489)
    np.testing.assert_array_equal(tables._meta[tables._meta[P_I_KORB]:][:64], orb._korb)
    g = GTOTables(orb._repl_spec)
    np.testing.assert_array_equal(g._meta[g._meta[3]:], np.argsort(orb._repl_spec.perm))
    data, final = vmc(wf, params, configs, nblocks=1, nsteps_per_block=1, accumulators=acc,
                      generator=torch.Generator().manual_seed(3))
    for k in ("acceptance", "energytotal", "energyke", "energyecp", "energyee", "energyei"):
        assert np.isfinite(data[0][k]), k
    assert 0.0 < data[0]["acceptance"] <= 1.0
    assert final.wrap.dtype == torch.int32 and not torch.equal(final.positions, configs.positions)

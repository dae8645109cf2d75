"""One whole VMC block of the port against the JAX package's
make_vmc_block(fused=False): ccECP/cc-pVDZ H2O Slater-Jastrow, energy
accumulator with the nonlocal ECP, 2 steps, 4 walkers, float64.

The JAX block draws its numbers from a key (method/vmc.py:136-145); the
test redraws them with the same JAX calls and passes them to the port as
`streams`. Positions then agree to 1e-9 and every block average, energy
components included, to 1e-8 (the energies sum kinetic terms of O(10) Ha
over a two-step chain whose rounding grows through the inverse updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method.vmc import make_vmc_block as j_make_vmc_block
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.entry import h2o_setup
from pyqmc_tpu_torch.method.vmc import make_vmc_block, vmc
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator

from .torch_parity import F64, h2o_pair, h2o_params, h2o_wf_objects, jax_rotations, walkers

TSTEP, NSTEPS, NCONF = 0.5, 2, 4


def jax_block_streams(key, nelec, nconf, dtype=jnp.float64):
    """The draws of method/vmc.py's block for one accumulator, as numpy."""
    kg, ku, ka = jax.random.split(key, 3)
    gauss = jax.random.normal(kg, (NSTEPS, nelec, nconf, 3), dtype) * jnp.sqrt(TSTEP)
    unif = jax.random.uniform(ku, (NSTEPS, nelec, nconf), dtype)
    akeys = jax.random.split(ka, NSTEPS * 1).reshape((NSTEPS, 1) + ka.shape)
    rot = np.stack([jax_rotations(akeys[s, 0], nelec, nconf) for s in range(NSTEPS)])
    return {"gauss": np.asarray(gauss), "unif": np.asarray(unif), "rot": rot}


def test_vmc_block_matches_jax():
    rng = np.random.default_rng(71)
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf = h2o_wf_objects()
    jp, tp = h2o_params(rng)
    pos = walkers(rng, NCONF)
    key = jax.random.PRNGKey(5)
    jblock = j_make_vmc_block(jwf, {"energy": JEnergy(jmol)}, JGeometry(None), tstep=TSTEP,
                              nsteps=NSTEPS, fused=False)
    p_j, _, avg_j = jblock(jp, jnp.array(pos), jnp.zeros((NCONF, 8, 3), jnp.int32), key)

    streams = {k: torch.tensor(v, dtype=F64)
               for k, v in jax_block_streams(key, 8, NCONF).items()}
    block = make_vmc_block(twf, {"energy": EnergyAccumulator(tmol)}, Geometry(),
                           tstep=TSTEP, nsteps=NSTEPS)
    p_t, _, avg_t = block(tp, torch.as_tensor(pos, dtype=F64),
                          torch.zeros((NCONF, 8, 3), dtype=torch.int32), None, streams)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    assert set(avg_t) == set(avg_j)
    for k in avg_j:
        np.testing.assert_allclose(float(avg_t[k]), float(avg_j[k]), atol=1e-8, rtol=1e-8,
                                   err_msg=k)
    assert abs(float(avg_t["energyecp"])) > 1e-3


def test_vmc_driver_on_cpu():
    """vmc() through the entry point, on the CPU with the plain versions:
    finite block averages with every energy component, and a chain that
    moves."""
    mol, wf, params, configs, acc = h2o_setup(nconf=6)
    data, final = vmc(wf, params, configs, nblocks=2, nsteps_per_block=2, accumulators=acc,
                      generator=torch.Generator().manual_seed(3))
    assert [d["block"] for d in data] == [0, 1]
    for d in data:
        for k in ("acceptance", "energytotal", "energyke", "energyecp", "energyee"):
            assert np.isfinite(d[k])
        assert 0.0 < d["acceptance"] <= 1.0
    assert final.positions.shape == (6, 8, 3)
    assert not torch.equal(final.positions, configs.positions)

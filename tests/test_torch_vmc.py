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
from pyqmc_tpu_torch.method.vmc import downselects, draw_streams, make_vmc_block, vmc
from pyqmc_tpu_torch.models import orbitals as orbitals_mod
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator

from .torch_parity import F64, h2o_pair, h2o_params, h2o_wf_objects, jax_vmc_block, walkers

TSTEP, NSTEPS, NCONF = 0.5, 2, 4


def test_vmc_block_matches_jax():
    rng = np.random.default_rng(71)
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf = h2o_wf_objects()
    jp, tp = h2o_params(rng)
    pos = walkers(rng, NCONF)
    key = jax.random.PRNGKey(5)
    jblock = j_make_vmc_block(jwf, {"energy": JEnergy(jmol)}, JGeometry(None), tstep=TSTEP,
                              nsteps=NSTEPS, fused=False)
    (p_j, _, avg_j), streams = jax_vmc_block(
        "h2o vmc block", jblock, (jp, jnp.array(pos), jnp.zeros((NCONF, 8, 3), jnp.int32), key),
        8, NCONF, NSTEPS, TSTEP)
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
    mol, wf, params, configs, acc = h2o_setup(nconf=6, device="cpu")
    data, final = vmc(wf, params, configs, nblocks=2, nsteps_per_block=2, accumulators=acc,
                      generator=torch.Generator().manual_seed(3))
    assert [d["block"] for d in data] == [0, 1]
    for d in data:
        for k in ("acceptance", "energytotal", "energyke", "energyecp", "energyee"):
            assert np.isfinite(d[k])
        assert 0.0 < d["acceptance"] <= 1.0
    assert final.positions.shape == (6, 8, 3)
    assert not torch.equal(final.positions, configs.positions)


def test_streams_draw_u_sel_only_for_a_downselected_ecp():
    """u_sel is drawn last and only where an ECP downselects, so the dense
    ECP's chains draw gauss, unif and rot alone, and the downselected
    ECP's share them."""
    (_, _), (tmol, _) = h2o_pair()
    dense = {"energy": EnergyAccumulator(tmol)}
    picked = {"energy": EnergyAccumulator(tmol, ecp_acc=ECPAccumulator(tmol, nselect=4))}
    assert not downselects(dense) and downselects(picked) and not downselects({})
    a = draw_streams(torch.Generator().manual_seed(1), 2, 8, 3, TSTEP, "cpu", F64)
    b = draw_streams(torch.Generator().manual_seed(1), 2, 8, 3, TSTEP, "cpu", F64,
                     downselect=True)
    assert set(a) == {"gauss", "unif", "rot"} and set(b) == set(a) | {"u_sel"}
    assert b["u_sel"].shape == (2, 8, 3)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_plain_block_evaluates_orbitals_without_kernels(monkeypatch):
    """make_vmc_block(fused=False) evaluates every orbital inside
    plain_orbitals (no K3 or K6), fused=True outside it; the switch is
    scoped to the block."""
    seen = []
    gate = orbitals_mod._value_kernel
    monkeypatch.setattr(orbitals_mod, "_value_kernel",
                        lambda X: seen.append(orbitals_mod._KERNELS.get()) or gate(X))
    mol, wf, params, configs, acc = h2o_setup(nconf=2, device="cpu", dtype=torch.float32)
    for fused in (False, True):
        seen.clear()
        block = make_vmc_block(wf, acc, configs.geometry, tstep=TSTEP, nsteps=1, fused=fused)
        block(params, configs.positions, configs.wrap, torch.Generator().manual_seed(2))
        assert seen and set(seen) == {fused}
    assert orbitals_mod._KERNELS.get()

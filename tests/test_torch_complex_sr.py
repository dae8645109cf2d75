"""The complex channel of stochastic reconfiguration against the JAX
package's (float64, CPU), on the set-up of JAX
tests/integration/test_complex_linemin.py: ccECP H2 with its occupied MO
coefficients multiplied by i plus real noise, times a Jastrow, both spins'
coefficients and the Jastrow optimized (complex parameters split into real
and imaginary directions):

- on shared walkers, parameters and ECP rotations, StochasticReconfiguration's
  per-step averages (total, dp, dpH, dpidpj and the complex channel's
  total_im, dpI, dpHI, dpidpjI) match the JAX package's to 1e-10, and so do
  delta_p's steps and |g| from two blocks of them;
- a 2-iteration line minimization at 32 walkers on the port returns
  complex, finite parameters and finite records.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pyqmc_tpu.models.jastrow import JastrowSpin as JJastrow
from pyqmc_tpu.models.multiply import MultiplyWF as JMultiply
from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
from pyqmc_tpu.models.slater import Slater as JSlater
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.sr import StochasticReconfiguration as JSR
from pyqmc_tpu.observables.transform import LinearTransform as JTransform
from pyqmc_tpu.system.mole import Molecule as JMolecule
from pyqmc_tpu.system.scf import run_scf

from pyqmc_tpu_torch.configs import initial_guess
from pyqmc_tpu_torch.convert import params_from_numpy
from pyqmc_tpu_torch.method.linemin import line_minimization
from pyqmc_tpu_torch.models.jastrow import JastrowSpin
from pyqmc_tpu_torch.models.multiply import MultiplyWF
from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.sr import StochasticReconfiguration
from pyqmc_tpu_torch.observables.transform import LinearTransform

from .torch_parity import F64, jax_rotations, jrun, port_molecule, to_np

NCONF = 16
KEYS = ("total", "dp", "dpH", "dpidpj", "total_im", "dpI", "dpHI", "dpidpjI")


@functools.lru_cache(maxsize=None)
def h2_complex():
    """(jax wf, jax params, jax transform, port mol, port wf, port params,
    port transform, jax energy, port energy)."""
    jmol = JMolecule("H 0 0 0; H 0 0 1.4", basis="ccecp-ccpvdz", ecp="ccecp")
    mf = run_scf(jmol)
    rng = np.random.default_rng(7)
    nup, ndn = jmol.nelec
    ca = np.asarray(mf.mo_coeff[0][:, :nup]) * 1j
    cb = np.asarray(mf.mo_coeff[1][:, :ndn]) * 1j
    ca = ca + (rng.random(ca.shape) - 0.5) * 0.2
    cb = cb + (rng.random(cb.shape) - 0.5) * 0.2
    jwf = JMultiply(JSlater(jmol, None, JExpansion.single(nup, ndn),
                            mo_coeff=(jnp.asarray(ca), jnp.asarray(cb))), JJastrow(jmol))
    jparams = jwf.make_params()
    jparams["wf1"]["acoeff"] = jnp.asarray(rng.normal(scale=0.1,
                                                      size=jparams["wf1"]["acoeff"].shape))
    to_opt = {"wf0": {"det_coeff": False, "mo_coeff_alpha": np.ones(ca.shape, dtype=bool),
                      "mo_coeff_beta": np.ones(cb.shape, dtype=bool)},
              "wf1": {"acoeff": True, "bcoeff": True}}
    tmol = port_molecule(jmol)
    twf = MultiplyWF(Slater(tmol, None, DeterminantExpansion.single(nup, ndn), (ca, cb)),
                     JastrowSpin(tmol))
    tparams = params_from_numpy(jax.device_get(jparams), device="cpu", dtype=F64)
    return (jwf, jparams, JTransform(jparams, to_opt), tmol, twf, tparams,
            LinearTransform(tparams, to_opt), JEnergy(jmol), EnergyAccumulator(tmol))


def test_complex_sr_matches_jax():
    jwf, jparams, jlt, tmol, twf, tparams, tlt, jenergy, tenergy = h2_complex()
    assert tlt.nimag == jlt.nimag > 0 and tlt.nparams == jlt.nparams
    jsr, tsr = JSR(jenergy, jlt), StochasticReconfiguration(tenergy, tlt)
    assert tsr.keys() == jsr.keys()

    def jax_avg(params, x, key):
        return jsr.avg(jwf, params, jwf.recompute(params, x), x, key=key)

    rng = np.random.default_rng(21)
    blocks_j, blocks_t = [], []
    for b in range(2):
        x = rng.normal(scale=1.2, size=(NCONF, 2, 3)) + np.array([0.0, 0.0, 0.7])
        key = jax.random.PRNGKey(31 + b)
        ja = {k: np.asarray(v) for k, v in jrun("complex_sr", jax_avg, jparams,
                                                jnp.asarray(x), key).items()}
        xt = torch.as_tensor(x, dtype=F64)
        rot = torch.as_tensor(jax_rotations(key, 2, NCONF), dtype=F64)
        ta = {k: v.numpy() for k, v in tsr.avg(twf, tparams, twf.recompute(tparams, xt), xt,
                                                rot).items()}
        assert set(ta) == set(ja) == set(KEYS)
        for k in KEYS:
            np.testing.assert_allclose(ta[k], ja[k], rtol=1e-10, atol=1e-10, err_msg=k)
        assert np.max(np.abs(ja["dpidpjI"])) > 1e-3
        blocks_j.append(ja)
        blocks_t.append(ta)
    taus = [0.0, 0.1, 0.4]
    stack = lambda blocks: {k: np.stack([b[k] for b in blocks]) for k in KEYS}
    steps_j, g_j = jsr.delta_p(taus, stack(blocks_j))
    steps_t, g_t = tsr.delta_p(taus, stack(blocks_t))
    np.testing.assert_allclose(g_t, g_j, rtol=1e-10)
    np.testing.assert_allclose(np.stack(steps_t), np.stack(steps_j), rtol=1e-10, atol=1e-12)
    # the complex channel moves the step: without it the step differs
    real_only = {k: stack(blocks_j)[k] for k in KEYS[:4]}
    assert np.max(np.abs(jsr.delta_p([0.1], real_only)[0][0] - steps_j[1])) > 1e-6


def test_complex_linemin_on_cpu():
    """Two iterations of 2 x 5 SR steps at 32 walkers: the parameters stay
    complex and finite, the records finite."""
    _, _, _, tmol, twf, tparams, tlt, _, tenergy = h2_complex()
    configs = initial_guess(tmol, 32, generator=torch.Generator().manual_seed(0), device="cpu")
    params, cfg, records = line_minimization(
        twf, tparams, configs, tlt, tenergy, generator=torch.Generator().manual_seed(1),
        max_iterations=2, vmc_blocks=2, vmc_steps_per_block=5)
    assert [r["iteration"] for r in records] == [0, 1]
    assert all(np.all(np.isfinite(r[k])) for r in records
               for k in ("energy", "energy_err", "gnorm", "line_energies"))
    assert params["wf0"]["mo_coeff_alpha"].is_complex()
    assert all(np.all(np.isfinite(a)) for a in to_np(params))
    moved = tlt.serialize(params) - tlt.serialize(tparams)
    assert records[0]["tau"] == 0.0 or float(torch.max(torch.abs(moved))) > 0

"""The port's ECP energy against the JAX package's dense XLA chain
(ECPAccumulator(mol, fused=False)) on ccECP/cc-pVDZ H2O, float64.

The JAX accumulator draws one rotation per (walker, electron) from
fold_in(key, 1000 + e); the test draws the same rotations with the JAX
function and hands them to the port as numpy. Both then integrate the same
quadrature, so the energies agree to rtol 1e-9 (float64 rounding of sums
over 48 points per walker whose terms partly cancel).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.observables.ecp import ECPAccumulator as JECP

from pyqmc_tpu_torch.observables.ecp import ECPAccumulator, rotations_from_quaternions
from pyqmc_tpu_torch.ops.ecp_energy import FusedECPEnergy, ecp_nonlocal_plain

from .torch_parity import F64, h2o_pair, h2o_params, h2o_wf_objects, jax_rotations, walkers


@functools.lru_cache(maxsize=None)
def _jax_ecp():
    (jmol, _), _ = h2o_pair()
    jwf, _ = h2o_wf_objects()
    acc = JECP(jmol, fused=False)
    assert acc.nselect is None  # dense: the only mode the port has
    return jax.jit(lambda p, pos, key: acc(jwf, p, jwf.recompute(p, pos), pos, key))


@pytest.mark.parametrize("seed", [61, 62])
def test_ecp_energy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    (_, _), (tmol, _) = h2o_pair()
    _, twf = h2o_wf_objects()
    jp, tp = h2o_params(rng)
    nconf = 5
    # half the walkers within 1 bohr of O, where the nonlocal channel is large
    pos = walkers(rng, nconf)
    pos[:3] *= 0.4
    key = jax.random.PRNGKey(seed)
    e_j = np.asarray(_jax_ecp()(jp, jnp.asarray(pos), key))
    acc = ECPAccumulator(tmol)
    tpos = torch.as_tensor(pos, dtype=F64)
    ts = twf.recompute(tp, tpos)
    rot = torch.as_tensor(jax_rotations(key, 8, nconf), dtype=F64)
    nl_fn = acc.nonlocal_fn(twf)
    assert isinstance(nl_fn, FusedECPEnergy)  # the main path is inside the kernel's gate
    e_t = acc(twf, tp, ts, tpos, rot).numpy()
    np.testing.assert_allclose(e_t, e_j, rtol=1e-9, atol=1e-12)
    nl = ecp_nonlocal_plain(acc, twf, tp, tpos, ts, rot)
    assert float(torch.max(torch.abs(nl))) > 1e-3  # the nonlocal part is exercised


def test_channel_cap_raises(monkeypatch):
    """A wavefunction inside the JAX gate but over the kernel's channel cap
    still gets the kernel's wrapper, whose launch raises KernelUnsupported
    (it never hands a CUDA tensor to the plain chain)."""
    from pyqmc_tpu_torch.ops import move_sweep
    from pyqmc_tpu_torch.ops.ecp_energy import build_fused_ecp_energy

    (_, _), (tmol, _) = h2o_pair()
    _, twf = h2o_wf_objects()
    _, tp = h2o_params(np.random.default_rng(5))
    acc = ECPAccumulator(tmol)
    monkeypatch.setattr(move_sweep, "MAX_CHANNELS", 0)
    fn = build_fused_ecp_energy(twf, acc)
    assert isinstance(fn, FusedECPEnergy)
    tpos = torch.as_tensor(walkers(np.random.default_rng(6), 2), dtype=F64)
    rot = torch.eye(3, dtype=F64).expand(8, 2, 3, 3).contiguous()
    with pytest.raises(move_sweep.KernelUnsupported, match="nonlocal ECP channels"):
        fn.kernel(tp, tpos, twf.recompute(tp, tpos), rot)


@pytest.mark.parametrize("naip,degree", [(6, 3), (12, 5), (18, 5), (26, 7), (32, 9), (50, 11)])
def test_quadrature_grids_exact(naip, degree):
    """Each grid averages x^a y^b z^c over the sphere exactly through its
    degree (weights sum to 1, points on the unit sphere)."""
    from math import gamma

    from pyqmc_tpu_torch.observables.ecp import ecp_quadrature_grid

    pts, w = ecp_quadrature_grid(naip)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=1), 1.0, atol=1e-14)
    for a in range(degree + 1):
        for b in range(degree + 1 - a):
            for c in range(degree + 1 - a - b):
                exact = 0.0
                if a % 2 == b % 2 == c % 2 == 0:
                    exact = (gamma((a + 1) / 2) * gamma((b + 1) / 2) * gamma((c + 1) / 2)
                             / gamma((a + b + c + 3) / 2) / (2 * np.pi))
                got = np.sum(w * pts[:, 0] ** a * pts[:, 1] ** b * pts[:, 2] ** c)
                assert abs(got - exact) < 1e-12, (a, b, c)


def test_rotations_are_rotations():
    q = torch.randn((4, 7, 4), generator=torch.Generator().manual_seed(3), dtype=F64)
    R = rotations_from_quaternions(q)
    eye = torch.eye(3, dtype=F64).expand(4, 7, 3, 3)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, atol=1e-12, rtol=0)
    torch.testing.assert_close(torch.linalg.det(R), torch.ones(4, 7, dtype=F64), atol=1e-12,
                               rtol=0)

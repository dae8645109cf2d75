"""The port's slab Ewald sum (pyqmc_tpu_torch/observables/ewald2d.py): the
three cases of the JAX package's tests/unit/test_ewald2d.py on the port,
and the port against the JAX package's Ewald2D (ii_const, psi_host, and the
per-walker energy in float64 on the CPU, 1e-10)."""

import jax.numpy as jnp
import numpy as np
import torch

from pyqmc_tpu.observables.ewald2d import Ewald2D as JEwald2D

from pyqmc_tpu_torch.observables.ewald2d import Ewald2D

from .torch_parity import jrun


class _FakeCell:
    def __init__(self, coords, charges, lattice):
        self.atom_coords = np.asarray(coords, dtype=float)
        self.atom_charges = np.asarray(charges, dtype=float)
        self.lattice = np.asarray(lattice, dtype=float)


def _nacl_monolayer():
    """Square-planar NaCl monolayer, 2x2 ions, nearest-neighbour distance 1."""
    coords = np.array([[0, 0, 0], [1, 1, 0], [1, 0, 0], [0, 1, 0]], dtype=float)
    return _FakeCell(coords, [1, 1, -1, -1], np.diag([2.0, 2.0, 30.0]))


def test_nacl_monolayer_madelung():
    """M = 1.6155426267 per ion pair."""
    ew = Ewald2D(_nacl_monolayer())
    np.testing.assert_allclose(ew.ii_const / 2.0, -1.6155426267, rtol=1e-8)


def test_alpha_independence_2d():
    cell = _FakeCell([[0, 0, 0.0], [1.15, 1.15, 0.4]], [1.0, -1.0], np.diag([2.3, 2.3, 20.0]))
    np.testing.assert_allclose(Ewald2D(cell, alpha=2.0).ii_const,
                               Ewald2D(cell, alpha=3.0).ii_const, rtol=1e-6)


def test_device_matches_host():
    """The torch energy of a walker equals the ion-ion constant of the cell
    with its electrons added as charges -1."""
    lattice = np.diag([3.0, 3.0, 25.0])
    cell = _FakeCell([[0.1, 0.2, 0.0]], [2.0], lattice)
    pos = np.random.default_rng(0).uniform(-1, 1, size=(2, 3, 3))
    pos[..., 2] *= 0.5
    ee, ei, ii = Ewald2D(cell).energy(torch.as_tensor(pos))
    for c in range(2):
        allq = np.concatenate([cell.atom_charges, -np.ones(3)])
        allx = np.concatenate([cell.atom_coords, pos[c]])
        ref = Ewald2D(_FakeCell(allx, allq, lattice)).ii_const
        np.testing.assert_allclose(float(ee[c] + ei[c] + ii[c]), ref, rtol=1e-7)


def test_matches_jax():
    """ii_const, xi, psi_host and energy's (ee, ei, ii) per walker against
    the JAX package, float64, 1e-10 (the NaCl monolayer, 5 walkers of 4
    electrons near the plane)."""
    cell = _nacl_monolayer()
    ew, jew = Ewald2D(cell), JEwald2D(cell)
    assert abs(ew.ii_const - jew.ii_const) < 1e-10 and abs(ew.xi - jew.xi) < 1e-10
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.0, 2.0, size=(5, 4, 3))
    pos[..., 2] = rng.uniform(-0.5, 0.5, size=(5, 4))
    np.testing.assert_allclose(ew.psi_host(pos), jew.psi_host(pos), atol=1e-10, rtol=1e-10)
    got = ew.energy(torch.as_tensor(pos, dtype=torch.float64))
    want = jrun("ewald2d energy", jew.energy, jnp.asarray(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-10, rtol=1e-10)

"""The port's public surface against the JAX package, on shared numpy inputs
in float64:

(a) the walker-state API of `Configs` and `Geometry` and the distance
    functions of ops/distances in the open, orthorhombic and general
    (diamond) lattice modes, to 1e-12;
(b) a user's `GenericJastrow` subclass written to the JAX contract only
    (`features` and `bilinear`: atom-centred Gaussians with a symmetric A),
    each side in its own package's idiom, to 1e-10; the generic
    `pgradient` of GPSJastrow and GeminalJastrow against their closed
    forms; the user factor beside Slater x JastrowSpin through testwf, VMC
    and one line-minimization iteration of the port;
(c) EnergyAccumulator's keys, shapes and has_nonlocal_moves,
    octahedral_grid, ECPAccumulator.tmove_data, is_complex and vmc's
    limdrift;
(d) every public module, function, class and method of pyqmc_tpu has a
    counterpart of the same name in pyqmc_tpu_torch, but for a listed few.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyqmc_tpu
import pyqmc_tpu.configs as jconfigs
import pyqmc_tpu.ops.distances as jdist
from pyqmc_tpu.method.vmc import limdrift as j_limdrift
from pyqmc_tpu.models.generic_jastrow import GenericJastrow as JGeneric
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.observables.ecp import ECPAccumulator as JECP
from pyqmc_tpu.observables.ecp import octahedral_grid as j_octahedral_grid
from pyqmc_tpu.observables.ecp import random_rotations
from pyqmc_tpu.utils.dtypes import is_complex as j_is_complex

import pyqmc_tpu_torch
import pyqmc_tpu_torch.configs as tconfigs
import pyqmc_tpu_torch.ops.distances as tdist
from pyqmc_tpu_torch.configs import initial_guess
from pyqmc_tpu_torch.method.linemin import line_minimization
from pyqmc_tpu_torch.method.vmc import limdrift as t_limdrift
from pyqmc_tpu_torch.method.vmc import vmc
from pyqmc_tpu_torch.models import testwf
from pyqmc_tpu_torch.models.generic_jastrow import GenericJastrow
from pyqmc_tpu_torch.models.generic_jastrow import GeminalJastrow, GPSJastrow
from pyqmc_tpu_torch.models.multiply import MultiplyWF
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator, octahedral_grid
from pyqmc_tpu_torch.observables.transform import LinearTransform
from pyqmc_tpu_torch.utils.constants import DeviceConstants
from pyqmc_tpu_torch.utils.dtypes import is_complex
from pyqmc_tpu_torch.wftools import generate_wf

from .torch_parity import F64, diamond_cells, h2o_pair, jrun

EXACT = 1e-12
USER_TOL = 1e-10


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def close(a, b, tol=EXACT):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=tol)


# --- (a) walker state and distances ---------------------------------------------

LATTICES = {"open": None, "orthorhombic": np.diag([3.1, 4.2, 5.3]) @ np.array(
    [[0.6, 0.8, 0.0], [-0.8, 0.6, 0.0], [0.0, 0.0, 1.0]])}


def lattice(mode):
    return diamond_cells()[2].lattice if mode == "general" else LATTICES[mode]


def _jax_walker_ops(geometry, pos, wrap, epos, mask, new, new_wrap, idx, lat_args):
    """Every walker-state and distance output of the JAX package, in one
    compiled function (jrun)."""
    def run(pos, wrap, epos, mask, new, new_wrap, idx):
        c = jconfigs.Configs.create(pos, geometry, wrap=wrap)
        f, w = c.make_irreducible(epos)
        out = {"electron": c.electron(2), "folded": f, "wrap_delta": w,
               "dist_matrix": geometry.dist_matrix(pos), "dist_i": geometry.dist_i(pos, epos),
               "f_dist_matrix": jdist.dist_matrix(pos, *lat_args),
               "f_dist_i": jdist.dist_i(pos, epos, *lat_args),
               "f_pair": jdist.pair_displacements(pos[:, :1], pos, *lat_args)}
        for tag, m in (("all", None), ("mask", mask)):
            for wtag, wd in (("", None), ("w", w)):
                n = c.move(1, f, wd, mask=m)
                out[f"move_{tag}{wtag}"] = (n.positions, n.wrap)
            for wtag, nw in (("", None), ("w", new_wrap)):
                n = c.move_all(new, nw, mask=m)
                out[f"move_all_{tag}{wtag}"] = (n.positions, n.wrap)
        r = c.resample(idx)
        out["resample"] = (r.positions, r.wrap)
        return out

    return jrun(("walkers", geometry.mode), run, pos, wrap, epos, mask, new, new_wrap, idx)


@pytest.mark.parametrize("mode", ["open", "orthorhombic", "general"])
def test_walker_state_matches_jax(mode):
    lat = lattice(mode)
    jg, tg = jconfigs.Geometry(lat), tconfigs.Geometry(lat)
    assert tg.mode == jg.mode == (jdist.MODE_OPEN if lat is None else mode)
    rng = np.random.default_rng(11)
    nconf, nelec = 5, 4
    pos = rng.normal(scale=3.0, size=(nconf, nelec, 3))
    wrap = rng.integers(-2, 3, size=(nconf, nelec, 3)).astype(np.int32)
    epos = pos[:, 1] + rng.normal(scale=4.0, size=(nconf, 3))
    mask = np.array([True, False, True, True, False])
    new = rng.normal(size=pos.shape)
    new_wrap = rng.integers(-1, 2, size=wrap.shape).astype(np.int32)
    idx = np.array([4, 4, 0, 2, 1])
    jargs = (None, None, jdist.MODE_OPEN) if lat is None else (
        jnp.asarray(lat), jnp.asarray(np.linalg.inv(lat)), jg.mode)
    jout = jax.device_get(_jax_walker_ops(jg, *map(jnp.asarray, (
        pos, wrap, epos, mask, new, new_wrap, idx)), jargs))

    tc = tconfigs.Configs.create(t64(pos), tg, wrap=torch.as_tensor(wrap))
    assert (tc.nconf, tc.nelec) == (nconf, nelec)
    before = tc.positions.clone(), tc.wrap.clone()
    tf, tw = tc.make_irreducible(t64(epos))
    targs = (None, None, tdist.MODE_OPEN) if lat is None else (
        t64(lat), t64(np.linalg.inv(lat)), tg.mode)  # shifts made from the lattice
    tout = {"electron": tc.electron(2), "folded": tf, "wrap_delta": tw,
            "dist_matrix": tg.dist_matrix(t64(pos)), "dist_i": tg.dist_i(t64(pos), t64(epos)),
            "f_dist_matrix": tdist.dist_matrix(t64(pos), *targs),
            "f_dist_i": tdist.dist_i(t64(pos), t64(epos), *targs),
            "f_pair": tdist.pair_displacements(t64(pos[:, :1]), t64(pos), *targs)}
    tm = torch.as_tensor(mask)
    for tag, m in (("all", None), ("mask", tm)):
        for wtag, wd in (("", None), ("w", tw)):
            n = tc.move(1, tf, wd, mask=m)
            tout[f"move_{tag}{wtag}"] = (n.positions, n.wrap)
        for wtag, nw in (("", None), ("w", torch.as_tensor(new_wrap))):
            n = tc.move_all(t64(new), nw, mask=m)
            tout[f"move_all_{tag}{wtag}"] = (n.positions, n.wrap)
    r = tc.resample(torch.as_tensor(idx))
    tout["resample"] = (r.positions, r.wrap)
    assert set(tout) == set(jout)
    for k in tout:
        for a, b in zip(*((tout[k], jout[k]) if isinstance(tout[k], tuple)
                          else ((tout[k],), (jout[k],)))):
            close(a, b)
    assert torch.equal(tc.positions, before[0]) and torch.equal(tc.wrap, before[1])
    if lat is not None:
        assert torch.abs(tw).max() > 0  # some point left the cell
    dm = tout["dist_matrix"]
    assert dm.shape == (nconf, nelec, nelec, 3)
    assert float(torch.abs(torch.diagonal(dm, dim1=1, dim2=2)).max()) == 0.0

    jc = jconfigs.Configs.create(jnp.asarray(pos), jg, wrap=jnp.asarray(wrap))
    for n in (2, 3):
        tparts, jparts = tc.split(n), jc.split(n)
        assert [p.nconf for p in tparts] == [p.nconf for p in jparts]
        for tp_, jp_ in zip(tparts, jparts):
            close(tp_.positions, jp_.positions, 0.0)
            assert tp_.geometry == tg
        back = tconfigs.Configs.join(tparts)
        assert torch.equal(back.positions, tc.positions) and torch.equal(back.wrap, tc.wrap)


# --- (b) a user's GenericJastrow ---------------------------------------------------

class JAtomGaussJastrow(JGeneric):
    """U = sum_{i<j} phi(r_i)^T A phi(r_j), phi = exp(-a |r - R_I|^2) for each
    atom I and exponent a: the JAX package's contract."""

    def __init__(self, mol, exponents=(0.6, 1.5)):
        super().__init__(sum(mol.nelec))
        self.centers = np.asarray(mol.atom_coords)
        self.exponents = np.asarray(exponents)
        self.nfeat = self.centers.shape[0] * self.exponents.shape[0]

    def make_params(self):
        return {"A": jnp.zeros((self.nfeat, self.nfeat))}

    def features(self, params, xyz):
        d = xyz[..., None, :] - jnp.asarray(self.centers)
        r2 = jnp.sum(d * d, axis=-1)
        return jnp.exp(-r2[..., None] * jnp.asarray(self.exponents)).reshape(
            *xyz.shape[:-1], self.nfeat)

    def bilinear(self, params, u, v):
        A = 0.5 * (params["A"] + params["A"].T)
        return jnp.einsum("...m,mn,...n->...", u, A, v)


class AtomGaussJastrow(GenericJastrow):
    """The same user Jastrow in the port's idiom."""

    def __init__(self, mol, exponents=(0.6, 1.5)):
        super().__init__(sum(mol.nelec))
        self.nfeat = len(mol.atom_coords) * len(exponents)
        self._const = DeviceConstants(centers=np.asarray(mol.atom_coords),
                                      exponents=np.asarray(exponents, dtype=np.float64))

    def make_params(self, device=None, dtype=None):
        return {"A": torch.zeros((self.nfeat, self.nfeat), dtype=dtype or F64, device=device)}

    def features(self, params, xyz):
        c = self._const.get(xyz.device, xyz.dtype)
        d = xyz[..., None, :] - c["centers"]
        r2 = torch.sum(d * d, dim=-1)
        return torch.exp(-r2[..., None] * c["exponents"]).reshape(*xyz.shape[:-1], self.nfeat)

    def bilinear(self, params, u, v):
        A = 0.5 * (params["A"] + params["A"].T)
        return torch.sum((u @ A) * v, dim=-1)


@functools.lru_cache(maxsize=None)
def user_pair():
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf = JAtomGaussJastrow(jmol), AtomGaussJastrow(tmol)
    A = np.random.default_rng(21).normal(scale=0.1, size=(jwf.nfeat, jwf.nfeat))
    return jwf, twf, {"A": jnp.asarray(A)}, {"A": t64(A)}


USER_METHODS = ["recompute", "u_total", "testvalue", "testvalue_point_axis", "testvalue_many",
                "gradient", "gradient_laplacian", "pgradient"]


@pytest.mark.parametrize("method", USER_METHODS)
def test_user_jastrow_matches_jax(method):
    jwf, twf, jp, tp = user_pair()
    rng = np.random.default_rng(22)
    nconf = 4
    pos = rng.normal(scale=1.5, size=(nconf, 8, 3))
    jpos, tpos = jnp.asarray(pos), t64(pos)
    if method in ("u_total", "pgradient"):
        tout = getattr(twf, method)(tp, tpos)
        jout = jrun(("user", method), getattr(jwf, method), jp, jpos)
        for k, v in (tout.items() if method == "pgradient" else [(None, tout)]):
            close(v, jout if k is None else jout[k], USER_TOL)
        return
    jst = jrun(("user", "recompute"), jwf.recompute, jp, jpos)
    tst = twf.recompute(tp, tpos)
    if method == "recompute":
        for a, b in zip(tst, jst):
            close(a, b, USER_TOL)
        return
    epos = pos[:, 3] + rng.normal(scale=0.5, size=(nconf, 3))
    if method == "testvalue_many":
        close(twf.testvalue_many(tp, tst, t64(epos)),
              jrun(("user", method), jwf.testvalue_many, jp, jst, jnp.asarray(epos)), USER_TOL)
        return
    if method == "testvalue_point_axis":
        epos = epos[:, None] + rng.normal(scale=0.3, size=(nconf, 3, 3))
    name = "testvalue" if method == "testvalue_point_axis" else method
    for e in (0, 7):
        tout = getattr(twf, name)(tp, tst, e, t64(epos))
        jout = jrun(("user", method), getattr(jwf, name), jp, jst, jnp.int32(e), jnp.asarray(epos))
        if name == "testvalue":
            tout, jout = tout[0], jout[0]
        for a, b in zip(*((tout, jout) if name == "gradient_laplacian" else ((tout,), (jout,)))):
            close(a, b, USER_TOL)


@pytest.mark.parametrize("name", ["gps", "geminal"])
def test_generic_pgradient_matches_closed_form(name):
    """The base class's autograd pgradient and feature derivatives of GPS and
    the geminal against their closed forms."""
    (_, _), (tmol, _) = h2o_pair()
    wf = GPSJastrow(tmol, n_support=3) if name == "gps" else GeminalJastrow(tmol)
    g = torch.Generator().manual_seed(23)
    params = {k: v + 0.05 * torch.randn(v.shape, generator=g, dtype=F64)
              for k, v in wf.make_params("cpu").items()}
    pos = torch.randn((4, 8, 3), generator=g, dtype=F64)
    closed, generic = wf.pgradient(params, pos), GenericJastrow.pgradient(wf, params, pos)
    assert set(closed) == set(generic)
    for k in closed:
        assert closed[k].shape == generic[k].shape
        close(generic[k], closed[k], 1e-10)
    for a, b in zip(GenericJastrow.feature_derivs(wf, params, pos[:, 2]),
                    wf.feature_derivs(params, pos[:, 2])):
        close(a, b, 1e-10)


def test_user_jastrow_runs_vmc_and_line_minimization():
    """The user Jastrow in the port on the CPU: the protocol checks through
    a product (pgradient against finite differences among them), then
    Slater x JastrowSpin x the user Jastrow through VMC and one
    line-minimization iteration that optimizes A with JastrowSpin's
    coefficients."""
    _, (tmol, tmf) = h2o_pair()
    _, twf, _, tp = user_pair()
    gen = torch.Generator().manual_seed(24)
    configs = initial_guess(tmol, 8, generator=gen, device="cpu")
    testwf.run_all(MultiplyWF(twf), {"wf0": tp}, configs, torch.Generator().manual_seed(25))
    sj, params, to_opt = generate_wf(tmol, tmf, device="cpu")
    user = AtomGaussJastrow(tmol)
    wf = MultiplyWF(*sj.wfs, user)
    params = {**params, "wf2": user.make_params("cpu")}
    to_opt = {**to_opt, "wf2": {"A": np.triu(np.ones((user.nfeat, user.nfeat), dtype=bool))}}
    acc = EnergyAccumulator(tmol)
    data, configs = vmc(wf, params, configs, nblocks=1, nsteps_per_block=2,
                        accumulators={"energy": acc}, generator=gen)
    assert np.isfinite(data[0]["energytotal"])
    new, configs, records = line_minimization(
        wf, params, configs, LinearTransform(params, to_opt), acc, generator=gen,
        max_iterations=1, vmc_blocks=2, vmc_steps_per_block=1, taus=(0.0, 0.05))
    assert len(records) == 1 and np.isfinite(records[0]["energy"])
    assert np.all(np.isfinite(records[0]["line_energies"]))
    if records[0]["tau"] > 0:
        assert float(torch.abs(new["wf2"]["A"]).max()) > 0.0
    assert torch.equal(new["wf0"]["mo_coeff_alpha"], params["wf0"]["mo_coeff_alpha"])


# --- (c) accumulators, ECP helpers, dtypes, limdrift --------------------------------

def test_energy_accumulator_protocol():
    (jmol, _), (tmol, _) = h2o_pair()
    for jkw, tkw in (({}, {}), ({"ecp_acc": False}, {"ecp_acc": False})):
        ja, ta = JEnergy(jmol, **jkw), EnergyAccumulator(tmol, **tkw)
        assert ta.keys() == ja.keys() and ta.shapes() == ja.shapes()
        assert ta.has_nonlocal_moves == ja.has_nonlocal_moves == ("ecp_acc" not in tkw)


@pytest.mark.parametrize("naip", [6, 12, 18, 26, 32, 50])
def test_octahedral_grid_matches_jax(naip):
    for a, b in zip(octahedral_grid(naip), j_octahedral_grid(naip)):
        close(a, b, 0.0)


def test_tmove_data_matches_jax():
    """On the user Jastrow, whose JAX functions compile in a moment (the
    ECP's points and ratios on the main path's wavefunction are held in
    tests/test_torch_dmc.py). Its ratios are positive, so the amplitudes
    max(0, -tau T r) vanish where T > 0; a negative tau gives the other
    side of the clamp."""
    (jmol, _), (tmol, _) = h2o_pair()
    jwf, twf, jp, tp = user_pair()
    rng = np.random.default_rng(27)
    nconf = 4
    pos = rng.normal(scale=0.8, size=(nconf, 8, 3))
    jacc, tacc = JECP(jmol, fused=False), ECPAccumulator(tmol)
    jpos = jnp.asarray(pos)
    jst = jrun(("user", "recompute"), jwf.recompute, jp, jpos)
    tst = twf.recompute(tp, t64(pos))
    tmax = {}
    for tau in (0.05, -0.05):
        for e in range(8):
            key = jax.random.fold_in(jax.random.PRNGKey(28), e)
            jaux, jt = jrun(("user", "tmove_data"), lambda p, s, x, e, k, tau: jacc.tmove_data(
                jwf, p, s, x, e, k, tau), jp, jst, jpos, jnp.int32(e), key, jnp.asarray(tau))
            taux, tt = tacc.tmove_data(twf, tp, tst, t64(pos), e,
                                       t64(random_rotations(key, (nconf,))), tau)
            close(taux, jaux)
            close(tt, jt)
            assert float(tt.min()) >= 0.0
            tmax[tau] = max(tmax.get(tau, 0.0), float(tt.max()))
    assert tmax[-0.05] > 0.0


def test_is_complex_and_limdrift_match_jax():
    for x in (np.ones(2), np.ones(2, dtype=complex), 1.0, 1j):
        assert is_complex(x) == j_is_complex(x)
    for t in (torch.ones(2, dtype=F64), torch.ones(2, dtype=torch.complex128)):
        assert is_complex(t) == j_is_complex(jnp.asarray(t.numpy()))
    g = np.random.default_rng(29).normal(scale=1.5, size=(6, 3))
    for cut in (1.0, 0.5):
        close(t_limdrift(t64(g), cut), j_limdrift(jnp.asarray(g), cut))


# --- (d) the public surface ----------------------------------------------------------

# Names of pyqmc_tpu with no counterpart in the port, each with its reason.
NOT_PORTED = {
    # the Pallas kernel builders: replaced by pyqmc_tpu_torch/csrc/*.cu and
    # their wrappers in ops/move_sweep.py, ops/tmove_sweep.py,
    # ops/ecp_energy.py, ops/gto_kernels.py and ops/move_sweep_pbc.py
    "ops.gto_pallas": "Pallas kernels; replaced by csrc/ and ops/*",
    "ops.move_pallas": "Pallas kernels; replaced by csrc/ and ops/*",
    "ops.move_pallas_pbc": "Pallas kernels; replaced by csrc/ and ops/*",
    # the real-pair route: the TPU's stand-ins for complex arithmetic, which
    # the port computes natively in complex tensors (PARITY.md)
    "models.slater_pair": "pair route",
    "models.slater_embedded": "pair route",
    "ops.cpair": "pair route",
    "models.multiply.MultiplyWF.testvalue_pair": "pair route",
    "models.multiply.MultiplyWF.testvalue_many_pair": "pair route",
    "models.multiply.MultiplyWF.gradient_laplacian_pair": "pair route",
    "models.multiply.MultiplyWF.pgradient_pair": "pair route",
    "models.orbitals.KPointOrbitals.eval_pair": "pair route",
    "models.orbitals.KPointOrbitals.make_pair_params": "pair route",
    # JAX's key-based RNG: the port draws rotations from torch.Generator
    # streams and builds them with rotations_from_quaternions
    "observables.ecp.random_rotations": "JAX key RNG",
}


def _modules(pkg):
    return {m.name[len(pkg.__name__) + 1:]: importlib.import_module(m.name)
            for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}


def test_public_surface_has_every_jax_name():
    jmods, tmods = _modules(pyqmc_tpu), _modules(pyqmc_tpu_torch)
    missing = []
    for name, mod in sorted(jmods.items()):
        if name not in tmods:
            missing.append(name)
            continue
        tmod = tmods[name]
        for attr, obj in vars(mod).items():
            if attr.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            if not (inspect.isclass(obj) or inspect.isfunction(obj)):
                continue
            if not hasattr(tmod, attr):
                missing.append(f"{name}.{attr}")
            elif inspect.isclass(obj):
                missing += [f"{name}.{attr}.{m}" for m in dir(obj)
                            if not m.startswith("_") and not hasattr(getattr(tmod, attr), m)]
    assert sorted(missing) == sorted(NOT_PORTED), sorted(set(missing) ^ set(NOT_PORTED))

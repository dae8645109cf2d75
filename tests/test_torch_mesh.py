"""The port's walker mesh (pyqmc_tpu_torch/parallel/mesh.py and the mesh=
paths of vmc, rundmc, line_minimization, sample_overlap, optimize_ensemble)
on the CPU: ccECP H2O at 16 walkers, float64, two gloo ranks on a
FileStore in tmp_path (tests/torch_mesh_ranks.py, one spawn for the whole
module).

Each meshed run is held against the one-process run fed the two ranks'
concatenated streams (torch_mesh_ranks.emulated_ranks). Averages agree to
1e-12; the line minimization's parameters and its candidates' energies to
1e-10 (its SR solve carries the block averages' last-bit differences,
which the ranks' sums in another order make, through S + eps, eps 1e-3:
6e-12 seen); positions to 1e-13: the CPU's Sherman-Morrison update of the
inverse rounds in the last bit differently for 8 and 16 walkers (the
batched products take other paths), about 4e-16 after a few steps, which
moves no accept decision. A mesh of one equals no mesh bit for bit. Against
the JAX package on two of the conftest's virtual devices: a meshed VMC
block fed the JAX shards' own draws (fold_in(key, shard index)) to 1e-10,
and the global comb selects what JAX's meshed comb selects.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method import dmc as jdmc
from pyqmc_tpu.method.vmc import make_vmc_block as j_make_vmc_block
from pyqmc_tpu.observables.accumulators import EnergyAccumulator as JEnergy
from pyqmc_tpu.parallel.mesh import walker_mesh as j_walker_mesh

from pyqmc_tpu_torch.configs import initial_guess
from pyqmc_tpu_torch.convert import params_to_numpy
from pyqmc_tpu_torch.entry import h2o_setup
from pyqmc_tpu_torch.method.linemin import line_minimization
from pyqmc_tpu_torch.method.sample_many import sample_overlap
from pyqmc_tpu_torch.method.vmc import vmc
from pyqmc_tpu_torch.observables.accumulators import EnergyAccumulator
from pyqmc_tpu_torch.observables.transform import LinearTransform
from pyqmc_tpu_torch.parallel import mesh as tmesh
from pyqmc_tpu_torch.system.io import load_npz
from pyqmc_tpu_torch.wftools import generate_wf

from . import torch_mesh_ranks as ranks
from .torch_parity import compile_quick, h2o_pair, h2o_params, h2o_wf_objects, jax_ecp_draws

JAX_NSTEPS, JAX_TSTEP = 2, 0.5
POS_ATOL = 1e-13
AVG_TOL = 1e-12
SOLVED_TOL = 1e-10  # what the line minimization's SR solve gives (module docstring)


def jax_shard_streams(key, shard, nconf):
    """The draws of JAX's meshed VMC block on one shard (method/vmc.py:
    fold_in(key, axis_index), then split into gauss, unif and accumulator
    keys; one accumulator, whose ECP rotations jax_ecp_draws redraws), as
    numpy."""
    return {k: np.array(v) for k, v in _jax_shard_draws(key, shard, nconf).items()}


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_shard_draws(key, shard, nconf):
    kg, ku, ka = jax.random.split(jax.random.fold_in(key, shard), 3)
    gauss = jax.random.normal(kg, (JAX_NSTEPS, 8, nconf, 3)) * jnp.sqrt(JAX_TSTEP)
    unif = jax.random.uniform(ku, (JAX_NSTEPS, 8, nconf))
    akeys = jax.random.split(ka, JAX_NSTEPS)
    rot = jax.vmap(lambda k: jax_ecp_draws(k, 8, nconf)[0])(akeys)
    return {"gauss": gauss, "unif": unif, "rot": rot}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results [rank 0, rank 1, the mesh of one], one-process
    references, JAX's meshed block and comb)."""
    rng = np.random.default_rng(41)
    jp, tp = h2o_params(rng)
    n = ranks.NCONF
    pos = rng.normal(scale=1.5, size=(n, 8, 3))
    key = jax.random.PRNGKey(7)
    comb = {"positions": rng.normal(size=(n, 8, 3)),
            "wrap": rng.integers(-1, 2, size=(n, 8, 3)).astype(np.int32),
            "weights": rng.uniform(0.05, 3.0, size=n),
            "u_branch": np.float64(jax.random.uniform(jax.random.PRNGKey(8), ()))}
    payload = {
        "params": params_to_numpy(tp),
        "jax_block": {"tstep": JAX_TSTEP, "nsteps": JAX_NSTEPS, "positions": pos,
                      "streams": [jax_shard_streams(key, r, n // 2) for r in range(2)]},
        "comb": comb,
    }
    started = ranks.spawn(tmp_path_factory.mktemp("mesh"), payload)
    # while the ranks run: the one-process references and the JAX side
    ref = ranks.reference_runs(payload)
    (jmol, _), _ = h2o_pair()
    jwf, _ = h2o_wf_objects()
    jmesh = j_walker_mesh(2)
    jblock = j_make_vmc_block(jwf, {"energy": JEnergy(jmol)}, JGeometry(None), tstep=JAX_TSTEP,
                              nsteps=JAX_NSTEPS, mesh=jmesh)
    args = (jp, jnp.asarray(pos), jnp.zeros((n, 8, 3), jnp.int32), key)
    p_j, _, avg_j = compile_quick(jblock, *args)(*args)
    _, jbranch = jdmc.make_dmc_block(jwf, JEnergy(jmol), JGeometry(None), 0.02, 1, mesh=jmesh)
    bargs = (jnp.asarray(comb["positions"]), jnp.asarray(comb["wrap"]),
             jnp.asarray(comb["weights"]), jax.random.PRNGKey(8))
    jcomb = jax.device_get(compile_quick(jbranch, *bargs)(*bargs))
    jax_out = {"block": (np.asarray(p_j), jax.device_get(avg_j)), "comb": jcomb}
    return ranks.collect(started), ref, jax_out


def _close(a, b, atol, what):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64),
                               atol=atol, rtol=atol, err_msg=what)


@pytest.mark.parametrize("name", list(ranks.MESH_RUNS))
def test_mesh_matches_one_process(runs, name):
    """Two gloo ranks against one process on their concatenated streams:
    the whole population's positions (1e-13), every block average, energy
    and parameter (1e-12; the line minimization's solved ones 1e-10); both
    ranks return the same."""
    (r0, r1, _), ref, _ = runs
    got, want = r0[name], ref[name]
    assert set(got) == set(want)
    for k in want:
        if k == "positions":
            assert got[k].shape == (ranks.NCONF, 8, 3)
            _close(got[k], want[k], POS_ATOL, f"{name} positions")
        elif k == "data":
            assert len(got[k]) == len(want[k])
            for gb, wb in zip(got[k], want[k]):
                assert set(gb) == set(wb)
                for kk in wb:
                    if kk != "block time":
                        _close(gb[kk], wb[kk], AVG_TOL, f"{name} {kk}")
        else:
            tol = SOLVED_TOL if name == "linemin" and k in ("x", "line_energies") else AVG_TOL
            _close(got[k], want[k], tol, f"{name} {k}")
    for k in want:  # the ranks hold the same results
        if k == "data":
            for b0, b1 in zip(r0[name][k], r1[name][k]):
                assert all(np.array_equal(b0[kk], b1[kk]) for kk in b0 if kk != "block time")
        else:
            assert np.array_equal(np.asarray(r0[name][k]), np.asarray(r1[name][k])), k


def test_parameters_identical_on_ranks(runs):
    """Rank 0 solves SR and the ensemble's penalty SR and broadcasts: both
    ranks take the same parameters, bit for bit, and they moved."""
    (r0, r1, _), ref, _ = runs
    for name in ("linemin", "ensemble"):
        assert np.array_equal(r0[name]["x"], r1[name]["x"]), name
    assert r0["linemin"]["tau"] == ref["linemin"]["tau"]
    assert not np.allclose(r0["ensemble"]["x"], [0.5, 0.8])


def test_dmc_comb_is_global(runs):
    """After the last block's comb every weight of the whole population is
    the same (a comb local to each rank leaves only each shard's weights
    uniform)."""
    (r0, _, _), _, _ = runs
    w = r0["dmc"]["weights"]
    assert w.shape == (ranks.NCONF,)
    assert np.all(w == w[0])


@pytest.mark.parametrize("name", ["vmc", "dmc"])
def test_mesh_of_one_is_no_mesh(runs, name):
    """walker_mesh() without a process group makes a group of one (gloo on
    the CPU); VMC and DMC under it equal the runs without a mesh, bit for
    bit."""
    (_, _, r2), _, _ = runs
    assert tuple(r2["mesh"]) == (0, 1, "gloo")
    a, b = r2[f"{name}_mesh1"], r2[f"{name}_nomesh"]
    assert np.array_equal(a["positions"], b["positions"])
    for ba, bb in zip(a["data"], b["data"]):
        assert all(ba[k] == bb[k] for k in bb if k != "block time")


def test_meshed_block_matches_jax(runs):
    """One VMC block on the two ranks fed the JAX shards' own draws against
    JAX's make_vmc_block(mesh=walker_mesh(2)): positions and every average
    to 1e-10."""
    (r0, _, _), _, jax_out = runs
    p_j, avg_j = jax_out["block"]
    got = r0["jax_block"]
    _close(got["positions"], p_j, 1e-10, "positions")
    assert set(got["avg"]) == set(avg_j)
    for k in avg_j:
        _close(got["avg"][k], avg_j[k], 1e-10, k)


def test_global_comb_matches_jax(runs):
    """The port's comb over the two ranks keeps the walkers JAX's meshed
    branch keeps from the same weights and key, in the same order, and
    sets every weight to the global mean."""
    (r0, _, _), _, jax_out = runs
    got, (p_j, r_j, w_j) = r0["comb"], jax_out["comb"]
    np.testing.assert_array_equal(got["positions"], np.asarray(p_j))
    np.testing.assert_array_equal(got["wrap"], np.asarray(r_j))
    np.testing.assert_allclose(got["weights"], np.asarray(w_j), atol=1e-12)
    assert len(np.unique(got["positions"][:, 0, 0])) < ranks.NCONF  # a walker was duplicated


def _fake_mesh(size):
    """A mesh object for the guards, which raise before any collective."""
    return tmesh.WalkerMesh(group=None, rank=0, size=size, device=torch.device("cpu"),
                            backend="gloo")


def test_guards():
    """The JAX package's messages: walkers that do not divide over the
    ranks ("must divide evenly"), a correlated_nconf that does not divide
    ("does not divide"), and a mesh of several ranks without a process
    group."""
    x = torch.zeros(6, 3)
    with pytest.raises(ValueError, match="must divide evenly"):
        tmesh.shard_walkers(_fake_mesh(4), x)
    assert tmesh.pad_to_devices(6, _fake_mesh(4)) == 8
    assert tmesh.pad_to_devices(8, _fake_mesh(4)) == 8
    mol, wf, params, configs, acc = h2o_setup(6, device="cpu")
    with pytest.raises(ValueError, match="must divide evenly"):
        vmc(wf, params, configs, nblocks=1, nsteps_per_block=1, accumulators=acc,
            mesh=_fake_mesh(4))
    mol, mf = load_npz()
    wf, params, to_opt = generate_wf(mol, mf, device="cpu")
    configs = initial_guess(mol, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        line_minimization(wf, params, configs, LinearTransform(params, to_opt),
                          EnergyAccumulator(mol), mesh=_fake_mesh(2), correlated_nconf=3,
                          max_iterations=1)
    with pytest.raises(ValueError, match="must divide evenly"):
        sample_overlap([wf], [params], initial_guess(mol, 6, device="cpu",
                                                     generator=torch.Generator()),
                       torch.Generator(), mesh=_fake_mesh(4))
    if not torch.distributed.is_initialized():
        with pytest.raises(ValueError, match="needs a process group"):
            tmesh.walker_mesh(2)

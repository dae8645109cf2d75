"""The port's periodic pieces against the JAX package, float64, on shared
numpy inputs: the diamond-C fixture's primitive cell (2 C, 8 electrons, 489
replicated-shell AOs at img_tol 1e-4) unless a case says otherwise.

Tolerances: geometry, minimal image, wraps and Ewald 1e-10 (the same
arithmetic in another order); orbitals 1e-10 (sums of 489 AO terms of
O(1)); the Jastrow, the kinetic energy and the ECP energy rtol 1e-9 (sums
of cancelling terms of O(10)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.observables.ecp import ECPAccumulator as JECP
from pyqmc_tpu.observables.ecp import systematic_downselect as j_downselect
from pyqmc_tpu.observables.energy import kinetic_energy as j_kinetic
from pyqmc_tpu.observables.ewald import Ewald as JEwald
from pyqmc_tpu.ops.pbc import enforce_pbc as j_enforce
from pyqmc_tpu.system.supercell import get_supercell as j_get_supercell

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.observables.ecp import ECPAccumulator, systematic_downselect
from pyqmc_tpu_torch.observables.energy import kinetic_energy
from pyqmc_tpu_torch.observables.ewald import Ewald
from pyqmc_tpu_torch.ops.pbc import enforce_pbc
from pyqmc_tpu_torch.system.supercell import get_supercell, primitive_translations

from .torch_parity import (F64, assert_trees_close, cell_walkers, diamond_cells, gamma_params,
                           gamma_jax_recompute, gamma_wf_objects, jax_ecp_streams,
                           kpoint_orbitals)

NCONF = 5


def t64(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def test_get_supercell():
    jcell, _, tcell = diamond_cells()
    S = np.array([[2, 0, 0], [0, 2, 0], [0, 0, 2]])
    js, ts = j_get_supercell(jcell, S), get_supercell(tcell, S)
    np.testing.assert_array_equal(ts.lattice, js.lattice)
    np.testing.assert_array_equal(ts.atom_coords, js.atom_coords)
    assert ts.atom_symbols == js.atom_symbols and ts.nelec == js.nelec == (32, 32)
    assert ts.scale == 8 and len(primitive_translations(np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]]))) == 2


def test_enforce_and_wrap():
    jcell, _, tcell = diamond_cells()
    rng = np.random.default_rng(1)
    x = cell_walkers(rng, jcell.lattice, NCONF, lo=-2.5, hi=3.5)
    jw, jwrap = j_enforce(jnp.asarray(jcell.lattice), jnp.asarray(np.linalg.inv(jcell.lattice)),
                          jnp.asarray(x))
    tw, twrap = Geometry(tcell.lattice).enforce(t64(x))
    assert twrap.dtype == torch.int32 and int(torch.max(torch.abs(twrap))) >= 2
    np.testing.assert_array_equal(twrap.numpy(), np.asarray(jwrap))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-10)
    tw2, twrap2 = enforce_pbc(t64(tcell.lattice), t64(np.linalg.inv(tcell.lattice)), t64(x))
    assert torch.equal(tw2, tw) and torch.equal(twrap2, twrap)


LATTICES = {
    "diagonal": np.diag([3.0, 4.0, 5.5]),
    "orthorhombic": np.array([[3.0, 3.0, 0.0], [-2.0, 2.0, 0.0], [0.0, 0.0, 4.5]]),
    "general": 2 * np.array([[0.0, 3.37013757, 3.37013757], [3.37013757, 0.0, 3.37013757],
                             [3.37013757, 3.37013757, 0.0]]),
}


@pytest.mark.parametrize("name", sorted(LATTICES))
def test_minimal_image(name):
    lat = LATTICES[name]
    jg, tg = JGeometry(lat), Geometry(lat)
    assert tg.mode == jg.mode == name
    d = np.random.default_rng(2).uniform(-1.5, 1.5, size=(40, 3)) @ lat
    np.testing.assert_allclose(tg.minimal_image(t64(d)).numpy(),
                               np.asarray(jg.minimal_image(jnp.asarray(d))), atol=1e-10)
    rc = tg.half_min_height()
    assert rc == pytest.approx(jg.half_min_height(), abs=1e-14)
    np.testing.assert_allclose(tg.minimal_image_for(rc)(t64(d)).numpy(),
                               np.asarray(jg.minimal_image_for(rc)(jnp.asarray(d))), atol=1e-10)


def test_ewald():
    jcell, _, tcell = diamond_cells()
    je, te = JEwald(jcell), Ewald(tcell)
    assert te.ii_const == pytest.approx(je.ii_const, abs=1e-10)
    assert len(te.gpoints) == len(je.gpoints) and len(te.images) == len(je.images)
    x = cell_walkers(np.random.default_rng(3), jcell.lattice, NCONF)
    for a, b in zip(te.energy(t64(x)), jax.jit(je.energy)(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=1e-12)


@functools.lru_cache(maxsize=None)
def _gamma_state():
    jwf, twf = gamma_wf_objects()
    rng = np.random.default_rng(4)
    jp, tp = gamma_params(rng)
    jcell, _, _ = diamond_cells()
    x = cell_walkers(rng, jcell.lattice, NCONF)
    js = gamma_jax_recompute()(jp, jnp.asarray(x))
    ts = twf.recompute(tp, t64(x))
    return jp, tp, x, js, ts


def test_gamma_state_and_jastrow():
    """recompute of the Slater-Jastrow (Slater state leaves and Jastrow U),
    and the Jastrow's gradient and laplacian of one electron."""
    jwf, twf = gamma_wf_objects()
    jp, tp, x, js, ts = _gamma_state()
    assert_trees_close(ts, js, atol=1e-9, rtol=1e-9)
    jj, tj = jwf.wfs[1], twf.wfs[1]
    g_j, l_j = jax.jit(jj.gradient_laplacian)(jp["wf1"], js[1], jnp.int32(5), jnp.asarray(x[:, 5]))
    g_t, l_t = tj.gradient_laplacian(tp["wf1"], ts[1], 5, t64(x[:, 5]))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("nk", [1, 8])
def test_kpoint_orbitals(nk):
    """Modes 0, 1, 2 and eval_mo_t at 32 points spread over a 2x2x2
    supercell, so the primitive fold and (at 8 TRIM k-points) the wrap
    signs are exercised."""
    jorb, torb = kpoint_orbitals(nk)
    assert torb.real_mode and jorb.real_mode and torb._repl_spec.nao == jorb._repl_spec.nao == 489
    np.testing.assert_array_equal(torb._korb, jorb._korb)
    np.testing.assert_array_equal(torb._repl_phase, jorb._repl_phase)
    jcell, _, _ = diamond_cells()
    X = np.random.default_rng(5).uniform(-0.2, 2.2, size=(32, 3)) @ jcell.lattice
    jparams = jorb.make_params()
    from pyqmc_tpu_torch.convert import params_from_numpy

    tparams = params_from_numpy(jax.device_get(jparams), device="cpu", dtype=F64)
    assert isinstance(tparams["mo_coeff_alpha"], list) and len(tparams["mo_coeff_alpha"]) == nk
    out_j = jax.jit(lambda p, xx: [jorb.eval(p, xx, m) for m in (0, 1, 2)] + [
        jorb.eval_mo_t(p, xx)])(jparams, jnp.asarray(X))
    out_t = [torb.eval(tparams, t64(X), m) for m in (0, 1, 2)] + [torb.eval_mo_t(tparams, t64(X))]
    assert_trees_close(out_t, out_j, atol=1e-10)


def test_systematic_downselect():
    """The same T and uniforms pick the same points with the same weights;
    compared as sets of (index, weight) pairs per walker, since top-k may
    order its picks differently."""
    rng = np.random.default_rng(6)
    T = rng.normal(size=(7, 12)) * rng.uniform(0.0, 1.0, size=(7, 12))
    T[3] = 0.0  # no mass left for the stochastic picks
    u = rng.uniform(size=7)
    ji, jw = jax.jit(lambda t, uu: j_downselect(t, 8, None, u=uu))(jnp.asarray(T),
                                                                  jnp.asarray(u)[:, None])
    ti, tw = systematic_downselect(t64(T), 8, t64(u))
    for c in range(7):
        a = sorted(zip(ti[c].tolist(), tw[c].tolist()))
        b = sorted(zip(np.asarray(ji[c]).tolist(), np.asarray(jw[c]).tolist()))
        assert [i for i, _ in a] == [i for i, _ in b]
        np.testing.assert_allclose([w for _, w in a], [w for _, w in b], rtol=1e-12)


def test_ecp_downselected_flat_path():
    """The ECP energy with nselect=8 of the 12 points (the primitive cell
    stays dense under "auto"): the downselected flat path
    (observables/ecp.py:660-749), in the port both in chunks of 3 electrons
    (mixed spins in a chunk) and in one chunk, against the JAX package's one
    chunk. The draws are per electron, so chunks do not change the energy."""
    jwf, twf = gamma_wf_objects()
    jp, tp, x, js, ts = _gamma_state()
    jcell, _, tcell = diamond_cells()
    jecp = JECP(jcell, nselect=8, echunk=8)
    assert ECPAccumulator(tcell).nselect is None  # 12 points stay dense under "auto"
    key = jax.random.PRNGKey(7)
    e_j = jax.jit(lambda p, s, xx: jecp(jwf, p, s, xx, key))(jp, js, jnp.asarray(x))
    rot, u = jax_ecp_streams(key, 8, NCONF)
    for echunk in (3, 8):
        tecp = ECPAccumulator(tcell, nselect=8, echunk=echunk)
        assert tecp._mic_fast == jecp._mic_fast and tecp.nselect == 8
        e_t = tecp(twf, tp, ts, t64(x), t64(rot), t64(u))
        np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=1e-9, atol=1e-12)
    assert float(np.std(np.asarray(e_j))) > 1e-3


def test_kinetic_energy_batched():
    """kinetic_energy over electron chunks (3 per chunk and all at once)
    against the JAX package's vmapped evaluation."""
    jwf, twf = gamma_wf_objects()
    jp, tp, x, js, ts = _gamma_state()
    ke_j, g2_j = jax.jit(lambda p, s, xx: j_kinetic(jwf, p, s, xx))(jp, js, jnp.asarray(x))
    for echunk in (3, "auto"):
        ke_t, g2_t = kinetic_energy(twf, tp, ts, t64(x), echunk=echunk)
        np.testing.assert_allclose(ke_t.numpy(), np.asarray(ke_j), rtol=1e-9)
        np.testing.assert_allclose(g2_t.numpy(), np.asarray(g2_j), rtol=1e-9)


def test_gate():
    """_match_sj_pbc accepts the diamond Slater-Jastrow and rejects what the
    JAX gate rejects: an open geometry, a Jastrow on another lattice, a
    cutoff beyond half the smallest cell height, a molecular Slater."""
    from pyqmc_tpu.models.jastrow import JastrowSpin as JJastrow
    from pyqmc_tpu.models.multiply import MultiplyWF as JMultiply
    from pyqmc_tpu.ops.move_pallas_pbc import _match_sj_pbc as j_gate

    from pyqmc_tpu_torch.models.jastrow import JastrowSpin
    from pyqmc_tpu_torch.models.multiply import MultiplyWF
    from pyqmc_tpu_torch.models.slater import Slater
    from pyqmc_tpu_torch.ops.move_sweep_pbc import _match_sj_pbc

    from .torch_parity import h2o_wf_objects

    jwf, twf = gamma_wf_objects()
    jcell, _, tcell = diamond_cells()
    jsl, tsl = jwf.wfs[0], twf.wfs[0]
    far = 2.0 * LATTICES["general"]
    cases = {
        "diamond": (jwf, twf, jcell.lattice),
        "slater alone": (jsl, tsl, jcell.lattice),
        "open geometry": (jwf, twf, None),
        "jastrow lattice differs": (JMultiply(jsl, JJastrow(jcell, geometry=JGeometry(far))),
                                    MultiplyWF(tsl, JastrowSpin(tcell, geometry=Geometry(far))),
                                    jcell.lattice),
        "cutoff beyond half height": (JMultiply(jsl, JJastrow(jcell)),
                                      MultiplyWF(tsl, JastrowSpin(tcell)), jcell.lattice),
        "molecular slater": (h2o_wf_objects()[0], h2o_wf_objects()[1], jcell.lattice),
    }
    for name, (jw, tw, lat) in cases.items():
        jm = j_gate(jw, JGeometry(lat))
        tm = _match_sj_pbc(tw, Geometry(lat))
        assert (jm is None) == (tm is None), name
        assert (tm is not None) == (name in ("diamond", "slater alone")), name
        if tm is not None:
            assert tm[2:4] == jm[2:4] and isinstance(tm[0], Slater)


def test_value_mo_chunk_table():
    """K3's walk over the basis (GTOTables.chunks, appended to its int
    table): on the H2O and the diamond bases every concat row lies in
    exactly one chunk, in order; no chunk holds more than CHUNK_AOS AOs; no
    shell is split (a chunk is whole shells of one l-group)."""
    from pyqmc_tpu_torch.models.orbitals import KPointOrbitals
    from pyqmc_tpu_torch.ops.gto import GTOSpec
    from pyqmc_tpu_torch.ops.gto_kernels import CHUNK_AOS, T_I_CHUNKS, T_NCHUNKS, GTOTables
    from pyqmc_tpu_torch.system.io import load_npz

    _, d, tcell = diamond_cells()
    blocks = [np.asarray(d["mo_coeff"][0])[:, :4]]
    diamond = KPointOrbitals(tcell, np.asarray(d["kpts"])[:1], (blocks, blocks), img_tol=1e-4)
    for spec in (GTOSpec.from_molecule(load_npz()[0]), diamond._repl_spec):
        tables = GTOTables(spec)
        chunks = tables.chunks
        meta = tables._meta
        np.testing.assert_array_equal(
            meta[meta[T_I_CHUNKS]:meta[T_I_CHUNKS] + chunks.size].reshape(-1, 4), chunks)
        assert meta[T_NCHUNKS] == len(chunks)
        shell_rows = {}  # (group, shell) -> its concat rows
        row = 0
        for gi, g in enumerate(spec.groups):
            ns = 2 * g.l + 1
            for si in range(g.alpha.shape[0]):
                shell_rows[(gi, si)] = list(range(row, row + ns))
                row += ns
        assert row == spec.nao
        covered = []
        for gi, si0, nsh, row0 in chunks.tolist():
            rows = [r for si in range(si0, si0 + nsh) for r in shell_rows[(gi, si)]]
            assert 0 < len(rows) <= CHUNK_AOS and rows[0] == row0
            covered += rows
        assert covered == list(range(spec.nao))


@functools.lru_cache(maxsize=None)
def _kpoint_slaters():
    """The diamond configuration's Slater on both sides: the 2x2x2
    supercell, 8 TRIM k-points x 4 orbitals per spin, single(32, 32):
    (jax supercell, jax Slater, jax params, port supercell, port Slater,
    port params)."""
    from pyqmc_tpu.models.slater import DeterminantExpansion as JExpansion
    from pyqmc_tpu.models.slater import Slater as JSlater

    from pyqmc_tpu_torch.convert import params_from_numpy
    from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater

    jcell, _, tcell = diamond_cells()
    S = 2 * np.eye(3, dtype=int)
    jsup, tsup = j_get_supercell(jcell, S), get_supercell(tcell, S)
    jorb, torb = kpoint_orbitals(8)
    jsl = JSlater(jsup, jorb, JExpansion.single(32, 32))
    tsl = Slater(tsup, orbitals=torb, expansion=DeterminantExpansion.single(32, 32))
    jp = jsl.make_params()
    return jsup, jsl, jp, tsup, tsl, params_from_numpy(jax.device_get(jp), device="cpu",
                                                        dtype=F64)


def test_kpoint_pgradient_matches_jax():
    """pgradient of the k-point Slater (real mode) at 2 walkers of the
    supercell against the JAX package's _pgradient_kpoint: det_coeff and
    every k-point's block of both spins to 1e-10."""
    jsup, jsl, jp, _, tsl, tp = _kpoint_slaters()
    x = cell_walkers(np.random.default_rng(3), jsup.lattice, 2, nelec=64, lo=-0.1, hi=1.1)
    g_j = jax.jit(jsl.pgradient)(jp, jnp.asarray(x))
    g_t = tsl.pgradient(tp, t64(x))
    assert [len(g_t[k]) for k in ("mo_coeff_alpha", "mo_coeff_beta")] == [8, 8]
    assert g_t["mo_coeff_alpha"][5].shape == (2,) + tuple(tp["mo_coeff_alpha"][5].shape)
    assert_trees_close(g_t, g_j, atol=1e-10)
    assert all(float(torch.max(torch.abs(b))) > 1e-3 for b in g_t["mo_coeff_beta"])


def test_kpoint_slater_run_all():
    """testwf.run_all on the k-point Slater, its pgradient against finite
    differences included."""
    from pyqmc_tpu_torch.configs import initial_guess
    from pyqmc_tpu_torch.models import testwf

    _, _, _, tsup, tsl, tp = _kpoint_slaters()
    configs = initial_guess(tsup, 2, generator=torch.Generator().manual_seed(4), device="cpu",
                            dtype=F64)
    testwf.run_all(tsl, tp, configs, torch.Generator().manual_seed(5))

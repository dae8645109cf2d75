"""The port's Metropolis sweep against the JAX package's XLA sweep.

The plain sweep (ops/move_sweep.py:sweep_plain, run by the FusedSweep
wrapper for CPU tensors) and a copy of method/vmc.py's sweep consume the
same gauss/unif, so in float64 they produce the same chain: positions,
acceptance and every state leaf agree to 1e-9 (absolute, and relative for
the determinant inverses, whose entries reach O(100)), the tolerance of
tests/unit/test_move_pallas.py. The CUDA kernel itself runs only on the
GPU (chip_smoke.py); here its host half, the packed tables, is decoded and
checked against the plain evaluation.

The Pallas interpret-mode sweep at STO-3G size is not a case here: it
takes about 27 s on the CPU, over this file's budget.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyqmc_tpu.configs import Geometry as JGeometry
from pyqmc_tpu.method.vmc import limdrift as j_limdrift
from pyqmc_tpu.models.multiply import default_move_begin, default_move_finish

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.models.jastrow import JastrowSpin
from pyqmc_tpu_torch.models.multiply import MultiplyWF
from pyqmc_tpu_torch.models.slater import Slater
from pyqmc_tpu_torch.ops import move_sweep
from pyqmc_tpu_torch.ops.gto import eval_gto
from pyqmc_tpu_torch.ops.harmonics import cart_components
from pyqmc_tpu_torch.ops.move_sweep import SJTables, build_fused_sweep, sweep_plain

from .torch_parity import (F64, assert_trees_close, bc_pair, h2o_pair, h2o_params, h2o_wf_objects,
                           walkers)

TSTEP = 0.5


@functools.lru_cache(maxsize=None)
def _jax_sweep():
    """method/vmc.py's sweep (open boundary), jitted with a traced e."""
    jwf, _ = h2o_wf_objects()
    geometry = JGeometry(None)

    def sweep(params, positions, state, gauss_step, unif_step):
        def ebody(e, carry):
            positions, state, acc = carry
            epos = positions[:, e, :]
            grad_old, aux = default_move_begin(jwf, params, state, e, epos)
            drift_old = j_limdrift(grad_old)
            gauss = gauss_step[e]
            newpos, _ = geometry.enforce(epos + gauss + TSTEP * drift_old)
            grad_new, ratio, saved = default_move_finish(jwf, params, state, e, newpos, aux)
            drift_new = j_limdrift(grad_new)
            forward = jnp.sum(gauss * gauss, axis=-1)
            backward = jnp.sum((gauss + TSTEP * (drift_old + drift_new)) ** 2, axis=-1)
            t_prob = jnp.exp((forward - backward) / (2.0 * TSTEP))
            accept = jnp.abs(ratio) ** 2 * t_prob > unif_step[e]
            state = jwf.updateinternals(params, state, e, newpos, accept, saved)
            positions = positions.at[:, e, :].set(jnp.where(accept[:, None], newpos, epos))
            return positions, state, acc + jnp.mean(accept.astype(positions.dtype))

        return jax.lax.fori_loop(0, jwf.nelec, ebody, (positions, state, jnp.zeros(())))

    return jax.jit(jwf.recompute), jax.jit(sweep)


@pytest.mark.parametrize("seed", [31, 32])
def test_sweep_matches_jax_xla_sweep(seed):
    rng = np.random.default_rng(seed)
    jwf, twf = h2o_wf_objects()
    jp, tp = h2o_params(rng)
    nconf, nelec = 6, twf.nelec
    pos = walkers(rng, nconf)
    gauss = rng.normal(size=(nelec, nconf, 3)) * np.sqrt(TSTEP)
    unif = rng.uniform(size=(nelec, nconf))
    recompute, jsweep = _jax_sweep()
    js = recompute(jp, jnp.asarray(pos))
    p_j, st_j, acc_j = jsweep(jp, jnp.asarray(pos), js, jnp.asarray(gauss), jnp.asarray(unif))

    sweep = build_fused_sweep(twf, Geometry(), TSTEP)
    assert sweep is not None  # the main-path wavefunction is inside the gate
    tpos = torch.as_tensor(pos, dtype=F64)
    wrap = torch.zeros((nconf, nelec, 3), dtype=torch.int32)
    ts = twf.recompute(tp, tpos)
    p_t, w_t, st_t, acc_t = sweep(tp, tpos, wrap, ts, torch.as_tensor(gauss, dtype=F64),
                                  torch.as_tensor(unif, dtype=F64))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-9)
    assert float(acc_t) == pytest.approx(float(acc_j), abs=1e-12)
    assert 0 < float(acc_t) < nelec  # some moves accepted, some rejected
    assert_trees_close(st_j, st_t, atol=1e-9, rtol=1e-9)
    assert torch.equal(w_t, wrap)
    assert torch.equal(tpos, torch.as_tensor(pos, dtype=F64))  # inputs untouched


def test_gate():
    """Outside the JAX gate the builder returns None (the block then runs
    sweep_plain), in both modes: a Jastrow alone, a Slater with extra
    orbitals, and each further check of move_pallas._match_sj that the
    port's classes can express."""
    import copy
    import types

    from pyqmc_tpu_torch.models.slater import DeterminantExpansion

    _, tmf = h2o_pair()[1]
    mol = tmf.mol
    assert build_fused_sweep(JastrowSpin(mol), Geometry(), TSTEP) is None
    wide = Slater(mol, None, DeterminantExpansion.single(4, 4),
                  (tmf.mo_coeff[0][:, :6], tmf.mo_coeff[1][:, :4]))
    assert build_fused_sweep(MultiplyWF(wide, JastrowSpin(mol)), Geometry(), TSTEP) is None
    good = Slater.from_mean_field(tmf)
    for mode in move_sweep.MODES:
        assert build_fused_sweep(good, Geometry(), TSTEP, mode=mode) is not None
        assert build_fused_sweep(MultiplyWF(good, JastrowSpin(mol)), Geometry(), TSTEP,
                                 mode=mode).mode == mode
    match = move_sweep._match_sj

    def variant(**attrs):
        sl = copy.copy(good)
        for k, v in attrs.items():
            setattr(sl, k, v)
        return sl

    # a periodic geometry
    assert match(good, types.SimpleNamespace(lattice=np.eye(3))) is None
    # a third factor, or two of a kind
    assert match(MultiplyWF(good, JastrowSpin(mol), JastrowSpin(mol)), Geometry()) is None
    # orbitals that are not MolecularOrbitals
    assert match(variant(orbitals=types.SimpleNamespace(norb=(4, 4))), Geometry()) is None
    # an empty spin channel
    assert match(variant(ndn=0), Geometry()) is None
    # two determinants
    two = DeterminantExpansion(occ_up=np.array([[0, 1, 2, 3], [0, 1, 2, 4]]),
                               occ_dn=np.arange(4)[None, :], map_up=np.array([0, 1]),
                               map_dn=np.array([0, 0]))
    assert match(variant(expansion=two), Geometry()) is None
    # one determinant that does not occupy the first n orbitals
    excited = DeterminantExpansion(occ_up=np.array([[0, 1, 2, 4]]), occ_dn=np.arange(4)[None, :],
                                   map_up=np.zeros(1, np.int64), map_dn=np.zeros(1, np.int64))
    assert match(variant(expansion=excited), Geometry()) is None
    # a Jastrow basis the kernels do not know, and a periodic Jastrow
    odd = JastrowSpin(mol)
    odd.b_basis = tuple(odd.b_basis[:-1]) + (types.SimpleNamespace(kind="gaussian"),)
    assert match(MultiplyWF(good, odd), Geometry()) is None
    periodic = JastrowSpin(mol)
    periodic.geometry = types.SimpleNamespace(lattice=np.eye(3))
    assert match(MultiplyWF(good, periodic), Geometry()) is None
    assert match(MultiplyWF(good, JastrowSpin(mol)), Geometry()) is not None


def _decode_ao(tab, meta, x):
    """AO values at points x (M, 3) in concat order, read from the packed
    tables the way csrc/gto_device.cuh reads them."""
    ngroups, g0 = meta[move_sweep.M_NGROUPS], meta[move_sweep.M_I_GROUPS]
    rows = []
    for gi in range(ngroups):
        l, S, P, fcen, falpha, fcoef, fcw, row0 = meta[g0 + 8 * gi: g0 + 8 * gi + 8]
        ns = 2 * l + 1
        cen = tab[fcen: fcen + 3 * S].reshape(S, 3)
        alpha = tab[falpha: falpha + S * P].reshape(S, P)
        coef = tab[fcoef: fcoef + S * P].reshape(S, P)
        cw = tab[fcw: fcw + len(cart_components(l)) * ns].reshape(-1, ns)
        assert row0 == sum(r.shape[1] for r in rows)
        for si in range(S):
            r = x - cen[si]
            g = np.sum(coef[si] * np.exp(-np.sum(r * r, axis=1)[:, None] * alpha[si]), axis=1)
            mono = np.stack([r[:, 0] ** i * r[:, 1] ** j * r[:, 2] ** k
                             for (i, j, k) in cart_components(l)], axis=1)
            rows.append((mono * g[:, None]) @ cw)
    return np.concatenate(rows, axis=1)


def test_sj_tables_decode():
    """The kernels' packed tables hold the basis in concat order, the MO
    coefficients permuted to match, and the Jastrow coefficients: decoding
    them reproduces the plain AO x MO evaluation and the parameters."""
    rng = np.random.default_rng(41)
    _, twf = h2o_wf_objects()
    _, tp = h2o_params(rng)
    slater, jastrow = twf.wfs
    tables = SJTables(slater, jastrow)
    tab_t, meta_t = tables.pack(tp["wf0"], tp["wf1"], "cpu", F64)
    tab, meta = tab_t.numpy(), meta_t.numpy()
    nao, nup = meta[move_sweep.M_NAO], meta[move_sweep.M_NUP]
    assert (nao, nup, meta[move_sweep.M_NDN], meta[move_sweep.M_HASJ]) == (23, 4, 4, 1)
    x = rng.normal(scale=1.5, size=(9, 3))
    ao_concat = _decode_ao(tab, meta, x)
    ca = tab[meta[move_sweep.M_F_CA]: meta[move_sweep.M_F_CA] + nao * nup].reshape(nao, nup)
    ao = eval_gto(slater.orbitals.spec, torch.as_tensor(x, dtype=F64), 0)
    np.testing.assert_allclose(ao_concat @ ca, (ao @ tp["wf0"]["mo_coeff_alpha"]).numpy(),
                               atol=1e-12)
    fa, fb = meta[move_sweep.M_F_ACOEFF], meta[move_sweep.M_F_BCOEFF]
    np.testing.assert_array_equal(tab[fa: fa + 3 * 4 * 2], tp["wf1"]["acoeff"].numpy().ravel())
    np.testing.assert_array_equal(tab[fb: fb + 4 * 3], tp["wf1"]["bcoeff"].numpy().ravel())
    assert len(tab) == tables.ntab
    tables.check(torch.float32)  # inside the kernels' caps


def test_sj_tables_decode_quadrature():
    """The ECP kernel's quadrature section: one quadrature atom (O) with 6
    points, its nonlocal channel's terms and coordinates, as
    csrc/ecp_energy.cu reads them."""
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator, ecp_quadrature_grid

    (_, _), (tmol, _) = h2o_pair()
    _, twf = h2o_wf_objects()
    acc = ECPAccumulator(tmol)
    tables = SJTables(*twf.wfs, ecp_acc=acc)
    tab_t, meta_t = tables.pack(*twf.make_params(device="cpu").values(), "cpu", F64)
    tab, meta = tab_t.numpy(), meta_t.numpy()
    assert meta[move_sweep.M_NQATOMS] == 1 and tables.nq_total == 6
    npts, fpts, nchan, ichans, fcoord = meta[meta[move_sweep.M_I_QATOMS]:][:5]
    pts, w = ecp_quadrature_grid(6)
    np.testing.assert_array_equal(tab[fpts: fpts + 4 * npts].reshape(npts, 4),
                                  np.concatenate([pts, w[:, None]], axis=1))
    np.testing.assert_array_equal(tab[fcoord: fcoord + 3], tmol.atom_coords[0])
    (ch,) = acc.nl_atoms[0].nonlocal_channels
    l, nterm, fterms = meta[ichans: ichans + 3]
    assert (nchan, l, nterm) == (1, ch.l, len(ch.coeffs))
    np.testing.assert_array_equal(tab[fterms: fterms + 3 * nterm].reshape(nterm, 3),
                                  np.stack([ch.coeffs, ch.exps, ch.powers], axis=1))
    assert tab[meta[move_sweep.M_F_RMAX]] == acc.rmax


def test_sj_tables_decode_quadrature_heterogeneous():
    """SJTables emits the quadrature atoms as the JAX kernel does: grids in
    ascending size (C, 6 points, before B, 12 points), each with its own
    channels and coordinates."""
    _, _, _, tmol, twf, tp = bc_pair()
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator

    acc = ECPAccumulator(tmol)
    tables = SJTables(*twf.wfs, ecp_acc=acc)
    tab_t, meta_t = tables.pack(tp["wf0"], tp["wf1"], "cpu", F64)
    tab, meta = tab_t.numpy(), meta_t.numpy()
    assert meta[move_sweep.M_NQATOMS] == 2 and tables.nq_total == 18
    q0 = meta[move_sweep.M_I_QATOMS]
    for qi, atom in enumerate([1, 0]):  # C, then B
        npts, fpts, nchan, ichans, fcoord = meta[q0 + 5 * qi: q0 + 5 * qi + 5]
        aecp = acc.nl_atoms[atom]
        assert npts == acc.atom_naip[atom] and nchan == len(aecp.nonlocal_channels)
        np.testing.assert_array_equal(tab[fcoord: fcoord + 3], tmol.atom_coords[atom])
        pts, w = acc.atom_quad[atom]
        np.testing.assert_array_equal(tab[fpts: fpts + 4 * npts].reshape(npts, 4),
                                      np.concatenate([pts, w[:, None]], axis=1))
        for ci, ch in enumerate(aecp.nonlocal_channels):
            l, nterm, fterms = meta[ichans + 3 * ci: ichans + 3 * ci + 3]
            assert (l, nterm) == (ch.l, len(ch.coeffs))
            np.testing.assert_array_equal(tab[fterms: fterms + 3 * nterm].reshape(nterm, 3),
                                          np.stack([ch.coeffs, ch.exps, ch.powers], axis=1))
    tables.check(torch.float32)


def test_sweep_plain_keeps_wrap_and_state_inputs():
    """sweep_plain works on copies: the caller's positions, wrap and state
    survive (the chip check compares kernel and plain from one state)."""
    rng = np.random.default_rng(51)
    _, twf = h2o_wf_objects()
    _, tp = h2o_params(rng)
    pos = torch.as_tensor(walkers(rng, 3), dtype=F64)
    wrap = torch.zeros((3, 8, 3), dtype=torch.int32)
    st = twf.recompute(tp, pos)
    before = [t.clone() for t in (pos, st[0].inv_up, st[0].mog_dn, st[1].positions, st[1].u)]
    gauss = torch.as_tensor(rng.normal(size=(8, 3, 3)) * 0.7, dtype=F64)
    unif = torch.zeros((8, 3), dtype=F64)  # accept every finite move
    p2, _, st2, acc = sweep_plain(twf, Geometry(), TSTEP, 1.0, tp, pos, wrap, st, gauss, unif)
    after = (pos, st[0].inv_up, st[0].mog_dn, st[1].positions, st[1].u)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert float(acc) == 8.0 and not torch.equal(p2, pos)

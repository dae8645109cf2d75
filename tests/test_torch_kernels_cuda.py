"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip (decided in
the fixture, never at import). On the GPU machine, which has no jax (that
tests/conftest.py imports):

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

float64 at a small size, so every accept decision is the same on both
sides: positions and state to 1e-9 (absolute, and relative for inverse
entries near a node), acceptance exactly, ECP energy to rtol 1e-9 (and in
float32 to 1e-4); the H2O kernels at 64, 37 and 6 walkers (the last block
of 128 / G walkers partly empty), K2 also for a Slater determinant with no
Jastrow, and K1, K2, K4, K5 once more with 6 + 4 electrons (their NMAX = 16
instances); the
periodic kernels K3, K6 (to 1e-9 of each entry plus the largest entry) and
K7 in both modes (state, wrap counts; r2p and r2a in the dmc mode) on the
diamond supercell at 37 and at 6 walkers, counts that leave the last
block of the sweep's 4 walkers (groups of 4 warps) partly empty; K3 also
at 1037 points (not a multiple of its 128-point tile) with 8, 32 and 64
orbital columns on the diamond's and on H2O's basis. The full
production-size checks, float32 included, are in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.entry import h2o_setup
from pyqmc_tpu_torch.method.vmc import draw_streams
from pyqmc_tpu_torch.ops import ecp_energy, move_sweep


@pytest.fixture(params=[64, 37, 6])
def cuda_h2o(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    nconf = request.param
    mol, wf, params, configs, acc = h2o_setup(nconf, device="cuda", dtype=torch.float64, seed=3)
    rng = np.random.default_rng(4)
    params["wf1"]["acoeff"] = torch.as_tensor(rng.normal(scale=0.1, size=(3, 4, 2)),
                                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    streams = draw_streams(gen, 1, 8, nconf, 0.5, "cuda", torch.float64)
    return wf, params, configs, acc["energy"].ecp_acc, streams


def _close(a, b, tol):
    return bool(torch.all(torch.abs(a - b) <= tol * (1 + torch.abs(b))))


@pytest.mark.cuda
def test_sweep_kernel_matches_plain(cuda_h2o):
    wf, params, configs, _, streams = cuda_h2o
    sweep = move_sweep.build_fused_sweep(wf, Geometry(), 0.5)
    state = wf.recompute(params, configs.positions)
    args = (params, configs.positions, configs.wrap, state, streams["gauss"][0],
            streams["unif"][0])
    n0 = move_sweep.LAUNCHES.n
    pk, _, sk, ak = sweep(*args)  # CUDA tensors: the wrapper launches the kernel
    pp, _, sp, ap = sweep.plain(*args)
    assert move_sweep.LAUNCHES.n == n0 + 1
    # the same count of accepted moves (per-walker counts and per-electron
    # means are summed in two orders)
    nconf = configs.positions.shape[0]
    assert abs(float(ak) - float(ap)) * nconf < 0.5
    assert _close(pk, pp, 1e-9)
    for a, b in zip(sk[0] + sk[1], sp[0] + sp[1]):
        assert _close(a, b, 1e-9)


@pytest.mark.cuda
def test_ecp_kernel_matches_plain(cuda_h2o):
    wf, params, configs, ecp_acc, streams = cuda_h2o
    fn = ecp_energy.build_fused_ecp_energy(wf, ecp_acc)
    state = wf.recompute(params, configs.positions)
    n0 = ecp_energy.LAUNCHES.n
    ek = fn(params, configs.positions, state, streams["rot"][0])
    ep = fn.plain(params, configs.positions, state, streams["rot"][0])
    assert ecp_energy.LAUNCHES.n == n0 + 1
    scale = float(torch.mean(torch.abs(ep)))
    assert bool(torch.all(torch.abs(ek - ep) <= 1e-9 * (torch.abs(ep) + scale)))


def _ecp_matches_plain(fn, params, positions, state, rot, tol):
    """K2 against ecp_nonlocal_plain on the same inputs, rtol `tol` with a
    floor at the mean magnitude (walkers whose channels cancel to ~0), one
    launch."""
    n0 = ecp_energy.LAUNCHES.n
    ek = fn(params, positions, state, rot)  # CUDA tensors: the wrapper launches the kernel
    ep = ecp_energy.ecp_nonlocal_plain(fn.ecp_acc, fn.wf, params, positions, state, rot)
    assert ecp_energy.LAUNCHES.n == n0 + 1
    assert ek.shape == ep.shape == (positions.shape[0],) and ek.dtype == positions.dtype
    scale = float(torch.mean(torch.abs(ep)))
    assert scale > 1e-3  # the nonlocal part is exercised
    assert bool(torch.all(torch.abs(ek - ep) <= tol * (torch.abs(ep) + scale)))


@pytest.mark.cuda
def test_ecp_kernel_float32_matches_plain(cuda_h2o):
    """float32 to 1e-4, as chip_smoke.py phase 2 holds it."""
    wf, params, configs, ecp_acc, streams = cuda_h2o
    f32 = torch.float32
    params = {k: {n: v.to(f32) for n, v in p.items()} for k, p in params.items()}
    pos = configs.positions.to(f32)
    fn = ecp_energy.build_fused_ecp_energy(wf, ecp_acc)
    _ecp_matches_plain(fn, params, pos, wf.recompute(params, pos), streams["rot"][0].to(f32),
                       1e-4)


@pytest.mark.cuda
def test_ecp_kernel_slater_only_matches_plain(cuda_h2o):
    """A Slater determinant with no Jastrow factor (the tables' hasj = 0)."""
    wf, params, configs, ecp_acc, streams = cuda_h2o
    slater = wf.wfs[0]
    fn = ecp_energy.build_fused_ecp_energy(slater, ecp_acc)
    assert fn is not None and fn.jastrow is None
    pos = configs.positions
    _ecp_matches_plain(fn, params["wf0"], pos, slater.recompute(params["wf0"], pos),
                       streams["rot"][0], 1e-9)


@pytest.mark.cuda
def test_ecp_kernel_nmax16_matches_plain():
    """K2's NMAX = 16 instance on `_nmax16_system`, 37 walkers, float64."""
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator

    nconf = 37
    mol, wf, params, configs = _nmax16_system(nconf)
    fn = ecp_energy.build_fused_ecp_energy(wf, ECPAccumulator(mol))
    gen = torch.Generator(device="cuda").manual_seed(5)
    rot = draw_streams(gen, 1, 10, nconf, 0.5, "cuda", torch.float64)["rot"][0]
    pos = configs.positions
    _ecp_matches_plain(fn, params, pos, wf.recompute(params, pos), rot, 1e-9)


@pytest.mark.cuda
def test_dmc_sweep_kernel_matches_plain(cuda_h2o):
    """The dmc-mode sweep: the vmc checks plus r2p and r2a per walker."""
    wf, params, configs, _, streams = cuda_h2o
    sweep = move_sweep.build_fused_sweep(wf, Geometry(), 0.5, mode="dmc")
    state = wf.recompute(params, configs.positions)
    args = (params, configs.positions, configs.wrap, state, streams["gauss"][0],
            streams["unif"][0])
    n0, v0 = move_sweep.DMC_LAUNCHES.n, move_sweep.LAUNCHES.n
    pk, _, sk, (ak, r2pk, r2ak) = sweep(*args)
    pp, _, sp, (ap, r2pp, r2ap) = sweep.plain(*args)
    assert (move_sweep.DMC_LAUNCHES.n, move_sweep.LAUNCHES.n) == (n0 + 1, v0)
    nconf = configs.positions.shape[0]
    assert abs(float(ak) - float(ap)) * nconf < 0.5 and 0 < float(ak) < 8
    assert _close(pk, pp, 1e-9) and _close(r2pk, r2pp, 1e-9) and _close(r2ak, r2ap, 1e-9)
    for a, b in zip(sk[0] + sk[1], sp[0] + sp[1]):
        assert _close(a, b, 1e-9)


@pytest.mark.cuda
def test_tmove_kernel_matches_plain(cuda_h2o):
    """The T-move sweep at a large tau, so that walkers do move."""
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams
    from pyqmc_tpu_torch.ops import tmove_sweep

    wf, params, configs, ecp_acc, _ = cuda_h2o
    gen = torch.Generator(device="cuda").manual_seed(6)
    streams = draw_dmc_streams(gen, 1, 8, configs.positions.shape[0], 0.5, "cuda", torch.float64)
    tmove = tmove_sweep.build_fused_tmove_sweep(wf, Geometry(), ecp_acc, 0.5)
    state = wf.recompute(params, configs.positions)
    args = (params, configs.positions, configs.wrap, state, streams["tqrot"][0],
            streams["u_sel"][0], streams["u_acc"][0])
    n0 = tmove_sweep.LAUNCHES.n
    pk, _, sk = tmove(*args)
    pp, _, sp = tmove.plain(*args)
    assert tmove_sweep.LAUNCHES.n == n0 + 1
    assert int(torch.sum(torch.any(pp != configs.positions, dim=-1))) > 0  # T-moves happened
    assert torch.equal(torch.any(pk != configs.positions, dim=-1),
                       torch.any(pp != configs.positions, dim=-1))
    assert _close(pk, pp, 1e-9)
    for a, b in zip(sk[0] + sk[1], sp[0] + sp[1]):
        assert _close(a, b, 1e-9)


def _nmax16_system(nconf):
    """H2O with two more electrons (6 up, 4 down), a Slater of 6 + 4
    orbitals of the SCF (as tests/test_torch_move_sweep.py's gate test
    builds one) times the Jastrow, float64 on the card: (mol, wf, params,
    configs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pyqmc_tpu_torch.configs import initial_guess
    from pyqmc_tpu_torch.models.jastrow import JastrowSpin
    from pyqmc_tpu_torch.models.multiply import MultiplyWF
    from pyqmc_tpu_torch.models.slater import DeterminantExpansion, Slater
    from pyqmc_tpu_torch.system.io import load_npz
    from pyqmc_tpu_torch.system.mole import Molecule

    mol, mf = load_npz()
    mol = Molecule(mol.atom_symbols, mol.atom_coords, mol.basis, ecp=mol.ecp, charge=-2, spin=2)
    assert mol.nelec == (6, 4)
    wf = MultiplyWF(Slater(mol, None, DeterminantExpansion.single(6, 4),
                           (mf.mo_coeff[0][:, :6], mf.mo_coeff[1][:, :4])), JastrowSpin(mol))
    params = wf.make_params("cuda", torch.float64)
    rng = np.random.default_rng(4)
    params["wf1"]["acoeff"] = torch.as_tensor(rng.normal(scale=0.1, size=(3, 4, 2)),
                                              dtype=torch.float64, device="cuda")
    configs = initial_guess(mol, nconf, generator=torch.Generator().manual_seed(3),
                            device="cuda", dtype=torch.float64)
    return mol, wf, params, configs


@pytest.mark.cuda
def test_sweep_kernels_nmax16_match_plain():
    """The NMAX = 16 instances of K1, K4 and K5 on `_nmax16_system`, 37
    walkers, float64, at tstep (tau) 0.5."""
    from pyqmc_tpu_torch.method.dmc import draw_dmc_streams
    from pyqmc_tpu_torch.observables.ecp import ECPAccumulator
    from pyqmc_tpu_torch.ops import tmove_sweep

    nconf = 37
    mol, wf, params, configs = _nmax16_system(nconf)
    pos, wrap = configs.positions, configs.wrap
    state = wf.recompute(params, pos)
    gen = torch.Generator(device="cuda").manual_seed(5)
    streams = draw_dmc_streams(gen, 1, 10, nconf, 0.5, "cuda", torch.float64)
    counts = (move_sweep.LAUNCHES.n, move_sweep.DMC_LAUNCHES.n, tmove_sweep.LAUNCHES.n)
    for mode in move_sweep.MODES:
        sweep = move_sweep.build_fused_sweep(wf, Geometry(), 0.5, mode=mode)
        assert sweep.walkers.nmax() == 16
        args = (params, pos, wrap, state, streams["gauss"][0], streams["unif"][0])
        pk, _, sk, ak = sweep(*args)
        pp, _, sp, ap = sweep.plain(*args)
        if mode == "dmc":
            (ak, r2pk, r2ak), (ap, r2pp, r2ap) = ak, ap
            assert _close(r2pk, r2pp, 1e-9) and _close(r2ak, r2ap, 1e-9)
        assert abs(float(ak) - float(ap)) * nconf < 0.5 and 0 < float(ak) < 10
        assert _close(pk, pp, 1e-9)
        for a, b in zip(sk[0] + sk[1], sp[0] + sp[1]):
            assert _close(a, b, 1e-9)
    tmove = tmove_sweep.build_fused_tmove_sweep(wf, Geometry(), ECPAccumulator(mol), 0.5)
    args = (params, pos, wrap, state, streams["tqrot"][0], streams["u_sel"][0],
            streams["u_acc"][0])
    pk, _, sk = tmove(*args)
    pp, _, sp = tmove.plain(*args)
    assert torch.equal(torch.any(pk != pos, dim=-1), torch.any(pp != pos, dim=-1))
    assert _close(pk, pp, 1e-9)
    for a, b in zip(sk[0] + sk[1], sp[0] + sp[1]):
        assert _close(a, b, 1e-9)
    assert (move_sweep.LAUNCHES.n, move_sweep.DMC_LAUNCHES.n, tmove_sweep.LAUNCHES.n) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1)


@pytest.fixture(params=[37, 6])
def cuda_diamond(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pyqmc_tpu_torch.entry import diamond_setup

    sup, wf, params, configs, acc = diamond_setup(request.param, device="cuda",
                                                  dtype=torch.float64, seed=3)
    rng = np.random.default_rng(4)
    params["wf1"]["acoeff"] = torch.as_tensor(rng.normal(scale=0.1, size=(16, 4, 2)),
                                              dtype=torch.float64, device="cuda")
    return wf, params, configs


def _close_scaled(a, b, tol):
    return bool(torch.all(torch.abs(a - b) <= tol * (torch.abs(b) + torch.max(torch.abs(b)))))


@pytest.mark.cuda
def test_pbc_sweep_kernel_matches_plain(cuda_diamond):
    from pyqmc_tpu_torch.ops import move_sweep_pbc

    wf, params, configs = cuda_diamond
    sweep = move_sweep.build_fused_sweep(wf, configs.geometry, 0.5)
    assert isinstance(sweep, move_sweep_pbc.FusedSweepPBC)
    nconf = configs.positions.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    streams = draw_streams(gen, 1, 64, nconf, 0.5, "cuda", torch.float64)
    state = wf.recompute(params, configs.positions)
    args = (params, configs.positions, configs.wrap, state, streams["gauss"][0],
            streams["unif"][0])
    n0 = move_sweep_pbc.LAUNCHES.n
    pk, wk, sk, ak = sweep(*args)
    pp, wp, sp, ap = sweep.plain(*args)
    assert move_sweep_pbc.LAUNCHES.n == n0 + 1
    # the same count of accepted moves (per-walker counts and per-electron
    # means are summed in two orders)
    assert abs(float(ak) - float(ap)) * nconf < 0.5 and torch.equal(wk, wp)
    assert _close(pk, pp, 1e-9)
    for a, b in zip(sk[0] + sk[1], sp[0] + sp[1]):
        assert _close(a, b, 1e-9)


@pytest.mark.cuda
def test_pbc_dmc_sweep_kernel_matches_plain(cuda_diamond):
    """K7's dmc mode against the plain dmc sweep: the vmc checks plus r2p
    and r2a per walker, at tstep 0.5 so that wraps and node rejections
    both happen."""
    from pyqmc_tpu_torch.ops import move_sweep_pbc

    wf, params, configs = cuda_diamond
    sweep = move_sweep.build_fused_sweep(wf, configs.geometry, 0.5, mode="dmc")
    assert isinstance(sweep, move_sweep_pbc.FusedSweepPBC) and sweep.mode == "dmc"
    nconf = configs.positions.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(6)
    streams = draw_streams(gen, 1, 64, nconf, 0.5, "cuda", torch.float64)
    state = wf.recompute(params, configs.positions)
    args = (params, configs.positions, configs.wrap, state, streams["gauss"][0],
            streams["unif"][0])
    n0, v0 = move_sweep_pbc.DMC_LAUNCHES.n, move_sweep_pbc.LAUNCHES.n
    pk, wk, sk, (ak, r2pk, r2ak) = sweep(*args)
    pp, wp, sp, (ap, r2pp, r2ap) = sweep.plain(*args)
    assert (move_sweep_pbc.DMC_LAUNCHES.n, move_sweep_pbc.LAUNCHES.n) == (n0 + 1, v0)
    assert abs(float(ak) - float(ap)) * nconf < 0.5 and torch.equal(wk, wp)
    assert not torch.equal(wk, configs.wrap)  # some accepted moves crossed the cell
    assert bool(torch.any(r2ak < r2pk))  # some moves were rejected
    assert _close(pk, pp, 1e-9) and _close(r2pk, r2pp, 1e-9) and _close(r2ak, r2ap, 1e-9)
    for a, b in zip(sk[0] + sk[1], sp[0] + sp[1]):
        assert _close(a, b, 1e-9)


@pytest.mark.cuda
def test_gto_kernels_match_plain(cuda_diamond):
    """K6 and K3 at the diamond's replicated-shell basis, K3 at H2O's."""
    from pyqmc_tpu_torch.ops import gto_kernels

    wf, params, configs = cuda_diamond
    orb = wf.wfs[0].orbitals
    X, _ = orb._fold(configs.positions.reshape(-1, 3))
    n6, n3 = gto_kernels.EVAL_GTO2_LAUNCHES.n, gto_kernels.VALUE_MO_LAUNCHES.n
    for a, b in zip(orb._eval2(X), orb._eval2.plain(X)):
        assert _close_scaled(a, b, 1e-9)
    R = orb._folded_coeff(params["wf0"], torch.float64)
    assert _close_scaled(orb._value_mo.transposed(X, R), orb._value_mo.plain_t(X, R), 1e-9)
    mol, hwf, hparams, hconf, _ = h2o_setup(64, device="cuda", dtype=torch.float64, seed=3)
    hp = hparams["wf0"]
    C = torch.cat([hp["mo_coeff_alpha"], hp["mo_coeff_beta"]], dim=1)
    hx = hconf.positions.reshape(-1, 3)
    hvm = hwf.wfs[0].orbitals._value_mo
    assert _close_scaled(hvm(hx, C), hvm.plain_t(hx, C).T, 1e-9)
    assert (gto_kernels.EVAL_GTO2_LAUNCHES.n, gto_kernels.VALUE_MO_LAUNCHES.n) == (n6 + 1, n3 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("basis", ["diamond", "h2o"])
@pytest.mark.parametrize("norb", [8, 32, 64])
def test_value_mo_kernel_tiles(basis, norb):
    """K3 against its plain version at 1037 points (the last 128-point tile
    ragged) and random coefficients of norb columns (one tile of 8, 32 or
    64 orbital columns), on the diamond's 489 replicated-shell AOs and on
    H2O's 23."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pyqmc_tpu_torch.entry import diamond_setup
    from pyqmc_tpu_torch.ops import gto_kernels

    rng = np.random.default_rng(7)
    if basis == "diamond":
        _, wf, _, _, _ = diamond_setup(2, device="cuda", dtype=torch.float64, seed=3)
        orb = wf.wfs[0].orbitals
        X, _ = orb._fold(torch.as_tensor(rng.uniform(-3.0, 6.0, size=(1037, 3)),
                                         dtype=torch.float64, device="cuda"))
    else:
        _, wf, _, _, _ = h2o_setup(2, device="cuda", dtype=torch.float64, seed=3)
        orb = wf.wfs[0].orbitals
        X = torch.as_tensor(rng.normal(scale=1.5, size=(1037, 3)), dtype=torch.float64,
                            device="cuda")
    vm = orb._value_mo
    C = torch.as_tensor(rng.normal(size=(vm.tables.nao, norb)), dtype=torch.float64,
                        device="cuda")
    n3 = gto_kernels.VALUE_MO_LAUNCHES.n
    out = vm.transposed(X, C)
    assert gto_kernels.VALUE_MO_LAUNCHES.n == n3 + 1 and out.shape == (norb, 1037)
    assert _close_scaled(out, vm.plain_t(X, C), 1e-9)

"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip (decided in
the fixture, never at import). On the GPU machine, which has no jax (that
tests/conftest.py imports):

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

float64 at a small size, so every accept decision is the same on both
sides: positions and state to 1e-9 (absolute, and relative for inverse
entries near a node), acceptance exactly, ECP energy to rtol 1e-9; the
periodic kernels K3, K6 (to 1e-9 of each entry plus the largest entry) and
K7 (state, wrap counts) on the diamond supercell at 37 walkers, a count
that fills no block of the sweep's 4 walkers exactly. The full
production-size checks, float32 included, are in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from pyqmc_tpu_torch.configs import Geometry
from pyqmc_tpu_torch.entry import h2o_setup
from pyqmc_tpu_torch.method.vmc import draw_streams
from pyqmc_tpu_torch.ops import ecp_energy, move_sweep


@pytest.fixture
def cuda_h2o():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    mol, wf, params, configs, acc = h2o_setup(64, device="cuda", dtype=torch.float64, seed=3)
    rng = np.random.default_rng(4)
    params["wf1"]["acoeff"] = torch.as_tensor(rng.normal(scale=0.1, size=(3, 4, 2)),
                                              dtype=torch.float64, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    streams = draw_streams(gen, 1, 8, 64, 0.5, "cuda", torch.float64)
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
    assert float(ak) == float(ap)
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
    assert float(ak) == float(ap) and 0 < float(ak) < 8
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
    streams = draw_dmc_streams(gen, 1, 8, 64, 0.5, "cuda", torch.float64)
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


@pytest.fixture
def cuda_diamond():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from pyqmc_tpu_torch.entry import diamond_setup

    sup, wf, params, configs, acc = diamond_setup(37, device="cuda", dtype=torch.float64, seed=3)
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
    gen = torch.Generator(device="cuda").manual_seed(5)
    streams = draw_streams(gen, 1, 64, 37, 0.5, "cuda", torch.float64)
    state = wf.recompute(params, configs.positions)
    args = (params, configs.positions, configs.wrap, state, streams["gauss"][0],
            streams["unif"][0])
    n0 = move_sweep_pbc.LAUNCHES.n
    pk, wk, sk, ak = sweep(*args)
    pp, wp, sp, ap = sweep.plain(*args)
    assert move_sweep_pbc.LAUNCHES.n == n0 + 1
    # the same count of accepted moves (per-walker counts and per-electron
    # means are summed in two orders)
    assert abs(float(ak) - float(ap)) * 37 < 0.5 and torch.equal(wk, wp)
    assert _close(pk, pp, 1e-9)
    for a, b in zip(sk[0] + sk[1], sp[0] + sp[1]):
        assert _close(a, b, 1e-9)


@pytest.mark.cuda
def test_pbc_dmc_sweep_raises_on_cuda(cuda_diamond):
    """K7's dmc mode is not ported: inside the gate, a dmc-mode sweep of
    CUDA tensors raises rather than running the plain sweep."""
    wf, params, configs = cuda_diamond
    sweep = move_sweep.build_fused_sweep(wf, configs.geometry, 0.02, mode="dmc")
    gen = torch.Generator(device="cuda").manual_seed(6)
    streams = draw_streams(gen, 1, 64, 37, 0.02, "cuda", torch.float64)
    state = wf.recompute(params, configs.positions)
    with pytest.raises(move_sweep.KernelUnsupported):
        sweep(params, configs.positions, configs.wrap, state, streams["gauss"][0],
              streams["unif"][0])


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

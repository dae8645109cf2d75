"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip (decided in
the fixture, never at import). On the GPU machine, which has no jax (that
tests/conftest.py imports):

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

float64 at a small size, so every accept decision is the same on both
sides: positions and state to 1e-9 (absolute, and relative for inverse
entries near a node), acceptance exactly, ECP energy to rtol 1e-9. The full
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

"""The port's numpy-only copies of the block-data tools (reblock.py,
method/extrapolate.py) against the JAX package's: the same arrays in, the
same numbers out (1e-14: both are numpy, in the same order of operations).
"""

import numpy as np
import pytest

from pyqmc_tpu import reblock as jreblock
from pyqmc_tpu.method.extrapolate import tstep_extrapolate as j_extrapolate

from pyqmc_tpu_torch import reblock as treblock
from pyqmc_tpu_torch.method.extrapolate import tstep_extrapolate


def _series(n=203, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros(n)
    for i in range(1, n):  # correlated, like block energies
        x[i] = 0.7 * x[i - 1] + rng.normal()
    return x - 17.2, rng.uniform(0.8, 1.2, size=n)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nblocks", [4, 16])
def test_reblock_matches(nblocks, weighted):
    x, w = _series()
    w = w if weighted else None
    np.testing.assert_allclose(treblock.reblock(x, nblocks, weights=w),
                               jreblock.reblock(x, nblocks, weights=w), rtol=1e-14)
    a = treblock.reblock_summary(x, nblocks, weights=w)
    b = jreblock.reblock_summary(x, nblocks, weights=w)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-14)
    # columns of block data (n, k) reblock column by column
    xx = np.stack([x, 2 * x + 1], axis=1)
    np.testing.assert_allclose(treblock.reblock(xx, nblocks, weights=w),
                               jreblock.reblock(xx, nblocks, weights=w), rtol=1e-14)


@pytest.mark.parametrize("n", [1, 3, 203])
def test_opt_block_matches(n):
    x, _ = _series(n + 1)
    assert treblock.reblock_by2(x) == jreblock.reblock_by2(x)
    assert treblock.reblock_by2(x, maxlevels=2) == jreblock.reblock_by2(x, maxlevels=2)
    assert treblock.opt_block(x) == jreblock.opt_block(x)


@pytest.mark.parametrize("order,errors", [(1, False), (1, True), (2, True)])
def test_tstep_extrapolate_matches(order, errors):
    rng = np.random.default_rng(1)
    tau = np.array([0.005, 0.01, 0.02, 0.04])
    e = -17.23 + 0.8 * tau + 3.0 * tau**2 + rng.normal(scale=1e-4, size=4)
    err = rng.uniform(1e-4, 3e-4, size=4) if errors else None
    e0, e0_err, coeffs = tstep_extrapolate(tau, e, errors=err, order=order)
    j0, j0_err, jcoeffs = j_extrapolate(tau, e, errors=err, order=order)
    assert e0 == pytest.approx(j0, abs=1e-14)
    np.testing.assert_allclose(coeffs, jcoeffs, rtol=1e-14)
    if errors:
        assert e0_err == pytest.approx(j0_err, rel=1e-14)
        assert abs(e0 + 17.23) < 5 * e0_err + 1e-3
    else:
        assert np.isnan(e0_err) and np.isnan(j0_err)

"""Correlated-error analysis of block data, numpy only (the port's own copy of
pyqmc_tpu/reblock.py, so that a DMC or VMC run can be summarised without jax).

reblock: average consecutive chunks; reblock_by2: Flyvbjerg-Petersen halving
with error estimates per level; opt_block: pick the optimal block size.
"""

import numpy as np


def reblock(data, nblocks, weights=None):
    """Average `data` (n, ...) into nblocks consecutive chunks.

    With `weights` (n,), each chunk is the weighted mean
    sum(w_i x_i)/sum(w_i): DMC block data carry population weights, and
    equal-weight averaging biases both mean and error bar (reference
    reblock(df, nblocks, weights), pyqmc/reblock.py:19-105)."""
    data = np.asarray(data)
    n = (data.shape[0] // nblocks) * nblocks
    chunks = data[:n].reshape(nblocks, -1, *data.shape[1:])
    if weights is None:
        return chunks.mean(axis=1)
    w = np.asarray(weights, dtype=float)[:n].reshape(nblocks, -1)
    wex = w.reshape(w.shape + (1,) * (data.ndim - 1))
    return (chunks * wex).sum(axis=1) / wex.sum(axis=1)


def reblock_by2(data, maxlevels=None):
    """Flyvbjerg-Petersen: successively pair-average; returns per-level
    (nblocks, mean, stderr, stderr_of_stderr)."""
    data = np.asarray(data, dtype=float)
    out = []
    level = 0
    while len(data) >= 2:
        n = len(data)
        se = data.std(ddof=1) / np.sqrt(n)
        se_err = se / np.sqrt(2 * (n - 1))
        out.append((level, n, data.mean(), se, se_err))
        if maxlevels is not None and level >= maxlevels:
            break
        m = (n // 2) * 2
        data = 0.5 * (data[:m:2] + data[1:m:2])
        level += 1
    return out


def opt_block(data):
    """Optimal blocking (Wolff/Lee criterion): smallest level whose error
    estimate has plateaued. Returns (mean, stderr, level)."""
    levels = reblock_by2(data)
    if len(levels) < 2:
        lvl, n, mean, se, _ = levels[0]
        return mean, se, 0
    best = levels[0]
    for i, (lvl, n, mean, se, se_err) in enumerate(levels[:-1]):
        nxt = levels[i + 1]
        if nxt[3] <= se + se_err or n < 16:
            best = (lvl, n, mean, se, se_err)
            break
        best = nxt
    return best[2], best[3], best[0]


def reblock_summary(data, nblocks=16, weights=None):
    """Mean + correlated standard error at a fixed reblocking.

    `weights` propagates to the chunk averages (weighted chunks, see
    reblock); the scatter of the weighted chunk means then estimates the
    error of the weighted grand mean. The grand mean reported is the
    weight-recombined one (sum over chunks of W_c m_c / sum W_c), not the
    plain mean of chunk means, so heavily-weighted stretches count more
    (reference reblock_summary(weights=...), pyqmc/reblock.py:108-129)."""
    b = reblock(data, nblocks, weights=weights)
    if weights is None:
        mean = b.mean(axis=0)
    else:
        n = (np.asarray(data).shape[0] // nblocks) * nblocks
        Wc = np.asarray(weights, dtype=float)[:n].reshape(nblocks, -1).sum(axis=1)
        Wc = Wc.reshape(Wc.shape + (1,) * (b.ndim - 1))
        mean = (b * Wc).sum(axis=0) / Wc.sum(axis=0)
    return {
        "mean": mean,
        "standard error": b.std(axis=0, ddof=1) / np.sqrt(nblocks),
        "nblocks": nblocks,
    }

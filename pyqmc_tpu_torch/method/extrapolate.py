"""DMC time-step extrapolation (tau -> 0), numpy only (the port's own copy of
pyqmc_tpu/method/extrapolate.py).

The reference workflow runs DMC at several time steps and extrapolates
(BASELINE config: 'tstep=0.02 w/ extrapolation'). Linear (or quadratic) fit
of E(tau) with proper error propagation.
"""

import numpy as np


def tstep_extrapolate(tsteps, energies, errors=None, order=1):
    """Fit E(tau) = E0 + c1 tau (+ c2 tau^2); returns (E0, E0_err, coeffs).

    errors: per-point standard errors (used as weights and propagated to
    E0_err via the covariance of the weighted least squares fit).
    """
    t = np.asarray(tsteps, dtype=float)
    e = np.asarray(energies, dtype=float)
    w = None if errors is None else 1.0 / np.asarray(errors, dtype=float)
    V = np.vander(t, order + 1, increasing=True)  # [1, tau, tau^2...]
    if w is not None:
        Vw = V * w[:, None]
        ew = e * w
    else:
        Vw, ew = V, e
    coeffs, *_ = np.linalg.lstsq(Vw, ew, rcond=None)
    cov = np.linalg.inv(Vw.T @ Vw)
    e0_err = float(np.sqrt(cov[0, 0])) if errors is not None else float("nan")
    return float(coeffs[0]), e0_err, coeffs

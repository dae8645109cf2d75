"""orbital_roofline (%): the orbital values at the ECP's quadrature points
(K3: models/orbitals.py, ops/gto_kernels.py) against their bound, over
every launch of the traced window: nsteps x nelec x the points evaluated
per electron x nconf points, every orbital column of both spins."""

from qmcbench import bounds

KERNELS = ("pq::value_mo_kernel",)


def read(ctx):
    launches, seconds = ctx["summary"].kernel(KERNELS)
    if launches == 0 or seconds <= 0:
        return None
    s, nconf = ctx["shapes"], ctx["cell"].traffic["nconf"]
    points = ctx["steps"] * s.nelec * min(s.nselect or s.nq, s.nq) * nconf
    nbytes, ops = bounds.value_mo_bound(s, points, s.nelec)
    nbytes += (launches - 1) * (s.nao * s.nelec * 4 + s.table_bytes(4))
    return 100.0 * bounds.bound_seconds(nbytes, ops) / seconds

"""ecp_roofline (%): the nonlocal ECP energy's kernel (K2:
ops/ecp_energy.py) against its bound."""

from qmcbench import bounds

KERNELS = ("pq::ecp_energy_kernel",)


def read(ctx):
    return bounds.kernel_roofline(ctx, KERNELS, "ecp_energy")

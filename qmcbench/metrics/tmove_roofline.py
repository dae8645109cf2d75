"""tmove_roofline (%): the T-move sweep's kernel (K5: ops/tmove_sweep.py)
against its bound (accepted T-moves not counted, so it errs low)."""

from qmcbench import bounds

KERNELS = ("pq::tmove_sweep_kernel",)


def read(ctx):
    return bounds.kernel_roofline(ctx, KERNELS, "tmove_sweep")

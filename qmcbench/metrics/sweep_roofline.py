"""sweep_roofline (%): the move sweep's kernel against its bound: K1 in VMC
and K4 in DMC (ops/move_sweep.py) on a molecule, K7 (ops/move_sweep_pbc.py)
in a cell."""

from qmcbench import bounds

KERNELS = ("pq::sweep_kernel", "pq::pbc_sweep_kernel")


def read(ctx):
    return bounds.kernel_roofline(ctx, KERNELS, ctx["cell"].traffic["method"] + "_sweep")

"""step_mfu (%): the operations of the traced window's walker-steps,
counted from the configuration's shapes (qmcbench/bounds.py:
walker_step_flops), per second of the window, against the card's float32
peak."""

from qmcbench import bounds


def read(ctx):
    acceptance = sum(b["acceptance"] for b in ctx["blocks"]) / len(ctx["blocks"])
    dmc = ctx["cell"].traffic["method"] == "dmc"
    flops = bounds.walker_step_flops(ctx["shapes"], dmc, acceptance) * ctx["walker_steps"]
    return 100.0 * flops / ctx["window_s"] / bounds.FP32_FLOPS

"""Model FLOPs of the traced steps over the wall seconds the same steps
take untraced, times the chip's dense bf16 peak, in %."""
from lsgd_bench import peaks


def read(win):
    return 100.0 * win.step_flops * win.steps / (win.wall_s * peaks.FLOPS_BF16)

"""The bucket SGD update's share of its byte bound, in %.

Bound: the bytes the update needs, each once: parameters, gradients and
momentum read, parameters and momentum written, 20 B a bucket element a
worker a step, at the chip's HBM rate.  Time: the device time of the
kernels named below (the fused update and the clip's sum of squares),
read by name until the program has an optimizer range of its own."""
import re

from lsgd_bench import peaks

KERNELS = re.compile(r"\b(update_kernel|sq_sum_kernel)\b")
BYTES_PER_ELEMENT = 20


def read(win):
    t = win.busy_s(lambda a: KERNELS.search(a.name) is not None)
    if not t:
        return None
    need = BYTES_PER_ELEMENT * win.workers * win.bucket_elements * win.steps
    return 100.0 * need / peaks.HBM_BYTES_PER_S / t

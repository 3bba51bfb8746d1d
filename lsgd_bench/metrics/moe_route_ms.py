"""Device ms a step in the program's MoE routing ranges
(``moe.dispatch``: routing and dispatch; ``moe.combine``), forward and,
by autograd sequence number, backward."""

RANGES = ("moe.dispatch", "moe.combine")


def read(win):
    t = win.in_range(*RANGES)
    return 1e3 * t / win.steps if t else None

"""Device ms a step in the program's ``attention`` range, forward and,
by autograd sequence number, backward."""

RANGES = ("attention",)


def read(win):
    t = win.in_range(*RANGES)
    return 1e3 * t / win.steps if t else None

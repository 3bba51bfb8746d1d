"""Share of the steps' untraced wall time in which no device activity
ran, in %: the traced steps' device busy time against the wall seconds
the same number of steps take untraced (the profiler slows the host,
so the traced window's own length would count its overhead as idle)."""


def read(win):
    return 100.0 * (1.0 - win.busy_s() / win.wall_s)

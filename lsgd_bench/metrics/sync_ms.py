"""Device ms a global sync: every activity launched inside
``bench.sync``, per sync."""


def read(win):
    if not win.syncs:
        return None
    return 1e3 * win.in_range("bench.sync") / win.syncs

"""Device ms a local step: every activity launched inside
``bench.local_step`` (forward, backward, the gradient landing in the
bucket, the update), per step."""


def read(win):
    return 1e3 * win.in_range("bench.local_step") / win.steps

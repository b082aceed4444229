"""device_idle_share.view: the share of the traced viewer window in which
no operation ran on the device (100 - busy share), from the union of the
profiler's device events (`tracing.py`)."""

from metrics import work


def read(ctx):
    return work.idle_share(ctx)

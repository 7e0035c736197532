"""The share of the traced window in which no operation ran on the
card (%), from torch.profiler's device activity."""

from benchmark.lib import readers


def read(ctx):
    return readers.idle_share_pct(ctx)

"""The decode step's cached attention on the device's stream (ms): the
summed ``device_s`` of the ``model.attention`` spans (one a layer: the
paged write, the paged read and the grouped attention; launch gaps
inside them included) under each ``serving.engine_step`` of the
window, mean over the steps."""

from benchmark.lib import spans


def read(ctx):
    win = ctx.get("window") or {}
    return spans.device_ms_per_step(win.get("spans", ()),
                                    "serving.engine_step",
                                    "model.attention")

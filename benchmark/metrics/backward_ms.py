"""The training step's backward on the device's stream (ms): the summed
``device_s`` of the ``train.backward`` spans (autograd through the
flash and cross-entropy kernels) under each of the window's
``train.step_run`` spans, mean over the steps; launch gaps inside them
included (``lib/spans.py``)."""

from benchmark.lib import spans


def read(ctx):
    return spans.train_phase_ms(ctx, "train.backward")

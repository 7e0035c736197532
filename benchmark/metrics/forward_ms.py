"""The training step's forward and loss on the device's stream (ms):
the summed ``device_s`` of the ``train.forward`` spans (the model and
the fused cross-entropy) under each of the window's ``train.step_run``
spans, mean over the steps; launch gaps inside them included
(``lib/spans.py``)."""

from benchmark.lib import spans


def read(ctx):
    return spans.train_phase_ms(ctx, "train.forward")

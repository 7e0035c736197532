"""Mean duration of the slot engine's decode step: the program's
``serving.engine_step`` spans that started in the window (ms)."""

from benchmark.lib import readers


def read(ctx):
    return readers.mean_span_ms(ctx, "serving.engine_step")

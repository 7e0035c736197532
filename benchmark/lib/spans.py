"""What the readers of the program's nested spans share: the device
time of named spans under each enclosing step, from the serving
window's spans or, for training, from the process's tracer.

A span's ``device_s`` is the stream time between its enter and its
exit: the work it encloses and any gap in which the stream waited for
the host's next launch (the program's tracer resolves it from CUDA
events without a sync; on the CPU it is the span's own duration). A
program whose spans have no ``device_s``, or that records no such
span, gives nothing to read: each function then returns None.
"""


def device_ms_per_step(spans, step_name, name, depth=4):
    """The mean over ``step_name`` spans of the summed ``device_s`` of
    the ``name`` spans under each (their parents followed up to
    ``depth`` levels), in ms; None where no step holds a resolved one.
    ``spans``: records with ``span_id``, ``parent_id`` and ``name``."""
    by_id = {s["span_id"]: s for s in spans}
    totals = {}
    for s in spans:
        if s["name"] != name or s.get("device_s") is None:
            continue
        parent = by_id.get(s["parent_id"])
        for _ in range(depth):
            if parent is None or parent["name"] == step_name:
                break
            parent = by_id.get(parent["parent_id"])
        if parent is not None and parent["name"] == step_name:
            key = parent["span_id"]
            totals[key] = totals.get(key, 0.0) + s["device_s"]
    if not totals:
        return None
    return 1e3 * sum(totals.values()) / len(totals)


def training_spans(ctx):
    """The last ``ctx["steps"]`` ``train.step_run`` spans of the
    process's tracer (the window's steps after any capture, in order)
    and the spans whose parent is one of them; None where the tracer
    holds fewer such steps (tracing off, or the ring overran)."""
    from container_engine_accelerators_tpu_torch import obs
    n = int(ctx.get("steps") or 0)
    if n <= 0:
        return None
    spans = obs.TRACER.snapshot()["spans"]
    steps = [s for s in spans if s["name"] == "train.step_run"][-n:]
    if len(steps) < n:
        return None
    ids = {s["span_id"] for s in steps}
    return steps + [s for s in spans if s["parent_id"] in ids]


def train_phase_ms(ctx, name):
    """The device time of the ``name`` spans in each of the training
    window's steps (a pair per micro-batch is summed), mean over the
    steps, in ms."""
    spans = training_spans(ctx)
    if spans is None:
        return None
    return device_ms_per_step(spans, "train.step_run", name, depth=1)

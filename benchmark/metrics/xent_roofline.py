"""The fused cross-entropy's share of its roofline (%): the bounds of
the traced forward and backward launches on the step's f32 logits
[B·(S-1), V] over their device time (lib/flops.py; both are bound by
bytes).

Nothing when the trace holds no such launch: the program has taken the
kernel off the path (a capture that lost its kernels fails the run in
``lib/devtrace.py``), and ``run.py`` names the metric left out."""

from benchmark.lib import flops, readers


def read(ctx):
    cfg, mix = ctx["cfg"], ctx["traffic"]
    rows = int(mix["batch"]) * (int(mix["seq_len"]) - 1)
    vocab = int(cfg["vocab_size"])
    bound = seconds = 0.0
    for role in ("fwd", "bwd"):
        n, s = readers.kernels(ctx, f"xent_{role}")
        bound += n * flops.xent_bound_s(role, rows, vocab)
        seconds += s
    if not seconds:
        return None
    return 100.0 * bound / seconds

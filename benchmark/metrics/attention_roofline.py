"""The flash kernels' share of their roofline (%): the sum of the
bounds of the traced forward, dQ and dK/dV launches over their device
time. Each launch is the step's [B, S, H, D] bf16 causal attention
(K and V expanded to the query heads) with the configuration's window;
a bound is the larger of its operations (4·D, 6·D, 8·D a kept pair)
over 989 TFLOP/s and its bytes over 3.35 TB/s (lib/flops.py).

Nothing when the trace holds no such launch: the program has taken the
kernel off the path (a capture that lost its kernels fails the run in
``lib/devtrace.py``), and ``run.py`` names the metric left out."""

from benchmark.lib import flops, readers

ROLES = (("fwd", "flash_fwd"), ("dq", "flash_bwd_dq"),
         ("dkv", "flash_bwd_dkv"))


def read(ctx):
    cfg, mix = ctx["cfg"], ctx["traffic"]
    _, _, h, _, d, _, _, w = flops.dims(cfg)
    bound = seconds = 0.0
    for role, needle in ROLES:
        n, s = readers.kernels(ctx, needle)
        bound += n * flops.attention_bound_s(
            role, int(mix["batch"]), int(mix["seq_len"]), h, d, w)
        seconds += s
    if not seconds:
        return None
    return 100.0 * bound / seconds

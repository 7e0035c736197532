"""The training step's share of the card's bf16 peak (%): the model
FLOPs of the window's steps (6 per non-embedding parameter, the lm_head
counted, a token, plus 12·D per kept causal pair per head per layer)
over the window's synced wall time and 989 TFLOP/s."""

from benchmark.lib import flops


def read(ctx):
    if not ctx.get("steps"):
        return None
    return (100.0 * ctx["steps"] * ctx["step_flops"]
            / (ctx["wall_s"] * flops.PEAK_BF16_FLOPS))

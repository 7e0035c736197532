"""Decode's share of the card's bf16 peak (%): the model FLOPs of the
tokens the decode steps generated in the window (2 per block and head
parameter, plus 4·D per attended key per query head per layer, at each
token's own context), over the window and 989 TFLOP/s. A request's
first token comes from its admission prefill and is not counted."""

from benchmark.lib import flops


def read(ctx):
    win = ctx["window"]
    cfg = ctx["cfg"]
    total = 0.0
    for rec, req in zip(win["records"], win["requests"]):
        plen = len(req["prompt"])
        for j, t in enumerate(rec["times"]):
            if j and win["open"] <= t < win["close"]:
                total += flops.decode_token_flops(cfg, plen + j)
    if not total:
        return None
    return 100.0 * total / (win["seconds"] * flops.PEAK_BF16_FLOPS)

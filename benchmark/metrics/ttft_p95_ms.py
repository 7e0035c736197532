"""Time to first token at the 95th percentile over every request sent
in the window (ms), on the client: the admission queue and the prefill
as a saturated closed loop sees them. Per-layer: where every slot is
full by construction the end-to-end metric is the tokens completed,
and this tail swings between runs (PERF.md §2)."""

from benchmark.lib import serve


def read(ctx):
    return serve.end_to_end(ctx["window"])[0].get("ttft_p95_ms")

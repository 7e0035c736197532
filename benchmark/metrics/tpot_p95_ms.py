"""A request's mean gap between its tokens after the first, inside the
window, at the 95th percentile over every request (ms), on the client:
the decode step and the admissions that stall it. Per-layer, as
``ttft_p95_ms`` is."""

from benchmark.lib import serve


def read(ctx):
    return serve.end_to_end(ctx["window"])[0].get("tpot_p95_ms")

"""Mean wall time of an admission (ms): the window's
``serving.prefill`` spans of phase ``engine_admission`` (the prefix
gather, the chunk's forward, the first token and the KV insert, with
the host's share), replays left out."""

from benchmark.lib import readers


def read(ctx):
    found = [s for s in readers.spans(ctx, "serving.prefill")
             if (s.get("attrs") or {}).get("phase") == "engine_admission"]
    if not found:
        return None
    return 1e3 * sum(s["duration_s"] for s in found) / len(found)

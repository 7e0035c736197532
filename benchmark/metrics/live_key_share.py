"""The share of the key positions the decode step attends that hold
live tokens (%): 100 · Σ ``keys_live`` / Σ ``keys_attended`` over the
window's ``engine.forward`` spans (slots × the span each row attends,
against min(pos + 1, window) summed over the active rows)."""

from benchmark.lib import readers


def read(ctx):
    live = attended = 0
    for s in readers.spans(ctx, "engine.forward"):
        attrs = s.get("attrs") or {}
        if "keys_live" in attrs and "keys_attended" in attrs:
            live += attrs["keys_live"]
            attended += attrs["keys_attended"]
    if not attended:
        return None
    return 100.0 * live / attended

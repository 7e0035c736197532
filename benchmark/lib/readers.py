"""What the per-layer metrics' readers share: the program's spans and
the device capture of a traced window."""


def spans(ctx, name):
    """The program's spans called ``name`` that started in the part of
    the window the readers read."""
    win = ctx.get("window") or {}
    return [s for s in win.get("spans", ()) if s["name"] == name
            and s.get("duration_s") is not None]


def mean_span_ms(ctx, name):
    found = spans(ctx, name)
    if not found:
        return None
    return 1e3 * sum(s["duration_s"] for s in found) / len(found)


def idle_share_pct(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])


def kernels(ctx, needle):
    """(launches, device seconds) of the traced kernels whose names
    hold ``needle``."""
    trace = ctx.get("trace")
    if not trace:
        return 0, 0.0
    n, s = 0, 0.0
    for name, (sec, count) in trace["kernels"].items():
        if needle in name:
            n += count
            s += sec
    return n, s

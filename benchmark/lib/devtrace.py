"""The traced run's device trace: torch.profiler over a window, reduced
to busy time, kernel time by name and idle gaps by what the host was
doing. Only the reduction is kept; no trace file is written.

Only device activity is recorded: recording every host operation as
well slows the host so much that the window's idle share would be the
profiler's (a training window went from 0.32 to 0.8 s a step). A spin
kernel launched at a known host time marks the window's start on the
trace's clock, which places the program's spans on it: each idle gap
is named by the innermost span open then and, where the trace has
them, the last runtime call before it.

Started while another thread keeps the card busy (the serving loop),
a capture now and then records no kernel at all, its mark included
(on one H100: 6 of 9 two-second captures in one serving window, and
all 6 of another run's). Started on an idle card, it has kept them
every time, as in training. So the serving driver starts its one
capture before the load does and reduces the part of it that falls in
the traced window (``reduce(between=...)``).

The first capture of a process stalls it for seconds (CUPTI's start),
so ``warm`` runs a throwaway capture during set-up.
"""

import bisect
import time

import torch

CUDA = torch.autograd.DeviceType.CUDA
MARK = "spin_kernel"
COPIES = ("Memcpy", "Memset")


def _activities():
    return [torch.profiler.ProfilerActivity.CUDA]


def warm(device):
    """A throwaway capture: pays the profiler's start-up in set-up."""
    x = torch.ones(1024, device=device)
    with torch.profiler.profile(activities=_activities()):
        (x * 2).sum().item()
    torch.cuda.synchronize(device)


class Capture:
    """One profiled window: ``start`` and ``stop`` around it, then
    ``reduce``."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.window_s = None
        self.mark_unix = None

    def start(self):
        torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.__enter__()
        self.mark_unix = time.time()
        self._t0 = time.perf_counter()
        torch.cuda._sleep(100)

    def stop(self):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def reduce(self, spans=(), between=None):
        """{"busy_s", "window_s", "kernels": {name: [seconds, count]},
        "gaps": {what the host was doing: idle seconds}}, or None when
        the capture lost its device activity (no mark, or no kernel
        beside copies). ``spans``: the program's spans (start_unix,
        duration_s, name), which name what the host was in during each
        gap. ``between``: (start, end) unix seconds of the part reduced
        (default: all of the capture)."""
        events = list(self.prof.events())
        mark = min((e for e in events if e.device_type == CUDA
                    and MARK in e.name), key=lambda e: e.time_range.start,
                   default=None)
        if mark is None:
            return None
        offset = self.mark_unix * 1e6 - mark.time_range.start
        if between is None:
            t0 = mark.time_range.start              # µs, trace clock
            t1 = t0 + self.window_s * 1e6
        else:
            t0, t1 = (u * 1e6 - offset for u in between)
        dev, cpu = [], []
        kernels = {}
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e is mark:
                continue
            if e.device_type == CUDA:
                if end <= t0 or start >= t1:
                    continue
                dev.append((max(start, t0), min(end, t1)))
                s, n = kernels.get(e.name, (0.0, 0))
                kernels[e.name] = (s + (end - start) / 1e6, n + 1)
            elif end > t0 and start < t1:
                cpu.append((start, end, e.name))
        if not any(not k.startswith(COPIES) for k in kernels):
            return None
        dev.sort()
        merged = []
        for start, end in dev:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        gaps, prev = [], t0
        for start, end in merged:
            if start > prev:
                gaps.append((prev, start))
            prev = max(prev, end)
        if t1 > prev:
            gaps.append((prev, t1))
        cpu.sort()
        cpu_starts = [c[0] for c in cpu]
        sp = sorted((s["start_unix"] * 1e6 - offset,
                     s["start_unix"] * 1e6 - offset
                     + (s.get("duration_s") or 0.0) * 1e6, s["name"])
                    for s in spans)
        sp_starts = [s[0] for s in sp]
        labelled = {}
        for a, b in gaps:
            label = (_innermost(sp, sp_starts, (a + b) / 2, "no span")
                     + " / " + _last_started(cpu, cpu_starts, a))
            labelled[label] = labelled.get(label, 0.0) + (b - a) / 1e6
        return {
            "busy_s": sum(end - start for start, end in merged) / 1e6,
            "window_s": (t1 - t0) / 1e6,
            "kernels": {k: [s, n] for k, (s, n) in kernels.items()},
            "gaps": labelled,
        }


def summarize(reductions, top=10):
    """The captures that kept their device activity, summed: busy and
    window seconds, kernels by name, ``device_ops`` and ``idle_gaps``
    (the ``top`` by time), and how many captures were kept of how
    many. Raises when none was kept."""
    kept = [r for r in reductions if r is not None]
    if not kept:
        raise RuntimeError(f"all {len(reductions)} device captures lost "
                           f"their device activity")
    kernels, gaps = {}, {}
    for r in kept:
        for k, (s, n) in r["kernels"].items():
            s0, n0 = kernels.get(k, (0.0, 0))
            kernels[k] = (s0 + s, n0 + n)
        for k, s in r["gaps"].items():
            gaps[k] = gaps.get(k, 0.0) + s
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": sum(r["busy_s"] for r in kept),
        "window_s": sum(r["window_s"] for r in kept),
        "kernels": {k: [s, n] for k, (s, n) in kernels.items()},
        "device_ops": [[k[:160], s] for k, (s, _) in ops[:top]],
        "idle_gaps": sorted(([k, s] for k, s in gaps.items()),
                            key=lambda kv: -kv[1])[:top],
        "captures": [len(kept), len(reductions)],
    }


def _innermost(items, starts, t, default, scan=64):
    """The shortest of (start, end, name) ``items`` (sorted by start)
    that holds time ``t``, among the ``scan`` that started last."""
    best = None
    hi = bisect.bisect_right(starts, t)
    for start, end, name in reversed(items[max(0, hi - scan):hi]):
        if end >= t and (best is None or end - start < best[0]):
            best = (end - start, name)
    return best[1] if best else default


def _last_started(cpu, starts, t):
    """The host operation that started last before time ``t`` (what
    the host was doing as the device went idle)."""
    i = bisect.bisect_right(starts, t)
    return cpu[i - 1][2] if i else "python"

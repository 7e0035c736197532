# Copyright 2026 The container-engine-accelerators-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
"""Efficiency accounting: MFU and goodput ledgers (counterpart of the
JAX package's ``obs/efficiency.py``, under its names).

  - ``FlopsLedger``: model FLOPs per step divided by wall time and the
    per-chip peak (``peak_flops_per_chip``: the JAX package's TPU table
    plus NVIDIA entries, ``CEA_TPU_PEAK_FLOPS`` overriding both),
    published as the ``tpu_train_mfu`` / ``tpu_decode_mfu`` gauges.
  - ``GoodputLedger``: every wall-clock second of a run in exactly ONE
    bucket (productive step, compile, data wait, checkpoint, restart,
    straggler stall, or ``other``, the unattributed remainder, so the
    buckets always sum to wall time), published as
    ``tpu_train_goodput_ratio`` and ``tpu_train_badput_seconds{bucket}``.

``report_from_snapshots`` replays the same attribution offline over
journal snapshots (/debug/trace payloads or CEA_TPU_TRACE_FILE files),
the JAX package's or the port's alike: both write one journal shape.

The numerator of a training step, where the JAX package asks XLA's
cost analysis, is ``count_flops``: ``torch.utils.flop_counter``'s
FlopCounterMode over one call (matrix products and convolutions, as
aten executes them) plus, for each hand-written kernel the call
launches, the FLOPs its wrapper declares through ``kernel_flops``. The
counter cannot see a kernel launched through ctypes, and on the CPU it
would count the kernel's plain version instead: inside a
``kernel_flops`` region the counter's own count is dropped and the
declared count kept, so a call counts the same on the card and on the
CPU.

Imports neither torch nor numpy at module level (the fleet front door
imports obs in a process that never loads torch); ``count_flops``
imports torch when called.
"""

import threading
import time

from ..utils import env_number
from .metric_names import (
    DECODE_MFU as DECODE_MFU_GAUGE,
    TRAIN_BADPUT_SECONDS as BADPUT_GAUGE,
    TRAIN_GOODPUT_RATIO as GOODPUT_GAUGE,
    TRAIN_MFU as TRAIN_MFU_GAUGE,
)
from .trace import get_tracer

# Per-chip dense peak FLOP/s at the training precision (bf16), matched
# by SUBSTRING against the device's name, longest key first ("v5 lite"
# wins over "v5"). The TPU rows are the JAX package's table; the NVIDIA
# rows match ``torch.cuda.get_device_name()`` ("NVIDIA H100 80GB HBM3"):
# the H100 SXM data sheet's dense bf16 rate at its 700 W limit.
TPU_PEAK_FLOPS = {
    "v2": 45e12,
    "v3": 123e12,
    "v4": 275e12,
    "v5 lite": 197e12,
    "v5litepod": 197e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v5": 459e12,
    "v6 lite": 918e12,
    "v6e": 918e12,
}
GPU_PEAK_FLOPS = {
    "h100": 989e12,
}
PEAK_FLOPS = {**TPU_PEAK_FLOPS, **GPU_PEAK_FLOPS}

PEAK_FLOPS_ENV = "CEA_TPU_PEAK_FLOPS"

# Every second of a run lands in exactly one of these. "productive" is
# the only goodput bucket; "other" is the unattributed remainder.
GOODPUT_BUCKETS = ("productive", "compile", "data_wait", "checkpoint",
                   "restart", "straggler_stall", "other")

# Span name -> bucket for the offline replay: the spans the Trainer
# and the checkpoint manager emit.
SPAN_BUCKETS = {
    "train.step_run": "productive",
    "train.step_compile": "compile",
    "train.data_wait": "data_wait",
    "train.checkpoint": "checkpoint",
}


def peak_flops_per_chip(device_kind=None):
    """Peak FLOP/s of one chip named ``device_kind``, or None when the
    name is unknown. CEA_TPU_PEAK_FLOPS wins unconditionally (how an
    operator rates new hardware, or a card held below its limit)."""
    override = env_number(PEAK_FLOPS_ENV, None)
    if override is not None:
        return override
    if not device_kind:
        return None
    kind = str(device_kind).lower()
    for key in sorted(PEAK_FLOPS, key=len, reverse=True):
        if key in kind:
            return PEAK_FLOPS[key]
    return None


def device_kind(device):
    """The name ``peak_flops_per_chip`` matches for a torch device:
    the card's name on CUDA, else the device type ("cpu")."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def transformer_train_flops(param_count, tokens):
    """Analytic per-step training FLOPs: 6·N·(B·S), 2N forward + 4N
    backward per token (Kaplan et al.'s accounting)."""
    return 6.0 * float(param_count) * float(tokens)


def transformer_decode_flops(param_count, tokens, attended_keys=0,
                             key_flops=0.0):
    """Analytic decode FLOPs: forward only, 2·N per generated token,
    plus ``key_flops`` per attended key (4·D·H·L in a transformer: the
    scores and the weighted sum of each query head and layer), with
    ``attended_keys`` summed over the generated tokens' live contexts.
    The two-argument form is the JAX package's."""
    return (2.0 * float(param_count) * float(tokens)
            + float(key_flops) * float(attended_keys))


# -- counted FLOPs ------------------------------------------------------

class _FlopCount:
    """One ``count_flops`` call: the counter, what kernel regions hid
    from it, and what they declared."""

    def __init__(self, mode):
        self.mode = mode
        self.hidden = 0
        self.declared = 0.0

    def total(self):
        return float(self.mode.get_total_flops() - self.hidden
                     + self.declared)


_COUNTS = []
_counts_lock = threading.Lock()


class _Region:
    __slots__ = ("_count", "_flops", "_before")

    def __init__(self, count, flops):
        self._count = count
        self._flops = flops

    def __enter__(self):
        self._before = self._count.mode.get_total_flops()
        return self

    def __exit__(self, *exc):
        count = self._count
        count.hidden += count.mode.get_total_flops() - self._before
        count.declared += float(self._flops)
        return False


class _NullRegion:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_REGION = _NullRegion()


def kernel_flops(flops_fn, *args):
    """Context manager around one hand-written kernel's call: under
    ``count_flops`` the call counts ``flops_fn(*args)`` and nothing the
    counter saw inside it (on the CPU, the kernel's plain version).
    Outside a count it is a shared no-op and ``flops_fn`` is not
    called. Regions do not nest."""
    if not _COUNTS:
        return _NULL_REGION
    return _Region(_COUNTS[-1], flops_fn(*args))


def count_flops(fn, *args, **kwargs):
    """(fn(*args, **kwargs), FLOPs): FlopCounterMode's count over the
    call, the backward it runs included, with each kernel region's
    declared count in place of what the counter saw inside it."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = FlopCounterMode(display=False)
    count = _FlopCount(mode)
    with _counts_lock:
        _COUNTS.append(count)
    try:
        with mode:
            result = fn(*args, **kwargs)
    finally:
        with _counts_lock:
            _COUNTS.remove(count)
    return result, count.total()


class FlopsLedger:
    """Rolling MFU accounting behind one gauge.

    ``observe(flops, seconds)`` records one step; every
    ``publish_every`` observations (and on the first) the gauge updates
    to window-FLOPs / window-seconds / (peak · chips). Without a known
    peak the ledger still tracks achieved FLOP/s (``achieved_flops``)
    and publishes no gauge rather than a made-up one.
    """

    def __init__(self, gauge=TRAIN_MFU_GAUGE, peak_flops=None,
                 chips=1, publish_every=32, tracer=None):
        self._gauge = gauge
        self.peak_flops = peak_flops
        self.chips = max(1, int(chips))
        self._publish_every = max(1, int(publish_every))
        self._tracer = tracer or get_tracer()
        self._lock = threading.Lock()
        self._window_flops = 0.0
        self._window_seconds = 0.0
        self._observations = 0
        self._mfu = None
        self._achieved = None

    def observe(self, flops, seconds):
        if seconds <= 0 or flops is None:
            return
        with self._lock:
            self._window_flops += float(flops)
            self._window_seconds += float(seconds)
            self._observations += 1
            due = (self._observations == 1
                   or self._observations % self._publish_every == 0)
            if not due:
                return
            self._achieved = self._window_flops / self._window_seconds
            if self.peak_flops:
                self._mfu = (self._achieved
                             / (self.peak_flops * self.chips))
            self._window_flops = 0.0
            self._window_seconds = 0.0
            mfu = self._mfu
        if mfu is not None:
            # Unrounded: a CPU rig's 1e-8 "MFU" must not flatten to 0.
            self._tracer.gauge(self._gauge, mfu)

    def mfu(self):
        with self._lock:
            return self._mfu

    def achieved_flops(self):
        """Last window's achieved FLOP/s (peak-independent)."""
        with self._lock:
            return self._achieved

    def reset(self):
        """Drop the window AND the published value (serving's
        post-warm-up discipline: a warm-up observation must not stand
        as the MFU until real traffic rolls the window)."""
        with self._lock:
            self._window_flops = 0.0
            self._window_seconds = 0.0
            self._observations = 0
            self._mfu = None
            self._achieved = None


class GoodputLedger:
    """Wall-clock attribution: every second in exactly one bucket.

    The wall clock starts at construction, ``record(bucket, seconds)``
    attributes time, and ``summary()`` closes the books: the
    unattributed remainder lands in ``other``, so the buckets sum to
    wall time. Overlapping attributions (an async checkpoint under
    compute) that exceed wall are scaled down proportionally.
    """

    def __init__(self, tracer=None, clock=time.monotonic):
        self._tracer = tracer or get_tracer()
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets = {b: 0.0 for b in GOODPUT_BUCKETS}
        self._started = clock() if clock else None
        self._wall_override = None

    def record(self, bucket, seconds):
        if bucket not in self._buckets:
            raise ValueError(
                f"unknown goodput bucket {bucket!r}; "
                f"one of {sorted(self._buckets)}")
        if seconds <= 0:
            return
        with self._lock:
            self._buckets[bucket] += float(seconds)

    def set_wall(self, seconds):
        """Pin the wall-time denominator (the offline replay: wall is
        the journal's observed window)."""
        self._wall_override = max(0.0, float(seconds))

    def wall_seconds(self):
        if self._wall_override is not None:
            return self._wall_override
        if self._started is None:
            return 0.0
        return max(0.0, self._clock() - self._started)

    def summary(self):
        """{wall_s, goodput_ratio, buckets:{...}} with the buckets
        summing to wall_s."""
        wall = self.wall_seconds()
        with self._lock:
            buckets = dict(self._buckets)
        attributed = sum(buckets.values())
        if wall <= 0.0:
            wall = attributed
        if attributed > wall and attributed > 0.0:
            scale = wall / attributed
            buckets = {b: v * scale for b, v in buckets.items()}
            attributed = wall
        buckets["other"] += max(0.0, wall - attributed)
        ratio = buckets["productive"] / wall if wall > 0 else None
        return {
            "wall_s": round(wall, 6),
            "goodput_ratio": (round(ratio, 6)
                              if ratio is not None else None),
            "buckets": {b: round(buckets[b], 6)
                        for b in GOODPUT_BUCKETS},
        }

    def publish(self):
        """Export the books as gauges: the goodput ratio and a
        per-bucket badput breakdown (every bucket but productive)."""
        s = self.summary()
        if s["goodput_ratio"] is not None:
            self._tracer.gauge(GOODPUT_GAUGE, s["goodput_ratio"])
        for bucket, seconds in s["buckets"].items():
            if bucket == "productive":
                continue
            self._tracer.gauge(BADPUT_GAUGE, round(seconds, 3),
                               bucket=bucket)
        return s


# -- offline replay ---------------------------------------------------

def _span_window(snapshot):
    """(start, end) unix bounds of everything this journal observed."""
    lo = hi = None
    for span in (snapshot.get("spans") or []) + (
            snapshot.get("open_spans") or []):
        start = span.get("start_unix")
        if start is None:
            continue
        dur = span.get("duration_s") or 0.0
        lo = start if lo is None else min(lo, start)
        hi = (start + dur) if hi is None else max(hi, start + dur)
    for ev in snapshot.get("events") or []:
        t = ev.get("unix")
        if t is None:
            continue
        lo = t if lo is None else min(lo, t)
        hi = t if hi is None else max(hi, t)
    return lo, hi


def ledger_from_snapshot(snapshot):
    """Replay ONE journal snapshot into a GoodputLedger.

      - spans named in SPAN_BUCKETS add their duration to that bucket;
      - ``train.restart`` / ``train.recovered`` events add their
        ``recovery_s`` to the restart bucket;
      - a straggler episode (``straggler.detected`` until its
        ``straggler.recovered``, or the window's end) moves
        episode · (1 − 1/skew_ratio) from productive to
        straggler_stall, clamped to the productive time recorded.

    Wall time is the journal's observed window; ``other`` absorbs the
    remainder.
    """
    ledger = GoodputLedger(clock=None)
    lo, hi = _span_window(snapshot)
    ledger.set_wall((hi - lo) if lo is not None else 0.0)
    stall = 0.0
    for span in (snapshot.get("spans") or []) + (
            snapshot.get("open_spans") or []):
        bucket = SPAN_BUCKETS.get(span.get("name"))
        dur = span.get("duration_s")
        if bucket and dur:
            ledger.record(bucket, dur)
    episodes = {}  # host -> (detected unix, skew)
    for ev in sorted(snapshot.get("events") or [],
                     key=lambda e: e.get("unix", 0.0)):
        name, fields = ev.get("name"), ev.get("fields") or {}
        if name in ("train.restart", "train.recovered"):
            rec = fields.get("recovery_s")
            if rec:
                ledger.record("restart", float(rec))
        elif name == "straggler.detected":
            episodes[fields.get("host")] = (ev.get("unix"),
                                            fields.get("skew_ratio"))
        elif name == "straggler.recovered":
            start = episodes.pop(fields.get("host"), None)
            if start and start[0] is not None and start[1]:
                dur = max(0.0, ev.get("unix", start[0]) - start[0])
                stall += dur * (1.0 - 1.0 / float(start[1]))
    for started, skew in episodes.values():  # never recovered
        if started is not None and skew and hi is not None:
            dur = max(0.0, hi - started)
            stall += dur * (1.0 - 1.0 / float(skew))
    if stall > 0.0:
        # Stall is reclassified productive time, so it never exceeds
        # what was recorded as productive.
        with ledger._lock:
            moved = min(stall, ledger._buckets["productive"])
            ledger._buckets["productive"] -= moved
            ledger._buckets["straggler_stall"] += moved
    return ledger


def report_from_snapshots(snapshots):
    """Per-process ledgers and a combined view over several journal
    snapshots. The combined buckets are straight sums, so the combined
    books still balance."""
    processes = []
    combined = {b: 0.0 for b in GOODPUT_BUCKETS}
    combined_wall = 0.0
    for snap in snapshots:
        summary = ledger_from_snapshot(snap).summary()
        ident = snap.get("identity") or {}
        processes.append({
            "identity": {k: ident.get(k) for k in ("role", "host", "pid")},
            **summary,
        })
        combined_wall += summary["wall_s"]
        for b in GOODPUT_BUCKETS:
            combined[b] += summary["buckets"][b]
    ratio = (combined["productive"] / combined_wall
             if combined_wall > 0 else None)
    return {
        "metric": "goodput_report",
        "processes": processes,
        "combined": {
            "wall_s": round(combined_wall, 6),
            "goodput_ratio": (round(ratio, 6)
                              if ratio is not None else None),
            "buckets": {b: round(combined[b], 6)
                        for b in GOODPUT_BUCKETS},
        },
    }

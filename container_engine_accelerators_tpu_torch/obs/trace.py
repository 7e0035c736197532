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

"""In-process tracer: spans, latency histograms, event journal.

The port's own copy of the JAX package's ``obs/trace.py`` (the
journal file writer is not carried: nothing of the port writes one
yet). Bounded memory (completed spans and events live in fixed-
capacity rings), near-zero cost when disabled (``tracer.span(...)``
returns one module-level no-op span), stdlib only.

Environment:
  CEA_TPU_TRACE=0        disable span/event recording (histograms
                         stay live: they are the /metrics surface)
  CEA_TPU_TRACE_CAP=N    ring capacity for spans and events (4096)
"""

import random
import threading
import time

from ..utils import env_number, env_str
from .identity import identity

DEFAULT_CAP = 4096

# Latency buckets in seconds: 100us .. 60s, roughly x2.5 per step —
# wide enough for sub-ms requests and multi-second decodes in ONE
# fixed grid, so every histogram merges on a scrape (the JAX package's
# grid: a fleet merges the two engines' buckets exactly).
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   10.0, 30.0, 60.0)


class Histogram:
    """Fixed-bucket latency histogram (Prometheus semantics).

    Cumulative bucket counts are computed at export; observe() does
    one bisect + three adds under a lock — cheap enough for every
    request/RPC path. ``labels`` are static (fixed at creation), so
    label cardinality is bounded by call sites, not by traffic.
    """

    __slots__ = ("name", "help", "labels", "buckets", "counts",
                 "sum", "count", "_lock")

    def __init__(self, name, help_text="", labels=None, buckets=None):
        self.name = name
        self.help = help_text
        self.labels = dict(labels or {})
        self.buckets = tuple(buckets or DEFAULT_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def observe(self, seconds):
        seconds = float(seconds)
        lo, hi = 0, len(self.buckets)
        while lo < hi:  # first bucket with le >= seconds
            mid = (lo + hi) // 2
            if self.buckets[mid] < seconds:
                lo = mid + 1
            else:
                hi = mid
        with self._lock:
            self.counts[lo] += 1
            self.sum += seconds
            self.count += 1

    def snapshot(self):
        """(counts, sum, count) under the lock — the export seam."""
        with self._lock:
            return list(self.counts), self.sum, self.count

    def reset(self):
        """Zero IN PLACE: long-lived holders keep their reference
        and stay wired to the export surface (the Tracer.reset rule;
        serving's post-warm-up counter reset shares it)."""
        with self._lock:
            self.counts = [0] * (len(self.buckets) + 1)
            self.sum = 0.0
            self.count = 0

    def merge(self, other):
        """Fold ``other``'s observations into this histogram IN
        PLACE: exact bucket-wise addition of counts/sum/count, the
        fleet-aggregation primitive (obs/fleet.py). Because the grids
        are identical, quantiles of the merged histogram equal
        quantiles over the POOLED observations (bucket-resolution
        exact), which percentile-of-percentiles never is. Names and
        labels may differ (a fleet rollup collapses per-engine label
        sets on purpose); bucket BOUNDARIES may not: a silent
        re-bucketing would corrupt the distribution, so a mismatch
        raises with the offending boundary named."""
        if not isinstance(other, Histogram):
            raise TypeError(
                f"can only merge Histogram, not "
                f"{type(other).__name__}")
        if tuple(other.buckets) != self.buckets:
            ours, theirs = self.buckets, other.buckets
            for i in range(max(len(ours), len(theirs))):
                a = ours[i] if i < len(ours) else None
                b = theirs[i] if i < len(theirs) else None
                if a != b:
                    raise ValueError(
                        f"bucket boundary mismatch merging "
                        f"{other.name!r} into {self.name!r} at "
                        f"index {i}: {a} != {b}")
        counts, other_sum, other_count = other.snapshot()
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.sum += other_sum
            self.count += other_count
        return self

    def quantile(self, q):
        """Estimated quantile via linear interpolation inside the
        owning bucket (the Prometheus histogram_quantile method);
        None when empty. The +Inf bucket reports the largest finite
        bound — an upper-bound-less estimate would be a lie."""
        counts, _, total = self.snapshot()
        if not total:
            return None
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank and c:
                if i >= len(self.buckets):
                    return self.buckets[-1]
                lower = self.buckets[i - 1] if i else 0.0
                frac = 1.0 - (cum - rank) / c
                return lower + (self.buckets[i] - lower) * frac
        return self.buckets[-1]


class _NullSpan:
    """Returned when tracing is disabled: every operation is a no-op
    and ``with`` works. ONE module-level instance — the disabled hot
    path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self

    def __bool__(self):
        # Falsy so call sites can cheaply branch on "real span?".
        return False


NULL_SPAN = _NullSpan()


class Span:
    """One timed operation; a context manager.

    Nesting is implicit via a per-thread stack: a span opened while
    another is active on the same thread becomes its child and joins
    its trace. Cross-thread work (e.g. a micro-batcher serving
    requests admitted on handler threads) passes an explicit
    ``parent`` context instead — see Tracer.span(parent=...).
    """

    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "start_wall", "_t0", "duration", "status", "thread",
                 "_tracer")

    def __init__(self, tracer, name, attrs, trace_id, span_id,
                 parent_id):
        self.name = name
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_wall = time.time()
        self._t0 = time.perf_counter()
        self.duration = None
        self.status = "ok"
        self.thread = threading.current_thread().name
        self._tracer = tracer

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        self._tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.status = "error"
            self.attrs.setdefault("error", repr(exc))
        self._tracer._pop(self)
        return False

    def context(self):
        """(trace_id, span_id) — the hand-off token for explicit
        cross-thread parenting."""
        return (self.trace_id, self.span_id)

    def to_dict(self):
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start_unix": self.start_wall,
            "duration_s": self.duration,
            "status": self.status,
            "thread": self.thread,
            "attrs": self.attrs,
        }


class Tracer:
    """Spans + events + histograms behind one bounded journal."""

    def __init__(self, capacity=None, enabled=None):
        if capacity is None:
            capacity = env_number("CEA_TPU_TRACE_CAP", DEFAULT_CAP,
                                  parse=int)
        if enabled is None:
            enabled = env_str("CEA_TPU_TRACE", "1") != "0"
        self.enabled = bool(enabled)
        self.capacity = max(1, capacity)
        self._lock = threading.Lock()
        # Plain lists + head index: a deque would also work, but the
        # explicit ring makes the bound auditable (and sliceable for
        # export without a rotate).
        self._spans = []
        self._events = []
        self._dropped_spans = 0
        self._dropped_events = 0
        self._histograms = {}
        self._counters = {}
        self._gauges = {}
        # Ids are sequential above a per-tracer random base: sequential
        # keeps in-process ordering readable, the base makes ids from
        # different PROCESSES collision-free, so trace ids propagated
        # between processes (obs/propagate.py) never alias. Bit 51 is
        # forced on so every id stays nonzero (zero ids are invalid on
        # the wire); the base stays under 2^52 so ids survive JSON
        # round trips through JS consumers (Perfetto's UI parses args
        # with JSON.parse: anything past 2^53 silently loses low bits,
        # which would alias distinct spans).
        self._next_id = (random.getrandbits(52) | (1 << 51))
        self._open = {}          # span_id -> Span (leak guard surface)
        self._local = threading.local()
        self._started_unix = time.time()

    # -- spans --------------------------------------------------------

    def _new_id(self):
        with self._lock:
            i = self._next_id
            self._next_id += 1
            return i

    def span(self, name, parent=None, **attrs):
        """Open a span. Use as ``with tracer.span("phase") as sp:``.

        ``parent`` is an explicit (trace_id, span_id) context (from
        Span.context()) for cross-thread parenting; by default the
        innermost span open on THIS thread is the parent. Disabled
        tracers return the no-op singleton.
        """
        if not self.enabled:
            return NULL_SPAN
        span_id = self._new_id()
        if parent is not None:
            trace_id, parent_id = parent
        else:
            top = self.current()
            if top is not None:
                trace_id, parent_id = top.trace_id, top.span_id
            else:
                trace_id, parent_id = span_id, None
        return Span(self, name, attrs, trace_id, span_id, parent_id)

    def current(self):
        """Innermost open span on this thread, or None."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def current_context(self):
        """(trace_id, span_id) of the innermost open span on this
        thread, or None — the token to pass across threads."""
        top = self.current()
        return top.context() if top is not None else None

    def _push(self, span):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(span)
        with self._lock:
            self._open[span.span_id] = span

    def _pop(self, span):
        span.duration = time.perf_counter() - span._t0
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is span:
            stack.pop()
        elif stack and span in stack:  # exited out of order; heal
            stack.remove(span)
        with self._lock:
            self._open.pop(span.span_id, None)
            self._append(self._spans, span.to_dict(), "spans")

    def _append(self, ring, item, kind):
        # Caller holds self._lock.
        ring.append(item)
        if len(ring) > self.capacity:
            del ring[:len(ring) - self.capacity]
            if kind == "spans":
                self._dropped_spans += 1
            else:
                self._dropped_events += 1

    # -- events -------------------------------------------------------

    def event(self, name, **fields):
        """Record a structured instant event (an engine quarantine,
        its recovery...)."""
        if not self.enabled:
            return
        ctx = self.current_context()
        rec = {"name": name, "unix": time.time(),
               "thread": threading.current_thread().name,
               "fields": fields}
        if ctx is not None:
            rec["trace_id"], rec["parent_id"] = ctx
        with self._lock:
            self._append(self._events, rec, "events")

    # -- metrics ------------------------------------------------------

    def histogram(self, name, help_text="", labels=None, buckets=None):
        """Get-or-create a histogram. Histograms record regardless of
        the enabled flag: they are the scrapeable /metrics surface,
        and their cost is O(1) with no per-observation allocation."""
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = Histogram(name, help_text, labels, buckets)
                self._histograms[key] = h
            return h

    def counter(self, name, inc=1, **labels):
        """Increment a monotonically increasing counter."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + inc

    def gauge(self, name, value, **labels):
        """Set a gauge to an instantaneous value (straggler skew,
        queue depths...). Unlike counters these go up AND down; like
        counters they live until reset() and export on every scrape."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = float(value)

    # -- export seams -------------------------------------------------

    def snapshot(self):
        """Journal snapshot: completed spans, open spans, events,
        drop counts. The /debug/trace payload and the trace-file
        body share this one shape."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "identity": identity(),
                "started_unix": self._started_unix,
                "spans": list(self._spans),
                "open_spans": [s.to_dict() for s in
                               self._open.values()],
                "events": list(self._events),
                "dropped_spans": self._dropped_spans,
                "dropped_events": self._dropped_events,
            }

    def histograms(self):
        with self._lock:
            return list(self._histograms.values())

    def counters(self):
        with self._lock:
            return dict(self._counters)

    def gauges(self):
        with self._lock:
            return dict(self._gauges)


# The process-wide tracer the port's servers share: every request,
# step and event lands in ONE journal.
TRACER = Tracer()


def get_tracer():
    return TRACER

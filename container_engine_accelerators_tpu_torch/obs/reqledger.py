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

"""Per-request latency attribution ledger + saturation signals.

The port's own copy of the JAX package's ``obs/reqledger.py``: every
wall-second between a request's submit and its retire lands in exactly
ONE attribution bucket, so the buckets of a retired record sum to its
wall time.

Buckets (:data:`ATTRIBUTION_BUCKETS`): ``queue_wait`` (queued, blocked
on a slot or nothing), ``block_wait`` (queued, blocked on the KV-block
budget), ``prefill`` (the admission prefill through the first token),
``rehydrate`` (the spill-tier upload share of the admission),
``recovery`` (an engine quarantine's stall: fault, rebuild and the
replay admission), ``decode_gap`` (between delivered tokens),
``stream_backpressure`` (a streaming row's gap while its previous
tokens sat unconsumed) and ``other`` (the residue).

:class:`RequestTimeline` is the per-request accumulator the serving
loop stamps; :class:`RequestLedger` the bounded ring of retired
records behind ``tpu_serving_latency_attribution_seconds{bucket=}``,
/stats ``latency_attribution`` and /debug/requests; :func:`saturation`
the cause-wise 0..1 saturation (slots, kv_blocks, queue_age) and its
max that /readyz and the fleet router shed on.
"""

import collections
import threading
import time

from ..utils import env_number
from .metric_names import SERVING_LATENCY_ATTRIBUTION
from .trace import get_tracer

# Every wall-second of a request lands in exactly one of these; the
# order is the canonical display/report order (waits, admission,
# recovery, steady-state, remainder).
ATTRIBUTION_BUCKETS = ("queue_wait", "block_wait", "prefill",
                       "rehydrate", "recovery", "decode_gap",
                       "stream_backpressure", "other")

# The fleet router's bucket set (serving/router.py), same sum-to-wall
# contract over the router's submit -> final-byte wall:
#
#   - ``router_queue``: receipt through the placement decision
#     (fleet-view fetch, affinity lookup, admission bookkeeping);
#   - ``fairness_wait``: parked on the tenant deficit counter inside
#     the bounded fairness-wait budget instead of shedding 429;
#   - ``shed_backoff``: parked re-polling an unroutable fleet inside
#     the bounded shed-backoff budget before giving up 503;
#   - ``upstream_ttfb``: placement through the FIRST upstream body
#     line (connect + engine queue + prefill as the router sees it);
#   - ``stream``: relaying upstream body lines to the client;
#   - ``splice_resubmit``: a mid-stream failover, from the upstream
#     failure through the sibling's first spliced line;
#   - ``other``: the unattributed remainder (shed replies, client
#     disconnect residue), keeping the sum honest.
ROUTER_BUCKETS = ("router_queue", "fairness_wait", "shed_backoff",
                  "upstream_ttfb", "stream", "splice_resubmit",
                  "other")

# The buckets that make up TTFT (submit -> first token); the rest is
# the token-gap (TPOT) side. ``recovery`` ranks on the gap side: the
# canonical quarantine stall lands mid-stream, between delivered
# tokens.
TTFT_BUCKETS = ("queue_wait", "block_wait", "prefill", "rehydrate")
GAP_BUCKETS = ("decode_gap", "stream_backpressure", "recovery")

SATURATION_CAUSES = ("slots", "kv_blocks", "queue_age")

# Retired-record ring capacity (the /debug/requests window).
REQ_LEDGER_CAP_ENV = "CEA_TPU_REQ_LEDGER_CAP"
DEFAULT_REQ_LEDGER_CAP = 512

# Horizon that normalizes admission-queue age into the queue_age
# saturation cause: a head-of-line request waiting this long reads
# 1.0. <= 0 disarms the cause (it reads 0.0), mirroring the SLO
# threshold envs.
SAT_QUEUE_HORIZON_ENV = "CEA_TPU_SAT_QUEUE_S"
DEFAULT_SAT_QUEUE_HORIZON_S = 1.0


class RequestTimeline:
    """One request's wall-clock partition, stamped by the owner.

    ``lap(bucket)`` attributes everything since the previous stamp to
    ``bucket`` and moves the stamp — successive laps PARTITION the
    request's lifetime, which is what makes the sum-to-wall invariant
    hold by construction rather than by bookkeeping discipline.
    ``move`` re-attributes time between buckets after the fact (the
    rehydrate seam: the upload happens inside the admit call, so it
    laps into ``prefill`` first and moves out). ``finish`` closes the
    books: the residue laps into ``other`` and the retired record
    comes back JSON-safe with its rounded buckets still summing to
    the rounded wall exactly.

    Not thread-safe; the serving loop owns each instance (the same
    single-writer contract as the engine's pool state).

    ``bucket_names`` swaps the partition's vocabulary (default the
    engine's :data:`ATTRIBUTION_BUCKETS`; the router passes
    :data:`ROUTER_BUCKETS`): any tuple ending in the ``other``
    residue bucket works, and the sum-to-wall contract is identical.
    """

    __slots__ = ("submit_unix", "submit_t", "buckets", "first_token_t",
                 "finished", "_mark", "_clock", "_bucket_names")

    def __init__(self, clock=time.perf_counter,
                 bucket_names=ATTRIBUTION_BUCKETS):
        self._clock = clock
        self._bucket_names = tuple(bucket_names)
        if "other" not in self._bucket_names:
            raise ValueError(
                "bucket_names needs an 'other' residue bucket")
        self.submit_unix = time.time()
        self.submit_t = clock()
        self._mark = self.submit_t
        self.buckets = dict.fromkeys(self._bucket_names, 0.0)
        self.first_token_t = None
        self.finished = False

    def lap(self, bucket, now=None):
        """Attribute [last stamp, now) to ``bucket``; returns now."""
        if now is None:
            now = self._clock()
        if now > self._mark:
            self.buckets[bucket] += now - self._mark
            self._mark = now
        return now

    def move(self, src, dst, seconds):
        """Re-attribute up to ``seconds`` from ``src`` to ``dst``
        (clamped to what ``src`` holds, so the partition stays a
        partition whatever the caller measured)."""
        moved = min(max(float(seconds), 0.0), self.buckets[src])
        self.buckets[src] -= moved
        self.buckets[dst] += moved
        return moved

    def note_first_token(self, now=None):
        """Stamp the TTFT endpoint (the first token's delivery)."""
        if self.first_token_t is None:
            self.first_token_t = (self._clock() if now is None
                                  else now)

    def finish(self, outcome, *, tokens=0, stream=False,
               prompt_len=None, now=None):
        """Close the record: residue -> ``other``, wall computed,
        rounded buckets repaired to sum to the rounded wall exactly
        (the JSON a consumer checks must honor the same invariant
        the floats do). Returns the retired record dict."""
        now = self.lap("other", now)
        self.finished = True
        wall = round(now - self.submit_t, 6)
        rounded = {b: round(self.buckets[b], 6)
                   for b in self._bucket_names if b != "other"}
        # The exact partition sums to wall; push the rounding residue
        # into `other` so the serialized record sums exactly too
        # (clamped: a -0.000001 other would fail its own contract).
        rounded["other"] = max(
            0.0, round(wall - sum(rounded.values()), 6))
        record = {
            "submit_unix": round(self.submit_unix, 6),
            "wall_s": wall,
            "buckets": {b: rounded[b] for b in self._bucket_names},
            "outcome": str(outcome),
            "tokens": int(tokens),
            "stream": bool(stream),
            "ttft_s": (round(self.first_token_t - self.submit_t, 6)
                       if self.first_token_t is not None else None),
        }
        if prompt_len is not None:
            record["prompt_len"] = int(prompt_len)
        return record


class RequestLedger:
    """Bounded ring of retired attribution records + the per-bucket
    latency histograms behind ``/stats``'s ``latency_attribution``.

    Every retired record observes each bucket's seconds into ONE
    fixed-grid histogram per bucket
    (``tpu_serving_latency_attribution_seconds{bucket=...}``), so the
    p50/p99 answer "across requests, how much latency does bucket X
    contribute" — zeros included deliberately: a bucket that rarely
    fires shows a near-zero p50 and a tail-only p99, which is exactly
    the shape an SLO postmortem needs.

    ``bucket_names``/``metric`` retarget the ledger at a different
    attribution vocabulary and histogram family: the fleet router
    runs one with :data:`ROUTER_BUCKETS` behind
    ``tpu_router_latency_attribution_seconds``.
    """

    def __init__(self, capacity=None, tracer=None,
                 bucket_names=ATTRIBUTION_BUCKETS,
                 metric=SERVING_LATENCY_ATTRIBUTION):
        if capacity is None:
            capacity = env_number(REQ_LEDGER_CAP_ENV,
                                  DEFAULT_REQ_LEDGER_CAP, parse=int)
        self.capacity = max(1, int(capacity))
        self.bucket_names = tuple(bucket_names)
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=self.capacity)
        self._retired = 0
        tracer = tracer or get_tracer()
        self._hists = {
            b: tracer.histogram(
                metric,
                "Per-request latency attributed to each bucket",
                labels={"bucket": b})
            for b in self.bucket_names}

    def add(self, record):
        with self._lock:
            self._ring.append(record)
            self._retired += 1
        buckets = record.get("buckets") or {}
        for b, hist in self._hists.items():
            hist.observe(buckets.get(b, 0.0))

    def retired_total(self):
        with self._lock:
            return self._retired

    def records(self, limit=None):
        """Newest-first retired records (the /debug/requests body)."""
        with self._lock:
            out = list(self._ring)
        out.reverse()
        if limit is not None:
            out = out[:max(0, int(limit))]
        return out

    def attribution_stats(self):
        """{bucket: {p50_ms, p99_ms, total_s, count}} — the /stats
        ``latency_attribution`` payload (bucket-interpolated
        estimates, same method as the TTFT/TPOT percentiles)."""
        out = {}
        for b in self.bucket_names:
            hist = self._hists[b]
            _, total, count = hist.snapshot()
            p50 = hist.quantile(0.5)
            p99 = hist.quantile(0.99)
            out[b] = {
                "p50_ms": (round(p50 * 1e3, 3)
                           if p50 is not None else None),
                "p99_ms": (round(p99 * 1e3, 3)
                           if p99 is not None else None),
                "total_s": round(total, 6),
                "count": count,
            }
        return out

    def state(self, max_rows=32):
        """Postmortem state provider payload: what the last retired
        requests spent their time on when the process died."""
        return {
            "capacity": self.capacity,
            "retired_total": self.retired_total(),
            "records": self.records(max_rows),
        }

    def reset(self):
        """Zero everything in place (the post-warm-up /
        reset_counters discipline: histograms stay wired to the
        export surface, the ring empties)."""
        with self._lock:
            self._ring.clear()
            self._retired = 0
        for hist in self._hists.values():
            hist.reset()


def saturation(slots_active=None, slots_total=None,
               blocks_available=None, blocks_usable=None,
               oldest_wait_s=None, queue_horizon_s=None):
    """Cause-wise saturation in [0, 1] plus their max — the signal an
    HPA or fleet router scales/sheds on (``tpu_serving_saturation``
    and ``tpu_serving_saturation_cause{cause=...}``).

      - ``slots``: active / total engine slots;
      - ``kv_blocks``: 1 - available / usable arena blocks, where
        *available* already nets out admitted rows' growth
        reservations (the same budget ``can_admit`` gates on) —
        omitted on the dense pool;
      - ``queue_age``: oldest admission-queue wait normalized by
        ``queue_horizon_s`` (default ``CEA_TPU_SAT_QUEUE_S``, 1.0s;
        <= 0 disarms the cause).

    Max-over-causes rather than a blend: a pool can be block-starved
    at 2 active slots of 16, and averaging would hide exactly the
    starvation the signal exists to expose. Pure function of plain
    numbers so the corner cases pin by unit test.
    """
    causes = {}
    if slots_total:
        causes["slots"] = min(
            1.0, max(0.0, float(slots_active or 0) / slots_total))
    if blocks_usable:
        causes["kv_blocks"] = min(1.0, max(
            0.0, 1.0 - float(blocks_available or 0) / blocks_usable))
    if queue_horizon_s is None:
        queue_horizon_s = env_number(SAT_QUEUE_HORIZON_ENV,
                                     DEFAULT_SAT_QUEUE_HORIZON_S)
    if queue_horizon_s and queue_horizon_s > 0:
        causes["queue_age"] = min(
            1.0, max(0.0, float(oldest_wait_s or 0.0))
            / queue_horizon_s)
    else:
        causes["queue_age"] = 0.0
    return {"max": max(causes.values(), default=0.0),
            "causes": causes}

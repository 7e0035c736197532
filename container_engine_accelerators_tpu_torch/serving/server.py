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

"""HTTP model servers: image prediction and LM generation.

Counterpart of the JAX package's ``serving/server.py``. Both servers
share ``_BaseServer``'s contract:

  GET /healthz          liveness: 200 once warm, through drains and
                        engine quarantines (503 {"status": "warming"}
                        before)
  GET /readyz           readiness: 200, or 503 {state, retry_after_s,
                        saturation_cause} with Retry-After while
                        warming, draining, quarantined or breaker-open
  GET /metrics          Prometheus text of the process tracer,
                        histogram buckets included
  GET /debug/requests   the retired-request attribution ring
                        (generation; ?n= caps it), /debug/trace and
                        /debug/varz
  GET /debug/profile    ?seconds=N of torch.profiler trace (below)
  GET /stats, GET /v1/models/<name>

Every POST runs under a ``serving.request`` span parented on the
inbound ``traceparent`` header, with the ``x-cea-request-id`` echoed
(obs.propagate); during a drain, and on overload, POSTs answer 503
with Retry-After.

``InferenceServer``: POST /v1/models/<name>:predict {"instances":
[[H][W][C]...]} -> {"predictions": [{"class", "score"}]}, the argmax
and the largest softmax probability of the model's eval forward,
micro-batched by ``_Batcher`` and padded to ``max_batch``.

``GenerationServer``: POST /v1/models/<name>:generate
    {"prompts": [[ids...], ...] | "text": ["...", ...],
     "max_new_tokens": N, "temperature": T, "top_k": K, "top_p": P,
     "min_p": M, "repetition_penalty": R, "eos_id": E,
     "logprobs": bool, "stream": bool}
    -> {"sequences": [[...], ...][, "logprobs": [[...], ...]]
        [, "completions": ["...", ...]]}
    or, with "stream": true, ndjson lines {"tokens": [t]
    (, "completion_delta": "...")} then {"done": true} or the error
    envelope {"error", "retryable", "request_id"}

Prompts of one request share a length and are right-padded into a
fixed set of length buckets. One loop thread owns the slot engine
(``_EngineService``): at every step boundary it retires rows at EOS or
their token budget, admits queued rows in FIFO order while the engine
has room for the head (``admission_block_cause``), and runs one decode
step over all slots. The engine's pool is the JAX server's: paged
unless ``CEA_TPU_PAGED_KV=0`` selects the dense pool, whose admission
prefill runs the flash kernel. A device-side failure of a step or an
admission quarantines the engine, rebuilds it through the server's one
engine recipe and replays every in-flight row (prompt plus the tokens
already delivered, as one forced prefix): greedy streams resume token-
identical. ``CEA_TPU_FAULT_PLAN`` injects such failures
(``utils/faults.py``).

With a ``tokenizer`` requests may carry text (ragged rows, each with
its own prompt length) and responses gain the decoded generated region,
trimmed at ``eos_id``. ``warm=True`` sends one warm row per bucket
through the engine before /healthz answers 200. A stream is one prompt
whose tokens reach the client as each step lands; a client that
leaves cancels its row. With a ``draft_model`` and ``speculative_k`` >=
2 the engine speculates; ``prefix_tokens`` pins a system prompt in the
paged arena and requests carry only their suffix.

Tooling, as the JAX server wires it: GET /debug/profile?seconds=N
captures a torch.profiler trace (obs/profiler.py: 409 while another
capture runs, 501 where the profiler cannot); /stats carries
``hbm_in_use_bytes`` and ``hbm_peak_bytes`` (obs/memory.py's CUDA
allocator monitor, None on the CPU) and, for generation,
``decode_mfu`` (2·N analytic FLOPs per active row per step, N the
engine's ``active_param_count``, plus 4·D per attended key per query
head per layer over each active row's live context, over the step's
wall time and the card's peak; None where no peak is known); the
postmortem providers ``hbm_memory``, ``serving_requests`` and, on the
paged pool, ``serving_kv_blocks`` land in a SIGTERM or crash flight
record (obs/postmortem.py).

Not carried from the JAX server: the device plugin's health query in
/stats (a TPU device plugin).
"""

import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .. import obs
from ..analysis import tsan
from ..models.decode import (
    DEFAULT_SPILL_BYTES,
    KV_BLOCKS_ENV,
    KV_SPILL_BYTES_ENV,
    SPEC_KV_BLOCKS_ENV,
    EngineCapacityError,
    SlotDecodeEngine,
    kv_quant_mode,
    kv_spill_enabled,
    paged_kv_enabled,
)
from ..models.speculative import check_spec_models
from ..obs import metric_names, postmortem
from ..obs.efficiency import (
    DECODE_MFU_GAUGE,
    FlopsLedger,
    device_kind,
    peak_flops_per_chip,
    transformer_decode_flops,
)
from ..obs.memory import get_monitor, install_postmortem_provider
from ..obs.reqledger import RequestLedger, RequestTimeline, saturation
from ..ops.attention import flash_fwd
from ..utils import env_number
from .affinity import KV_BLOCK_ENV
from .lockstep import build_engine as lockstep_engine

log = logging.getLogger(__name__)

REQUEST_HISTOGRAM = "serving_request_latency_seconds"
DECODE_HISTOGRAM = "serving_decode_latency_seconds"
# Per-step slot occupancy (active / total, 0..1].
OCCUPANCY_HISTOGRAM = metric_names.SERVING_SLOT_OCCUPANCY
OCCUPANCY_BUCKETS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                     1.0)
# TTFT = admission-queue entry to the first token out of the admission
# prefill; TPOT = the gap between consecutive tokens of one row. The
# env thresholds arm the burn counter.
TTFT_HISTOGRAM = metric_names.SERVING_TTFT
TPOT_HISTOGRAM = metric_names.SERVING_TPOT
SLO_COUNTER = metric_names.SERVING_SLO_VIOLATIONS
SLO_TTFT_ENV = "CEA_TPU_SLO_TTFT_MS"
SLO_TPOT_ENV = "CEA_TPU_SLO_TPOT_MS"
# Engine supervisor: rebuild attempts per quarantine episode and the
# initial backoff between them (doubling; the circuit breaker reopens
# on the same schedule).
REBUILD_RETRIES_ENV = "CEA_TPU_ENGINE_REBUILD_RETRIES"
DEFAULT_REBUILD_RETRIES = 3
REBUILD_BACKOFF_ENV = "CEA_TPU_ENGINE_REBUILD_BACKOFF_MS"
DEFAULT_REBUILD_BACKOFF_MS = 200.0
# SIGTERM's drain window: in-flight work runs to completion inside it
# while new POSTs answer 503.
DRAIN_GRACE_ENV = "CEA_TPU_DRAIN_GRACE_S"
DEFAULT_DRAIN_GRACE_S = 30.0
# Allocator stats are a runtime call: the step boundary samples them at
# most this often.
MEMORY_SAMPLE_INTERVAL_S = 2.0
REBUILD_COUNTER = metric_names.SERVING_ENGINE_REBUILDS


def _slo_threshold_s(env_key):
    ms = env_number(env_key, None)
    # <= 0 disarms, exactly like unset.
    return ms / 1e3 if ms is not None and ms > 0 else None


def _drain_grace_s(grace_s):
    if grace_s is None:
        grace_s = env_number(DRAIN_GRACE_ENV, DEFAULT_DRAIN_GRACE_S)
    return max(0.0, grace_s)


class _Admission:
    """The server's admitted-but-unserved row budget, shared by
    everything that admits rows (0/None = unbounded)."""

    def __init__(self, max_queue):
        self._lock = threading.Lock()
        self._free = max_queue if max_queue else float("inf")

    def try_acquire(self, n):
        with self._lock:
            if n > self._free:
                return False
            self._free -= n
            return True

    def release(self, n):
        with self._lock:
            self._free += n


class _Batcher:
    """Groups concurrent requests into micro-batches of up to
    ``max_batch`` rows, waiting at most ``max_wait_ms`` for the batch
    to fill. ``admission`` bounds admitted-but-unserved rows: past it a
    request sheds whole (``submit_many`` admits all its rows or
    none)."""

    def __init__(self, run_batch, max_batch, max_wait_ms,
                 max_queue=0, admission=None):
        self._run = run_batch
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1000.0
        self._queue = queue.Queue()
        self._admission = admission or _Admission(max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="serving-batcher", daemon=True)
        self._thread.start()

    def submit_many(self, instances):
        """Admit all rows or none: the result queues, or None when
        admitting them would exceed the bound. The submitting
        request's span context rides with each row, and the batch
        span parents to the first co-batched request's."""
        if not self._admission.try_acquire(len(instances)):
            return None
        ctx = obs.TRACER.current_context()
        dones = []
        for instance in instances:
            done = queue.Queue(maxsize=1)
            self._queue.put((instance, done, ctx))
            dones.append(done)
        return dones

    def stop(self):
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=5)
        # Rows behind the shutdown sentinel would leave their handler
        # threads blocked on done.get() forever.
        try:
            while True:
                item = self._queue.get_nowait()
                if item is not None:
                    item[1].put(("error", "server stopping"))
        except queue.Empty:
            pass

    def _loop(self):
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None:
                continue
            batch = [item]
            deadline = time.monotonic() + self._max_wait_s
            while len(batch) < self._max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            instances = [b[0] for b in batch]
            parent = next((b[2] for b in batch if b[2] is not None),
                          None)
            try:
                with obs.span("serving.batch", parent=parent,
                              batch_size=len(batch)):
                    outputs = self._run(instances)
                for (_, done, _ctx), out in zip(batch, outputs):
                    done.put(("ok", out))
            except Exception as e:  # surface per request, keep serving
                log.exception("batch inference failed")
                for _, done, _ctx in batch:
                    done.put(("error", str(e)))
            finally:
                self._admission.release(len(batch))


class _StreamBody:
    """Iterator over a streaming response that owns its row: ``close``
    releases exactly once however far iteration got (a generator never
    iterated runs no ``finally`` on close), and the HTTP handler calls
    it in its own ``finally``."""

    def __init__(self, gen, release):
        self._gen = gen
        self._release = release
        self._released = False

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        try:
            self._gen.close()
        finally:
            if not self._released:
                self._released = True
                self._release()


class _EngineWork:
    """One request row through the slot engine: queued -> admitted
    (first token from the admission prefill) -> stepped -> retired
    (EOS, budget or cancel). A streamed row reports each token on
    ``stream_q``; a warm row (``account=False``) stays out of the
    latency, token and attribution counters, and ``no_prefix`` keeps it
    out of the prefix index. ``episodes`` counts the quarantines the
    row was caught in."""

    __slots__ = ("row", "p_len", "new", "temperature", "top_k",
                 "top_p", "min_p", "rep_pen", "eos_id", "want_lp",
                 "seed", "done", "stream_q", "ctx", "cancel", "slot",
                 "tokens", "lps", "score_only", "account",
                 "submit_t", "last_tok_t", "no_prefix", "timeline",
                 "request_id", "episodes")

    def __init__(self, row, p_len, new, temperature, top_k, top_p,
                 min_p, rep_pen, eos_id, want_lp, seed, ctx,
                 stream_q=None, score_only=False, account=True,
                 no_prefix=False, request_id=None):
        self.row = row
        self.p_len = p_len
        self.new = new
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.rep_pen = rep_pen
        self.eos_id = eos_id
        self.want_lp = want_lp
        self.seed = seed
        self.ctx = ctx
        self.stream_q = stream_q
        self.done = queue.Queue(maxsize=1) if stream_q is None else None
        self.cancel = threading.Event()
        self.slot = None
        self.tokens = []
        self.lps = []
        self.score_only = score_only
        self.account = account
        self.no_prefix = no_prefix
        self.submit_t = None    # stamped at admission-queue entry
        self.last_tok_t = None  # the previous token's delivery time
        self.timeline = None    # attribution clock, set at submit
        # Rides the streaming error envelope, so a client can tie a
        # retry to the failed attempt.
        self.request_id = request_id or uuid.uuid4().hex[:12]
        self.episodes = 0


class _EngineService:
    """The continuous-batching loop behind GenerationServer: one
    background thread owns the SlotDecodeEngine (single-threaded by
    contract). ``admission`` (the server-wide ``_Admission``) bounds
    submitted-but-unretired rows; past it submissions shed.

    Telemetry: ``serving.engine_step`` and ``serving.prefill`` spans
    (the latter with ``prompt_tokens``, ``shared_tokens``, the padded
    ``width`` and ``phase``; the engine's ``engine.*`` and
    ``model.attention`` spans nest under both), the occupancy,
    step/prefill latency, TTFT/TPOT and rehydrate histograms, the
    slot, KV-block and saturation gauges, the SLO burn
    counters and the request ledger (/stats, /metrics,
    /debug/requests); the decode-MFU ledger and the memory monitor on
    the step boundary; the ``serving_requests`` and, paged,
    ``serving_kv_blocks`` postmortem providers.

    **Supervision** (armed by ``engine_factory``): when ``step()`` or an
    admission raises, the loop QUARANTINES the engine (readiness flips,
    submissions queue), snapshots every in-flight row (host data the
    service holds: prompt, delivered tokens, knobs), builds a fresh
    engine through the factory and REPLAYS the rows ahead of queued
    work, each as its prompt plus its delivered tokens prefilled as one
    forced prefix: greedy streams resume token-identical and the stall
    lands in the ledger's ``recovery`` bucket. A failed rebuild retries
    ``CEA_TPU_ENGINE_REBUILD_RETRIES`` times with doubling backoff from
    ``CEA_TPU_ENGINE_REBUILD_BACKOFF_MS``; exhaustion opens a circuit
    breaker (everything sheds, 503 + Retry-After) that probes the
    factory again on the same schedule. Exactly one
    ``serving.engine_quarantine`` and one ``serving.engine_recovered``
    event per episode; ``tpu_serving_engine_rebuilds_total{reason=}``
    counts triggers. A row caught in more quarantines than the rebuild
    retries (a fault that follows the row rather than the engine)
    fails with a retryable error instead of replaying forever. Without
    a factory a failed step fails the in-flight rows and the pool is
    audited and force-reclaimed before serving on.
    """

    def __init__(self, engine, admission, engine_factory=None):
        self._engine = engine
        self._admission = admission
        self._engine_factory = engine_factory
        self._rebuild_retries = max(1, int(env_number(
            REBUILD_RETRIES_ENV, DEFAULT_REBUILD_RETRIES, parse=int)))
        self._rebuild_backoff_s = max(0.0, env_number(
            REBUILD_BACKOFF_ENV, DEFAULT_REBUILD_BACKOFF_MS) / 1e3)
        self._queue = queue.Queue()
        self._pending = []          # popped but waiting for room
        self._slot_work = {}
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._stopping = False      # gates submit_many under _lock
        self._draining = False      # drain: submissions shed
        self._quarantined = False   # readiness; admissions queue
        self._breaker_open = False  # rebuild gave up; submissions shed
        self._breaker_until = 0.0   # monotonic reopen-probe deadline
        self._breaker_backoff_s = max(self._rebuild_backoff_s, 0.05)
        self._in_episode = False    # one quarantine/recovered pair
        self._inflight = 0          # submitted, not retired (drain)
        self._rebuilds = 0          # successful rebuilds
        self._episodes = 0          # quarantine triggers
        self._replayed_rows = 0     # quarantine replays admitted
        self._replayed_tokens = 0   # forced-prefix tokens re-prefilled
        self._admitted = 0
        self._retired = 0
        self._tokens = 0            # generated tokens (accounted rows)
        # Speculation counters absorbed from engines a quarantine tore
        # down: /stats reports base + live engine.
        self._spec_base = {"spec_steps": 0, "spec_row_steps": 0,
                           "spec_proposed": 0, "spec_accepted": 0,
                           "draft_prefills": 0}
        self._occ_hist = obs.histogram(
            OCCUPANCY_HISTOGRAM,
            "Decode-step slot occupancy (active/total)",
            buckets=OCCUPANCY_BUCKETS)
        self._step_hist = obs.histogram(
            DECODE_HISTOGRAM,
            "Device decode-call latency by program kind",
            labels={"kind": "engine_step"})
        self._prefill_hist = obs.histogram(
            DECODE_HISTOGRAM,
            "Device decode-call latency by program kind",
            labels={"kind": "engine_prefill"})
        self._ttft_hist = obs.histogram(
            TTFT_HISTOGRAM,
            "Admission-to-first-token latency per request")
        self._tpot_hist = obs.histogram(
            TPOT_HISTOGRAM,
            "Inter-token latency per generated token")
        self._rehydrate_hist = obs.histogram(
            metric_names.SERVING_KV_REHYDRATE,
            "Spill-tier rehydrate upload latency per admission")
        self._spill_hits_pub = 0
        self._slo_ttft_s = _slo_threshold_s(SLO_TTFT_ENV)
        self._slo_tpot_s = _slo_threshold_s(SLO_TPOT_ENV)
        self._slo_violations = {"ttft": 0, "tpot": 0}
        self._req_ledger = RequestLedger()
        # The last step-boundary saturation snapshot (the loop writes,
        # /stats reads) and the last admission blocker the loop saw.
        self._last_saturation = None
        self._last_block_cause = None
        # Decode MFU: 2·N analytic FLOPs per active row per step plus
        # the attention over live keys, rated against the engine
        # device's peak (a known card, or CEA_TPU_PEAK_FLOPS; no gauge
        # where neither is known).
        self._mfu = FlopsLedger(
            gauge=DECODE_MFU_GAUGE,
            peak_flops=peak_flops_per_chip(device_kind(engine.device)),
            chips=1, publish_every=32)
        self._memory = get_monitor()
        # Flight-record state: what the last retired requests spent
        # their time on and, paged, the block pool the engine died
        # with. Idempotent by name (one provider a process, last engine
        # wins); the pool goes through _kv_block_state, so a quarantine
        # rebuild's new engine is the one dumped.
        postmortem.register_state_provider(
            "serving_requests", self._req_ledger.state)
        if getattr(engine, "paged", False):
            postmortem.register_state_provider(
                "serving_kv_blocks", self._kv_block_state)
        self._thread = threading.Thread(
            target=self._loop, name="serving-engine", daemon=True)
        self._thread.start()

    @property
    def engine(self):
        """The live engine (a rebuild swaps it)."""
        return self._engine

    def _kv_block_state(self):
        eng = self._engine
        return (eng.block_pool_state() if getattr(eng, "paged", False)
                else {"paged": False})

    def submit_many(self, works):
        """Admit all rows or none; returns the works, or None on shed
        (drain, breaker, budget) or shutdown."""
        now = time.perf_counter()
        with self._lock:
            # Drain and breaker SHED; a quarantine only QUEUES (the
            # rebuild is under way and these rows will serve).
            if self._stopping or self._draining or self._breaker_open:
                return None
            if not self._admission.try_acquire(len(works)):
                return None
            self._inflight += len(works)
            for work in works:
                work.submit_t = now
                work.timeline = RequestTimeline()
                self._queue.put(work)
        return works

    # ----- lifecycle surface (any thread) ----------------------------

    def _engine_state_locked(self):
        """The lifecycle cascade; callers hold self._lock."""
        if self._stopping:
            return "stopping"
        if self._breaker_open:
            return "breaker_open"
        if self._quarantined:
            return "quarantined"
        if self._draining:
            return "draining"
        return "serving"

    def ready(self):
        """The /readyz answer: False while stopping, draining,
        quarantined or breaker-open."""
        with self._lock:
            return self._engine_state_locked() == "serving"

    def engine_state(self):
        with self._lock:
            return self._engine_state_locked()

    def retry_after_s(self):
        """Retry-After seconds for a shed or unready reply: the
        breaker's reopen-probe deadline when open, else 1 + 4 x the
        last saturation (1 for an idle server)."""
        with self._lock:
            if self._breaker_open:
                return max(1, int(self._breaker_until
                                  - time.monotonic() + 1))
            sat = self._last_saturation
        level = sat["max"] if sat else 0.0
        return max(1, int(round(1 + 4 * min(1.0, max(0.0, level)))))

    def saturation_cause(self):
        """The highest-pressure cause of the last saturation snapshot
        (None before one, or at zero pressure)."""
        with self._lock:
            sat = self._last_saturation
        causes = (sat or {}).get("causes") or {}
        if not causes:
            return None
        cause, level = max(causes.items(), key=lambda kv: kv[1])
        return cause if level > 0 else None

    def begin_drain(self):
        """Submissions shed from now on; in-flight work steps on."""
        with self._lock:
            self._draining = True

    def drain(self, grace_s=None):
        """Shed new submissions and wait up to ``grace_s`` (default
        CEA_TPU_DRAIN_GRACE_S) for every in-flight row, queued or
        decoding, to retire. True when it drained in time."""
        deadline = time.monotonic() + _drain_grace_s(grace_s)
        self.begin_drain()
        while True:
            with self._lock:
                if self._inflight == 0:
                    return True
            if time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        with self._lock:
            return self._inflight == 0

    def queue_depth(self):
        with self._lock:
            return self._queue.qsize() + len(self._pending)

    def debug_requests(self, limit=64):
        """The /debug/requests payload: the last ``limit`` retired
        attribution records (newest first) and the per-bucket
        summary."""
        return {
            "capacity": self._req_ledger.capacity,
            "retired_total": self._req_ledger.retired_total(),
            "latency_attribution":
                self._req_ledger.attribution_stats(),
            "records": self._req_ledger.records(limit),
        }

    @staticmethod
    def _q_ms(hist, q):
        v = hist.quantile(q)
        return round(v * 1e3, 3) if v is not None else None

    def stats(self):
        eng = self._engine
        with self._lock:
            steps, row_steps = eng.steps, eng.row_steps
            active = eng.active_count()
            base = self._spec_base
            spec_steps = base["spec_steps"] + eng.spec_steps
            spec_rows = base["spec_row_steps"] + eng.spec_row_steps
            proposed = base["spec_proposed"] + eng.spec_proposed
            accepted = base["spec_accepted"] + eng.spec_accepted
            drafts = base["draft_prefills"] + eng.draft_prefills
            return {
                "slots": eng.slots,
                "slots_active": active,
                "slots_free": eng.slots - active,
                "queue_depth": (self._queue.qsize()
                                + len(self._pending)),
                "engine_steps": steps,
                "engine_prefills": eng.prefills,
                "rows_decoded": row_steps,
                "batch_occupancy_avg": (round(row_steps / steps, 3)
                                        if steps else None),
                "requests_admitted": self._admitted,
                "requests_retired": self._retired,
                "tokens_generated": self._tokens,
                # Bucket-interpolated TTFT/TPOT percentiles and the
                # burn counters (null thresholds: not armed).
                "ttft_p50_ms": self._q_ms(self._ttft_hist, 0.5),
                "ttft_p99_ms": self._q_ms(self._ttft_hist, 0.99),
                "tpot_p50_ms": self._q_ms(self._tpot_hist, 0.5),
                "tpot_p99_ms": self._q_ms(self._tpot_hist, 0.99),
                "slo": {
                    "ttft_ms": (self._slo_ttft_s * 1e3
                                if self._slo_ttft_s else None),
                    "tpot_ms": (self._slo_tpot_s * 1e3
                                if self._slo_tpot_s else None),
                    "violations": dict(self._slo_violations),
                },
                "decode_mfu": self._mfu.mfu(),
                "engine_state": self._engine_state_locked(),
                "engine_rebuilds": self._rebuilds,
                "quarantine_episodes": self._episodes,
                "replayed_rows": self._replayed_rows,
                "replayed_tokens": self._replayed_tokens,
                "latency_attribution":
                    self._req_ledger.attribution_stats(),
                "saturation": (self._last_saturation
                               or saturation(slots_active=active,
                                             slots_total=eng.slots)),
                "admission_blocked_on": self._last_block_cause,
                # Speculation (every engine has the counters; they
                # move only with a draft), cumulative across rebuilds.
                # The acceptance rate is the share of proposals
                # committed; accepted_tokens_per_step the tokens a
                # drafting row commits a step (>= 1).
                "spec_steps": spec_steps,
                "spec_proposed_tokens": proposed,
                "spec_accepted_tokens": accepted,
                "draft_prefills": drafts,
                "speculative_acceptance_rate": (
                    round(accepted / proposed, 4)
                    if proposed else None),
                "accepted_tokens_per_step": (
                    round((accepted + spec_rows) / spec_rows, 3)
                    if spec_rows else None),
                # The paged pool's block and prefix-sharing counters
                # (absent on the dense pool).
                **(eng.kv_block_stats() or {}),
            }

    def reset_counters(self):
        """Drop warm-up's rows from what /stats, /metrics and
        /debug/requests read: the engine's steps, prefills, prefix and
        speculation counters (warm rows draft: their acceptance is not
        the traffic's), the service's admissions, retirements, tokens,
        replays, SLO counters, saturation, the TTFT/TPOT histograms
        and the request ledger."""
        with self._lock:
            eng = self._engine
            eng.steps = 0
            eng.row_steps = 0
            eng.prefills = 0
            eng.reset_prefix_counters()
            eng.spec_steps = 0
            eng.spec_row_steps = 0
            eng.spec_proposed = 0
            eng.spec_accepted = 0
            eng.draft_prefills = 0
            for key in self._spec_base:
                self._spec_base[key] = 0
            self._admitted = 0
            self._retired = 0
            self._tokens = 0
            self._slo_violations = {"ttft": 0, "tpot": 0}
            self._spill_hits_pub = 0
            self._replayed_rows = 0
            self._replayed_tokens = 0
            self._last_saturation = None
            self._last_block_cause = None
        self._req_ledger.reset()
        self._ttft_hist.reset()
        self._tpot_hist.reset()
        self._mfu.reset()

    def stop(self):
        with self._lock:
            self._stopping = True   # no further submissions land
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=30)
        # In-flight rows belong to the loop thread, which finishes
        # them on exit: touching them here could finish a row twice if
        # the join timed out mid-step. Queue items are safe either way.
        if self._thread.is_alive():
            log.error("engine loop did not stop within 30 s; in-flight "
                      "requests answer when it lands")
        try:
            while True:
                item = self._queue.get_nowait()
                if item is not None:
                    self._finish(item, error="server stopping",
                                 retryable=True)
        except queue.Empty:
            pass

    # ----- loop internals (service thread only) ----------------------

    def _finish(self, work, error=None, retryable=False):
        if work.slot is not None:
            self._engine.release(work.slot)
            tsan.note_write("serving.slot_work", self)
            self._slot_work.pop(work.slot, None)
            work.slot = None
        self._admission.release(1)
        if work.timeline is not None and work.account:
            # Close the attribution books: the residue laps into
            # `other`, so the record's buckets sum to its wall time.
            outcome = ("completed" if error is None
                       else "cancelled" if error == "cancelled"
                       else "error")
            record = work.timeline.finish(
                outcome, tokens=len(work.tokens),
                stream=work.stream_q is not None,
                prompt_len=work.p_len)
            record["request_id"] = work.request_id
            if work.ctx:
                record["trace_id"] = "%x" % work.ctx[0]
            self._req_ledger.add(record)
        with self._lock:
            self._retired += 1
            self._inflight -= 1
        if work.stream_q is not None:
            # A stream ends with its done line or its error envelope,
            # whose retryable flag tells a recovering service from a
            # permanent failure.
            work.stream_q.put(("error", error, bool(retryable))
                              if error else ("end",))
        elif error is not None:
            work.done.put(("error", error))
        else:
            work.done.put(("ok", self._result(work)))

    @staticmethod
    def _result(work):
        """The row's [p_len + new] sequence, EOS-padded past an early
        stop like the fixed-horizon decode, and its logprob row with
        ``want_lp``."""
        pad = work.new - len(work.tokens)
        fill = work.eos_id if work.eos_id >= 0 else 0
        seq = np.concatenate([
            np.asarray(work.row[:work.p_len], np.int32),
            np.asarray(work.tokens + [fill] * pad, np.int32)])
        if not work.want_lp:
            return seq
        lps = np.concatenate([np.asarray(work.lps, np.float32),
                              np.zeros((pad,), np.float32)])
        return (seq, lps)

    @staticmethod
    def _allow_prefix(work):
        """Whether a row may share and register prompt-prefix blocks:
        not a row that echoes logprobs (a shared span's echo is never
        computed), nor a warm row."""
        return not (work.want_lp or work.no_prefix)

    def _record_slo(self, which, hist, threshold, seconds):
        hist.observe(seconds)
        if threshold is not None and seconds > threshold:
            with self._lock:
                self._slo_violations[which] += 1
            obs.counter(SLO_COUNTER, slo=which)

    def _deliver(self, work, tok, lp):
        work.tokens.append(tok)
        if work.timeline is not None:
            if len(work.tokens) == 1:
                work.timeline.note_first_token()
            else:
                # A streaming row whose previous tokens still sit
                # unconsumed spent this gap on the client.
                work.timeline.lap(
                    "stream_backpressure"
                    if (work.stream_q is not None
                        and work.stream_q.qsize() > 0)
                    else "decode_gap")
        if work.account:
            now = time.perf_counter()
            if len(work.tokens) == 1:
                if work.submit_t is not None:
                    self._record_slo("ttft", self._ttft_hist,
                                     self._slo_ttft_s,
                                     now - work.submit_t)
            elif work.last_tok_t is not None:
                self._record_slo("tpot", self._tpot_hist,
                                 self._slo_tpot_s,
                                 now - work.last_tok_t)
            work.last_tok_t = now
            with self._lock:
                self._tokens += 1
        if work.want_lp:
            work.lps.append(lp)
        if work.stream_q is not None:
            work.stream_q.put(("tok", tok))
        if (work.eos_id >= 0 and tok == work.eos_id) or (
                len(work.tokens) >= work.new):
            self._finish(work)

    def _publish_saturation(self, active):
        """Compute and publish the cause-wise saturation at a step
        boundary: the max as tpu_serving_saturation, each cause as
        tpu_serving_saturation_cause{cause=}."""
        avail = self._engine.block_availability()
        oldest = None
        for waiting in self._pending:
            t = waiting.timeline.submit_t
            oldest = t if oldest is None else min(oldest, t)
        sat = saturation(
            slots_active=active, slots_total=self._engine.slots,
            blocks_available=avail[0] if avail else None,
            blocks_usable=avail[1] if avail else None,
            oldest_wait_s=((time.perf_counter() - oldest)
                           if oldest is not None else 0.0))
        obs.gauge(metric_names.SERVING_SATURATION, sat["max"])
        for cause, value in sat["causes"].items():
            obs.gauge(metric_names.SERVING_SATURATION_CAUSE, value,
                      cause=cause)
        self._last_saturation = sat
        return sat

    def _attribute_rehydrate(self, timeline):
        """Move the admission's spill-tier upload time out of
        ``prefill`` into ``rehydrate`` (the engine's
        ``drain_rehydrate_events`` seam)."""
        events = self._engine.drain_rehydrate_events()
        for dt in events:
            self._rehydrate_hist.observe(dt)
        if events:
            timeline.move("prefill", "rehydrate", sum(events))

    @staticmethod
    def _replay_view(work):
        """The (row, p_len, max_new) an admission uses: the request as
        sent, or after a quarantine its prompt plus every delivered
        token as one forced prefix, with the budget shrunk by what is
        out. Prefilling the forced prefix rebuilds the KV state the
        dead engine held for the row, so the replay's sampled token is
        the stream's next one (greedy: a token-identical resume; the
        total span is unchanged, so is the block reservation)."""
        if not work.tokens:
            return work.row, work.p_len, work.new
        row = np.concatenate([
            np.asarray(work.row[:work.p_len], np.int32),
            np.asarray(work.tokens, np.int32)])
        return (row, work.p_len + len(work.tokens),
                work.new - len(work.tokens))

    def _admit(self, work):
        """Admit one row (or its quarantine replay). False when the
        attempt consumed the engine (a quarantine fired, or capacity
        raced and the row went back to the head): the caller restarts
        its step boundary."""
        replay = bool(work.tokens)
        # A replay's whole stall (fault, rebuild, this re-prefill)
        # reads as one `recovery` bucket.
        work.timeline.lap("recovery" if replay else "queue_wait")
        row, p_len, max_new = self._replay_view(work)
        t0 = time.perf_counter()
        fault = None
        try:
            # The engine gives the span the prompt's prefix hit and the
            # padded chunk's width.
            with obs.span("serving.prefill", parent=work.ctx,
                          prompt_tokens=int(p_len),
                          phase=("engine_replay" if replay
                                 else "engine_admission")) as sp:
                if work.score_only:
                    echo = self._engine.score(row, p_len, span=sp)
                    work.timeline.lap("prefill")
                    work.lps = list(echo[:p_len])
                    with self._lock:
                        self._admitted += 1
                    self._finish(work)
                    return True
                slot, first, first_lp, echo = self._engine.admit(
                    row, p_len,
                    temperature=work.temperature, top_k=work.top_k,
                    top_p=work.top_p, min_p=work.min_p,
                    repetition_penalty=work.rep_pen, seed=work.seed,
                    max_new=max_new,
                    allow_prefix=self._allow_prefix(work), span=sp)
                work.timeline.lap("recovery" if replay else "prefill")
                self._attribute_rehydrate(work.timeline)
        except EngineCapacityError:
            # The boundary gate said admissible but the pool disagreed:
            # requeue at the head; a release frees capacity.
            log.warning("admission raced pool capacity; requeued")
            self._pending.insert(0, work)
            return False
        except Exception as e:
            if self._supervised():
                # Handled after the finally, so the prefill histogram
                # records the failed attempt and not the rebuild.
                fault = e
            else:
                log.exception("engine admission failed")
                work.timeline.lap("prefill")
                self._attribute_rehydrate(work.timeline)
                self._finish(work, error=str(e), retryable=True)
                return True
        finally:
            self._prefill_hist.observe(time.perf_counter() - t0)
        if fault is not None:
            self._quarantine("prefill", fault, extra=[work])
            return False
        work.slot = slot
        tsan.note_write("serving.slot_work", self)
        self._slot_work[slot] = work
        with self._lock:
            self._admitted += 1
            if replay:
                self._replayed_rows += 1
                self._replayed_tokens += p_len
        if work.want_lp and not replay:
            # A replay keeps its accumulated echo and token logprobs.
            work.lps = list(echo[:p_len])
        self._deliver(work, first, first_lp)
        return True

    # ----- quarantine-and-rebuild supervisor (loop thread only) ------

    def _supervised(self):
        return self._engine_factory is not None

    def _quarantine(self, reason, error, extra=()):
        """Quarantine the engine after a device-side failure: flip
        readiness, take every in-flight row off its slot (the slots die
        with the engine), record one quarantine event per episode, and
        rebuild."""
        victims = list(self._slot_work.values())
        tsan.note_write("serving.slot_work", self)
        self._slot_work.clear()
        for work in victims:
            work.slot = None
        victims.extend(extra)
        with self._lock:
            self._quarantined = True
            self._episodes += 1
        if not self._in_episode:
            self._in_episode = True
            obs.event("serving.engine_quarantine", reason=reason,
                      error=str(error)[:200],
                      error_type=type(error).__name__,
                      inflight=len(victims))
        obs.counter(REBUILD_COUNTER, reason=reason)
        log.error("engine quarantined after %s failure (%s: %s); "
                  "rebuilding with %d in-flight row(s) to replay",
                  reason, type(error).__name__, error, len(victims))
        replay = []
        for work in victims:
            work.episodes += 1
            if work.episodes > self._rebuild_retries:
                self._finish(work, error=f"engine failed {work.episodes}"
                             f" times with this row in flight; retry "
                             f"later", retryable=True)
            else:
                replay.append(work)
        self._rebuild(replay)

    def _install_engine(self, engine):
        # Under _lock: stats() reads the engine from request threads.
        # The dead engine's speculation counters fold into the base
        # before the swap: nothing lost, nothing counted twice.
        with self._lock:
            for key in self._spec_base:
                self._spec_base[key] += int(getattr(self._engine,
                                                    key, 0))
            self._engine = engine

    def _rebuild(self, victims):
        """Build a fresh engine, retrying with doubling backoff; on
        success replay the victims at the head of the queue, on
        exhaustion open the circuit breaker (the server answers 503 +
        Retry-After instead of crash-looping)."""
        backoff = max(self._rebuild_backoff_s, 0.0)
        for attempt in range(1, self._rebuild_retries + 1):
            if self._stop.is_set():
                break
            try:
                engine = self._engine_factory()
            except Exception:
                log.exception("engine rebuild attempt %d/%d failed",
                              attempt, self._rebuild_retries)
                if attempt < self._rebuild_retries:
                    self._stop.wait(backoff)
                    backoff = backoff * 2 if backoff else 0.05
                continue
            self._recover(engine, victims, attempt)
            return
        retry_after = max(self._breaker_backoff_s, 0.05)
        self._breaker_backoff_s = retry_after * 2
        with self._lock:
            self._breaker_open = True
            self._breaker_until = time.monotonic() + retry_after
        log.error("engine rebuild failed %d time(s); circuit breaker "
                  "open, reprobe in %.2fs", self._rebuild_retries,
                  retry_after)
        for work in victims:
            self._finish(work, error="engine rebuild failed; retry "
                         "later", retryable=True)
        self._shed_queued("engine rebuild failed; retry later")

    def _recover(self, engine, victims, attempt):
        self._install_engine(engine)
        now = time.perf_counter()
        for work in victims:
            # The quarantine stall (fault -> rebuilt) into `recovery`.
            if work.timeline is not None:
                work.timeline.lap("recovery", now)
        # Replay ahead of newly queued work: these rows were already
        # mid-service when the engine died.
        self._pending[:0] = victims
        with self._lock:
            self._quarantined = False
            self._breaker_open = False
            self._rebuilds += 1
        self._breaker_backoff_s = max(self._rebuild_backoff_s, 0.05)
        self._in_episode = False
        obs.event("serving.engine_recovered", attempt=attempt,
                  replayed=len(victims))
        log.info("engine rebuilt (attempt %d); replaying %d in-flight "
                 "row(s)", attempt, len(victims))

    def _breaker_tick(self):
        """Breaker-open loop body: wait out the reopen deadline, then
        probe the factory once; success closes the breaker (the
        episode's one recovered event), failure doubles the
        backoff."""
        if time.monotonic() < self._breaker_until:
            self._stop.wait(0.05)
            return
        obs.counter(REBUILD_COUNTER, reason="breaker_probe")
        try:
            engine = self._engine_factory()
        except Exception:
            log.exception("breaker reopen probe failed")
            retry_after = self._breaker_backoff_s
            self._breaker_backoff_s = retry_after * 2
            with self._lock:
                self._breaker_until = time.monotonic() + retry_after
            return
        self._recover(engine, [], 0)

    def _shed_queued(self, error):
        """Fail everything waiting (queue and pending) retryably: the
        breaker's clean-up, so nothing blocks on a service that cannot
        serve."""
        try:
            while True:
                item = self._queue.get_nowait()
                if item is not None:
                    self._finish(item, error=error, retryable=True)
        except queue.Empty:
            pass
        for work in self._pending:
            self._finish(work, error=error, retryable=True)
        self._pending.clear()

    def _publish_step(self, active):
        """The step boundary's gauges: slots, saturation and, paged,
        the block pool and spill tier (host integers, no device
        sync)."""
        self._occ_hist.observe(active / self._engine.slots)
        obs.gauge(metric_names.SERVING_SLOTS_ACTIVE, active)
        obs.gauge(metric_names.SERVING_SLOTS_FREE,
                  self._engine.slots - active)
        self._publish_saturation(active)
        kv = self._engine.kv_block_stats()
        if kv is None:
            return
        obs.gauge(metric_names.SERVING_KV_BLOCKS_TOTAL,
                  kv["kv_blocks_total"])
        obs.gauge(metric_names.SERVING_KV_BLOCKS_FREE,
                  kv["kv_blocks_free"])
        obs.gauge(metric_names.SERVING_KV_BLOCKS_SHARED,
                  kv["kv_blocks_shared"])
        obs.gauge(metric_names.SERVING_KV_SPILL_BLOCKS,
                  kv["kv_spill_blocks"])
        hits = kv["kv_spill_hits"]
        if hits > self._spill_hits_pub:
            obs.counter(metric_names.SERVING_KV_SPILL_HITS,
                        inc=hits - self._spill_hits_pub)
        self._spill_hits_pub = hits
        for dt in self._engine.drain_rehydrate_events():
            self._rehydrate_hist.observe(dt)

    def _loop(self):
        while not self._stop.is_set():
            if self._breaker_open:
                # Degraded: submissions shed while the breaker probes
                # the factory on its schedule.
                self._breaker_tick()
                continue
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._pending.append(item)
            # A client that left while queued gives its budget back now
            # and is never prefilled.
            cancelled = [w for w in self._pending if w.cancel.is_set()]
            if cancelled:
                self._pending[:] = [w for w in self._pending
                                    if not w.cancel.is_set()]
                for work in cancelled:
                    self._finish(work, error="cancelled")
            if not self._pending and not self._slot_work:
                try:
                    item = self._queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item is not None:
                    self._pending.append(item)
                continue  # drain any burst before admitting
            # Cancelled streams retire first: their slots admit queued
            # rows at this boundary.
            for work in list(self._slot_work.values()):
                if work.cancel.is_set():
                    self._finish(work, error="cancelled")
            # FIFO admission: the head waits rather than letting later
            # small requests starve a big one. The gate sees the
            # geometry the admission will use (a replay's forced
            # prefix). Scoring rows need no slot and no blocks.
            blocked_on = None
            while self._pending:
                head = self._pending[0]
                if not head.score_only:
                    g_row, g_plen, g_new = self._replay_view(head)
                    blocked_on = self._engine.admission_block_cause(
                        g_row, g_plen, g_new,
                        allow_prefix=self._allow_prefix(head),
                        repetition_penalty=head.rep_pen,
                        temperature=head.temperature)
                    if blocked_on is not None:
                        break
                if not self._admit(self._pending.pop(0)):
                    # A quarantine fired or capacity raced: the engine
                    # (and _pending) changed; restart the boundary.
                    blocked_on = None
                    break
            self._last_block_cause = blocked_on
            if self._pending:
                # Wait attribution by the cause seen now: while the head
                # lacks KV blocks the whole FIFO block-waits.
                bucket = ("block_wait" if blocked_on == "kv_blocks"
                          else "queue_wait")
                lap_now = time.perf_counter()
                for waiting in self._pending:
                    waiting.timeline.lap(bucket, lap_now)
            if not self._slot_work:
                if self._pending:
                    # The head is blocked with nothing active: only a
                    # cancel or a stop changes that, so wait instead of
                    # spinning (saturation keeps publishing).
                    self._publish_saturation(self._engine.active_count())
                    self._stop.wait(0.05)
                continue
            active = self._engine.active_count()
            keys = self._engine.live_keys()
            parent = next((w.ctx for w in self._slot_work.values()
                           if w.ctx is not None), None)
            t0 = time.perf_counter()
            fault = None
            try:
                with obs.span("serving.engine_step", parent=parent):
                    out = self._engine.step()
            except Exception as e:
                # Handled after the finally, so the step histogram
                # records the failed step, not the rebuild.
                fault = e
            finally:
                step_dt = time.perf_counter() - t0
                self._step_hist.observe(step_dt)
            if fault is not None:
                if self._supervised():
                    self._quarantine("step", fault)
                    continue
                log.error("engine step failed: %s", fault, exc_info=fault)
                for work in list(self._slot_work.values()):
                    self._finish(work, error=str(fault), retryable=True)
                # The failed step may have torn mid-flight (write blocks
                # allocated, positions not advanced): audit the pool and
                # reclaim before serving on.
                leaks = self._engine.pool_leak_report()
                if leaks:
                    log.error("pool invariants violated after step "
                              "failure: %s; force-reclaiming", leaks)
                    residue = self._engine.force_reclaim()
                    if residue:
                        log.error("force_reclaim residue: %s (arena "
                                  "capacity lost)", residue)
                continue
            self._publish_step(active)
            # Decode MFU (N = the ACTIVE parameter count, so MoE's
            # unrouted experts do not inflate it, plus the attention over
            # the rows' live keys) over the step's wall time: step()
            # returns host tokens, so it has synchronized. The memory
            # sample is throttled.
            self._mfu.observe(
                transformer_decode_flops(
                    self._engine.active_param_count, active, keys,
                    self._engine.key_flops),
                step_dt)
            self._memory.sample(min_interval_s=MEMORY_SAMPLE_INTERVAL_S)
            if out is None:
                continue
            if len(out) == 2:   # one token a row
                out = (out[0][:, None], out[1][:, None],
                       np.ones(len(out[0]), np.int64))
            # A speculative step commits counts[slot] tokens a row;
            # delivery stops where the row retires (_finish clears
            # work.slot), the engine's surplus dying with the slot.
            toks, lps, counts = out
            for slot, work in list(self._slot_work.items()):
                for j in range(int(counts[slot])):
                    self._deliver(work, int(toks[slot, j]),
                                  float(lps[slot, j]))
                    if work.slot is None:
                        break
        # Loop exit (stop): this thread owns _pending and _slot_work,
        # so it answers them, exactly once each.
        for work in self._pending + list(self._slot_work.values()):
            self._finish(work, error="server stopping", retryable=True)
        self._pending.clear()


class _BaseServer:
    """HTTP scaffolding shared by the predict and generate servers
    (the module docstring has the contract): one POST route, the GET
    surfaces, latency bookkeeping, readiness and drain."""

    def __init__(self, model_name, port, host="", devices=()):
        self._name = model_name
        # What this replica computes on, captured once (the JAX
        # server's /stats fields): the torch device type and each
        # device's name, so a load harness can reject numbers taken
        # on a CPU fallback.
        self._devices = [str(d) for d in devices]
        self._platform = devices[0].type if devices else None
        # Device-memory telemetry: the process-wide allocator monitor,
        # also a postmortem state provider so a flight record carries
        # the last watermarks (idempotent by name).
        self._memory_monitor = get_monitor()
        install_postmortem_provider(self._memory_monitor)
        # Liveness: /healthz answers 503 until set (warm-up).
        self._ready = threading.Event()
        self._ready.set()
        # Drain: POSTs answer 503 + Retry-After while in-flight work
        # runs to completion; /healthz stays live, /readyz turns 503.
        self._draining = False
        self._requests = 0
        self._shed = 0
        self._posts = 0             # POST handlers running (drain)
        self._latency_hist = obs.histogram(
            REQUEST_HISTOGRAM, "End-to-end serving request latency",
            labels={"model": model_name})
        self._stats_lock = threading.Lock()
        self._http_thread = None
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._handler_class())

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, payload, headers=None):
                body = json.dumps(payload).encode()
                self._send(code, "application/json", body, headers)

            def _send(self, code, ctype, body, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for key, value in (headers or {}).items():
                    self.send_header(key, str(value))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                # /debug/profile first: it carries its own status codes
                # (409 busy, 501 unavailable).
                prof = obs.profile_response(path, query)
                if prof is not None:
                    self._send(prof[0], prof[1], prof[2])
                    return
                debug = obs.debug_response(obs.get_tracer(), path, query)
                if debug is not None:
                    self._send(200, *debug)
                elif path == "/metrics":
                    # Histogram buckets included: the fleet collector
                    # de-cumulates them for its exact merge.
                    self._send(200, "text/plain; version=0.0.4",
                               obs.prometheus_text(
                                   obs.get_tracer()).encode())
                elif path == "/debug/requests":
                    payload = server._debug_requests(query)
                    if payload is None:
                        self._reply(404, {"error": "not found"})
                    else:
                        self._reply(200, payload)
                elif path == "/healthz":
                    # Liveness: live through drains and quarantines
                    # (restarting the pod would not help); only a
                    # replica still warming answers 503.
                    if server._ready.is_set():
                        self._reply(200, {"status": "ok",
                                          "model": server._name})
                    else:
                        self._reply(503, {"status": "warming",
                                          "model": server._name})
                elif path == "/readyz":
                    # Readiness, the router's signal: unready from the
                    # instant a drain starts or the engine quarantines.
                    if server._is_ready():
                        self._reply(200, {"status": "ready",
                                          "model": server._name})
                    else:
                        detail = server._readyz_detail()
                        self._reply(
                            503, dict(detail, status=detail["state"],
                                      model=server._name),
                            headers={"Retry-After": str(
                                detail["retry_after_s"])})
                elif path == "/stats":
                    self._reply(200, server.stats())
                elif path == f"/v1/models/{server._name}":
                    self._reply(200, {"model_version_status": [{
                        "version": "1", "state": "AVAILABLE",
                        "status": {"error_code": "OK",
                                   "error_message": ""},
                        "metadata": server._model_metadata()}]})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != server._post_path():
                    self._reply(404, {"error": "unknown model"})
                    return
                with server._stats_lock:
                    server._posts += 1
                try:
                    # The request's root span, parented on a router's
                    # traceparent; its request id rides along (a
                    # failover splice arrives with the original one).
                    parent_ctx, rid = obs.extract_headers(self.headers)
                    with obs.span("serving.request", parent=parent_ctx,
                                  path=self.path) as req_span:
                        self._serve_post(req_span, rid)
                finally:
                    with server._stats_lock:
                        server._posts -= 1

            def _serve_post(self, req_span, rid=None):
                t0 = time.perf_counter()
                rid = rid or uuid.uuid4().hex[:12]
                req_span.set(request_id=rid)
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(length))
                except (ValueError, TypeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                if server._draining:
                    # Drain rejects at the door: in-flight work runs to
                    # completion, arrivals go elsewhere.
                    self._reply(
                        503, {"error": "server draining; retry",
                              "request_id": rid},
                        headers={"Retry-After": str(
                            server._overload_retry_after())})
                    return
                headers = None
                try:
                    out = server._handle_post(payload, request_id=rid)
                    if len(out) == 3:
                        code, resp, headers = out
                    else:
                        code, resp = out
                except (KeyError, TypeError, ValueError) as e:
                    code, resp = 400, {"error": f"bad request: {e}"}
                except Exception as e:  # model/runtime failure
                    log.exception("POST handler failed")
                    code, resp = 500, {"error": str(e)}
                req_span.set(status=code)
                if code == 200 and isinstance(resp, _StreamBody):
                    self._stream(resp, rid)
                    server._record(time.perf_counter() - t0)
                    return
                if code == 200:
                    server._record(time.perf_counter() - t0)
                self._reply(code, resp, headers=headers)

            def _stream(self, body, rid):
                """ndjson, one line per item; HTTP/1.0 and the closed
                connection frame the body. A failure of the stream
                machinery itself ends with a final error line; close()
                cancels the row however the stream ended (a client
                that left shows as a failed write)."""
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.end_headers()
                    for item in body:
                        self.wfile.write((json.dumps(item) + "\n").encode())
                        self.wfile.flush()
                except Exception as e:  # client gone or stream broken
                    log.info("stream ended early: %r", e)
                    try:
                        self.wfile.write((json.dumps(
                            {"error": str(e), "retryable": False,
                             "request_id": rid}) + "\n").encode())
                    except OSError:
                        pass  # the client went away
                finally:
                    body.close()

        return Handler

    def _post_path(self):
        raise NotImplementedError

    def _handle_post(self, payload, request_id=None):
        """Returns (code, resp) or (code, resp, extra headers)."""
        raise NotImplementedError

    # -- readiness and drain ------------------------------------------

    def _service_ready(self):
        """Subclass hook: readiness beyond warm-up and drain."""
        return True

    def _is_ready(self):
        return (self._ready.is_set() and not self._draining
                and self._service_ready())

    def _unready_reason(self):
        if not self._ready.is_set():
            return "warming"
        if self._draining:
            return "draining"
        return "unready"

    def _overload_retry_after(self):
        """Retry-After seconds of a 503 (overload, drain)."""
        return 1

    def _readyz_detail(self):
        """The /readyz 503 body {state, retry_after_s,
        saturation_cause} the fleet collector and router read."""
        return {"state": self._unready_reason(),
                "retry_after_s": self._overload_retry_after(),
                "saturation_cause": None}

    def begin_drain(self):
        """Start answering POSTs 503 + Retry-After; /healthz stays
        live, in-flight work runs on, /readyz turns unready."""
        self._draining = True

    def _wait_posts(self, deadline):
        """Wait until no POST handler is running (its response written)
        or ``deadline`` passes; True when none is."""
        while True:
            with self._stats_lock:
                if self._posts == 0:
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)

    def drain(self, grace_s=None):
        """SIGTERM's graceful drain: reject new POSTs and wait up to
        ``grace_s`` (default CEA_TPU_DRAIN_GRACE_S) for the running
        ones to answer. True when everything answered in time."""
        deadline = time.monotonic() + _drain_grace_s(grace_s)
        self.begin_drain()
        return self._wait_posts(deadline)

    def _model_metadata(self):
        return {}

    def _debug_requests(self, query):
        """Subclass hook for /debug/requests (None: 404)."""
        return None

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def ready(self):
        return self._ready.is_set()

    def engine_id(self):
        """``role@host:port[pid]``: the replica's identity in /stats and
        fleet rollups."""
        ident = obs.identity()
        return "%s@%s:%s[%s]" % (ident.get("role", "serving"),
                                 ident.get("host", "?"), self.port,
                                 ident.get("pid", "?"))

    def _record(self, latency_s):
        self._latency_hist.observe(latency_s)
        with self._stats_lock:
            self._requests += 1

    def _shed_reply(self):
        with self._stats_lock:
            self._shed += 1
        # Backpressure carries its retry hint: a 503 without
        # Retry-After reads as "gone", not "busy".
        return (503, {"error": "server overloaded; retry"},
                {"Retry-After": str(self._overload_retry_after())})

    def stats(self):
        p50 = self._latency_hist.quantile(0.5)
        p99 = self._latency_hist.quantile(0.99)
        # A fresh allocator sample (throttled); Nones on the CPU.
        self._memory_monitor.sample(min_interval_s=1.0)
        hbm = self._memory_monitor.totals()
        with self._stats_lock:
            out = {
                "engine_id": self.engine_id(),
                "identity": dict(obs.identity(), port=self.port),
                "requests": self._requests,
                "shed": self._shed,
                "platform": self._platform,
                "devices": self._devices,
                "p50_ms": (round(p50 * 1000, 3)
                           if p50 is not None else None),
                "p99_ms": (round(p99 * 1000, 3)
                           if p99 is not None else None),
                "hbm_in_use_bytes": hbm["hbm_in_use_bytes"],
                "hbm_peak_bytes": hbm["hbm_peak_bytes"],
            }
        out.update(self._extra_stats())
        return out

    def _extra_stats(self):
        return {}

    def serve_forever(self):
        log.info("serving model %r on :%d", self._name, self.port)
        self._httpd.serve_forever()

    def shutdown(self):
        """End a running ``serve_forever`` (from another thread)."""
        self._httpd.shutdown()

    def start(self):
        """Serve on a background thread (tests, smoke runs)."""
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http",
            daemon=True)
        self._http_thread.start()

    def stop(self):
        if self._http_thread is not None:
            self._httpd.shutdown()
            self._http_thread.join(timeout=30)
        self._httpd.server_close()


class InferenceServer(_BaseServer):
    """HTTP image prediction around one model's eval forward: the
    port's image models (``models/resnet.py``, NHWC input, f32 logits)
    in eval mode (BatchNorm reads its running statistics) under
    ``torch.inference_mode`` on the model's device. Instances of
    ``input_shape`` (H, W, C) are micro-batched and padded to
    ``max_batch`` rows; one batch runs at construction, before the
    server takes traffic."""

    def __init__(self, model_name, model, input_shape, port=8500,
                 max_batch=8, max_wait_ms=5, max_queue=None, host=""):
        self._device = next(model.parameters()).device
        super().__init__(model_name, port, host=host,
                         devices=[self._device])
        self._model = model.eval()
        self._input_shape = tuple(input_shape)
        self._max_batch = max_batch
        if max_queue is None:
            max_queue = 8 * max_batch
        self._batcher = _Batcher(self._run_batch, max_batch, max_wait_ms,
                                 max_queue=max_queue)
        try:
            self._run_batch([np.zeros(self._input_shape, np.float32)])
        except BaseException:
            self.stop()
            raise

    @torch.inference_mode()
    def predict(self, images):
        """[B, H, W, C] f32 images (numpy) -> (classes [B], scores [B])
        as numpy: the argmax of the logits and the largest softmax
        probability."""
        logits = self._model(torch.as_tensor(images, device=self._device))
        probs = torch.softmax(logits.float(), dim=-1)
        return (torch.argmax(logits, dim=-1).cpu().numpy(),
                probs.max(dim=-1).values.cpu().numpy())

    def _run_batch(self, instances):
        n = len(instances)
        padded = np.zeros((self._max_batch, *self._input_shape),
                          np.float32)
        padded[:n] = np.stack(instances)
        classes, scores = self.predict(padded)
        return [{"class": int(c), "score": float(s)}
                for c, s in zip(classes[:n], scores[:n])]

    def _post_path(self):
        return f"/v1/models/{self._name}:predict"

    def _model_metadata(self):
        return {"kind": "predict",
                "input_shape": list(self._input_shape),
                "max_batch": self._max_batch}

    def _extra_stats(self):
        return {"device": str(self._device)}

    def _handle_post(self, payload, request_id=None):
        try:
            instances = payload["instances"]
        except (KeyError, TypeError) as e:
            return 400, {"error": f"bad request: {e}"}
        arrays = []
        for inst in instances:
            arr = np.asarray(inst, dtype=np.float32)
            if arr.shape != self._input_shape:
                return 400, {
                    "error": f"instance shape {arr.shape} != "
                             f"{self._input_shape}"}
            arrays.append(arr)
        # Every instance is queued before any is waited on, so one
        # request's instances share micro-batches.
        pending = self._batcher.submit_many(arrays)
        if pending is None:
            return self._shed_reply()
        predictions = []
        for done in pending:
            try:
                status, out = done.get(timeout=120)
            except queue.Empty:
                return 500, {"error": "inference timed out"}
            if status != "ok":
                return 500, {"error": out}
            predictions.append(out)
        return 200, {"predictions": predictions}

    def stop(self):
        super().stop()
        self._batcher.stop()


class GenerationServer(_BaseServer):
    """HTTP server for LM generation on the slot engine (the module
    docstring has the contract). The model is the port's TransformerLM
    on its device; the engine's slot_len covers the prefix, the largest
    bucket and ``max_new_tokens``, and ``CEA_TPU_PAGED_KV`` picks its
    pool. One engine recipe builds the engine at construction and at
    every quarantine rebuild: a fresh arena (and draft arena) sharing
    the model's weights, the prefix re-pinned.

    ``tokenizer``: a text codec (``serving.tokenizer``) whose vocab fits
    the model's. ``warm``: warm up before /healthz answers 200, in the
    constructor or, with ``warm_async``, on a background thread;
    ``warm_filters`` (sampling-option dicts) are accepted and ignored
    as in the JAX server, since every sampling variant runs the warm
    rows' kernels. ``draft_model`` (the port's TransformerLM, with its
    own weights) and ``speculative_k``: speculation in the engine,
    checked here (``check_spec_models``) so a replica refuses to build
    on a configuration it cannot serve.

    ``prefix_tokens`` turns on system-prompt serving: the prefix is
    pinned into shared arena blocks of the paged pool (the dense pool
    refuses), every admission prefix-hits it and prefills only its
    suffix, clients send the suffix only and get suffix-relative
    sequences; ``repetition_penalty`` and ``logprobs`` (which need the
    prefix's tokens) answer 400.

    ``lockstep`` (a ``serving.lockstep.Channel``) serves as rank 0 of a
    tensor-parallel group: every engine the recipe makes is made on
    every rank, and its state-changing calls are replayed there
    (``serving/lockstep.py``)."""

    def __init__(self, model_name, model, port=8500, max_new_tokens=64,
                 max_batch=8, buckets=None, max_queue=None, host="",
                 tokenizer=None, warm=False, warm_async=False,
                 warm_filters=None, draft_model=None, speculative_k=0,
                 prefix_tokens=None, lockstep=None):
        self._spec_k = int(speculative_k)
        if self._spec_k:
            if self._spec_k < 1:
                raise ValueError(
                    f"speculative_k must be >= 1: {speculative_k}")
            if draft_model is None:
                raise ValueError("speculative_k requires draft_model")
            check_spec_models(model, draft_model)
        if (tokenizer is not None
                and tokenizer.vocab_size > model.vocab_size):
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} exceeds "
                f"model vocab {model.vocab_size}")
        self._tokenizer = tokenizer
        self._model = model
        self._max_new = max_new_tokens
        self._max_batch = max_batch
        self._admission = _Admission(8 * max_batch if max_queue is None
                                     else max_queue)
        self._seed = 0
        self._prefix_len = 0
        self._prefix_arr = None
        if prefix_tokens is not None:
            if not paged_kv_enabled():
                # The dense pool has no block index to pin into.
                raise ValueError(
                    "prefix_tokens requires the paged KV pool "
                    "(CEA_TPU_PAGED_KV=0 disables the prefix index)")
            prefix_arr = np.asarray(prefix_tokens, np.int32)
            if prefix_arr.ndim != 1 or prefix_arr.size < 1:
                raise ValueError(
                    "prefix_tokens must be a non-empty 1-D id list")
            if (prefix_arr.min() < 0
                    or prefix_arr.max() >= model.vocab_size):
                raise ValueError(
                    f"prefix token ids must be in "
                    f"0..{model.vocab_size - 1}")
            for spec in (warm_filters or []):
                if (float(spec.get("repetition_penalty", 1.0)) != 1.0
                        or spec.get("logprobs", False)):
                    # The shapes _handle_post refuses at request time.
                    raise ValueError(
                        "prefix-serving warm_filters cannot carry "
                        "repetition_penalty or logprobs")
            self._prefix_len = int(prefix_arr.size)
            self._prefix_arr = prefix_arr
        max_prompt = model.max_seq_len - max_new_tokens - self._prefix_len
        if max_prompt < 1:
            raise ValueError(
                f"max_new_tokens {max_new_tokens}"
                + (f" + prefix {self._prefix_len}"
                   if self._prefix_len else "")
                + f" leaves no room for a prompt within max_seq_len "
                  f"{model.max_seq_len}")
        if buckets is None:
            buckets, b = [], 16
            while b < max_prompt:
                buckets.append(b)
                b *= 2
            buckets.append(max_prompt)
        self._buckets = sorted(
            {b for b in buckets if 1 <= b <= max_prompt})
        if not self._buckets:
            raise ValueError("no valid prompt-length buckets")
        slot_len = self._prefix_len + self._buckets[-1] + max_new_tokens
        # k 1 proposes no token a step: the draft-free engine.
        engine_spec_k = self._spec_k if self._spec_k >= 2 else 0
        # The engine knobs the environment gives now (the pool, the
        # cache mode, the block size, the spill tier), read once; the
        # arena sizes follow from the first engine. Every rebuild makes
        # the same engine whatever the environment says by then.
        knobs = dict(
            paged=paged_kv_enabled(), kv_quant=kv_quant_mode(),
            kv_spill=kv_spill_enabled(),
            kv_block_size=int(env_number(KV_BLOCK_ENV, 16, parse=int)),
            kv_blocks=env_number(KV_BLOCKS_ENV, None, parse=int),
            kv_spill_bytes=int(env_number(KV_SPILL_BYTES_ENV,
                                          DEFAULT_SPILL_BYTES, parse=int)),
            spec_kv_blocks=env_number(SPEC_KV_BLOCKS_ENV, None, parse=int))

        def build_engine():
            kwargs = dict(slots=max_batch, slot_len=slot_len,
                          buckets=self._buckets,
                          pin_reserve_tokens=self._prefix_len,
                          draft_model=draft_model if engine_spec_k else None,
                          spec_k=engine_spec_k, **knobs)
            if lockstep is not None:
                engine = lockstep_engine(lockstep, model, **kwargs)
            else:
                engine = SlotDecodeEngine(model, **kwargs)
            if self._prefix_len:
                # Pinned before the loop steps the engine (rebuilds run
                # on the loop thread itself).
                engine.pin_prefix(self._prefix_arr)
            return engine

        first = build_engine()
        if first.paged:
            knobs["kv_blocks"] = first._num_blocks
            if engine_spec_k:
                knobs["spec_kv_blocks"] = first._draft_num_blocks
        self._engine_service = _EngineService(
            first, self._admission, engine_factory=build_engine)
        try:
            super().__init__(model_name, port, host=host,
                             devices=[first.device])
        except BaseException:
            self._engine_service.stop()
            raise
        del warm_filters  # accepted and ignored, as in the JAX server
        self.warm_seconds = None
        if warm:
            self._ready.clear()
            if warm_async:
                threading.Thread(target=self._warm_in_background,
                                 name="serving-warmup", daemon=True).start()
            else:
                try:
                    self._warm_up()
                except BaseException:
                    self.stop()
                    raise

    def _warm_in_background(self):
        try:
            self._warm_up()
        except Exception:
            # Stay unready: the readiness probe keeps traffic away and
            # the startup probe restarts the replica.
            log.exception("warm-up failed; server stays unready")

    def _warm_up(self):
        """One greedy warm row per bucket (two new tokens where
        max_new_tokens allows, speculative_k with a draft so the row's
        span holds a verify chunk): each width's admission prefill (the
        draft's too) and the decode step run once before traffic. A
        prefix server's warm rows go through the pinned prefix (the
        traffic's shape: a prefix hit and a suffix prefill), each with
        its own suffix so no warm row prefix-matches another; the
        others are zeros kept out of the prefix index. Then the
        counters drop the warm rows and /healthz turns 200."""
        t0 = time.perf_counter()
        warm_new = min(max(2, self._spec_k), self._max_new)
        for b in self._buckets:
            if self._prefix_len:
                suffix = (b + np.arange(b)) % self._model.vocab_size
                row = np.concatenate([self._prefix_arr,
                                      suffix.astype(np.int32)])
                work = _EngineWork(row, self._prefix_len + b, warm_new,
                                   0.0, 0, 1.0, 0.0, 1.0, -1, False, 0,
                                   None, account=False)
            else:
                work = _EngineWork(np.zeros((b,), np.int32), b, warm_new,
                                   0.0, 0, 1.0, 0.0, 1.0, -1, False, 0,
                                   None, account=False, no_prefix=True)
            if self._engine_service.submit_many([work]) is None:
                raise RuntimeError("warm-up shed by admission control")
            status, out = work.done.get(timeout=600)
            if status != "ok":
                raise RuntimeError(f"warm-up decode failed: {out}")
        self._engine_service.reset_counters()
        self.warm_seconds = time.perf_counter() - t0
        self._ready.set()
        log.info("warm-up complete: %d buckets in %.2f s",
                 len(self._buckets), self.warm_seconds)

    @property
    def engine(self):
        """The live engine (a quarantine rebuild swaps it)."""
        return self._engine_service.engine

    def _post_path(self):
        return f"/v1/models/{self._name}:generate"

    def _model_metadata(self):
        meta = {"kind": "generate",
                "vocab_size": self._model.vocab_size,
                "max_prompt_len": self._buckets[-1],
                "prompt_buckets": self._buckets,
                "max_new_tokens": self._max_new,
                "max_batch": self._max_batch}
        if self._prefix_len:
            meta["prefix_len"] = self._prefix_len
        return meta

    def _debug_requests(self, query):
        """/debug/requests: the engine service's retired-record ring
        (``?n=`` caps the dump, default 64)."""
        try:
            limit = max(0, int(obs.query_param(query, "n", 64)))
        except (TypeError, ValueError):
            limit = 64
        return self._engine_service.debug_requests(limit)

    def _extra_stats(self):
        out = self._engine_service.stats()
        # The JAX server's alias, for load generators that read it.
        out["avg_batch_occupancy"] = out["batch_occupancy_avg"]
        out["kv_pool"] = "paged" if self.engine.paged else "dense"
        out["flash_fwd_launches"] = flash_fwd.launches
        out["device"] = str(self.engine.device)
        return out

    def _service_ready(self):
        return self._engine_service.ready()

    def _overload_retry_after(self):
        return self._engine_service.retry_after_s()

    def _readyz_detail(self):
        """The lifecycle cascade names the state (draining,
        quarantined, breaker_open; the server's warming or draining
        flag when the engine is fine), with the engine's Retry-After
        and the dominant saturation cause."""
        svc = self._engine_service
        state = svc.engine_state()
        if state == "serving":
            state = self._unready_reason()
        return {"state": state,
                "retry_after_s": svc.retry_after_s(),
                "saturation_cause": svc.saturation_cause()}

    def drain(self, grace_s=None):
        """SIGTERM's graceful drain: reject new POSTs at once (503 +
        Retry-After; /readyz unready, /healthz live), then wait up to
        the grace window for every in-flight row to retire and its
        response to be written. True when all of it finished in
        time."""
        deadline = time.monotonic() + _drain_grace_s(grace_s)
        self.begin_drain()
        drained = self._engine_service.drain(
            max(0.0, deadline - time.monotonic()))
        return self._wait_posts(deadline) and drained

    def stop(self):
        super().stop()
        self._engine_service.stop()

    def _handle_post(self, payload, request_id=None):
        """Validate one request (the JAX server's rules, order and 400
        messages) and run it on the engine. Returns (code, body) or
        (code, body, headers); a stream's body is a
        ``_StreamBody``."""
        try:
            texts = payload.get("text")
            if texts is not None:
                if self._tokenizer is None:
                    return 400, {"error": "server has no tokenizer; "
                                          "send token id prompts"}
                if "prompts" in payload:
                    return 400, {"error": "send text or prompts, "
                                          "not both"}
                if (not isinstance(texts, list)
                        or not all(isinstance(t, str) for t in texts)):
                    return 400, {"error": "text must be a list of "
                                          "strings"}
                prompts = [self._tokenizer.encode(t) for t in texts]
                if any(not p for p in prompts):
                    return 400, {"error": "text rows must encode to "
                                          "at least one token"}
                payload = dict(payload, prompts=prompts)
            prompts = payload["prompts"]
            new = int(payload.get("max_new_tokens", self._max_new))
            temperature = float(payload.get("temperature", 0.0))
            top_k = int(payload.get("top_k", 0))
            top_p = float(payload.get("top_p", 1.0))
            eos_id = int(payload.get("eos_id", -1))
            rep_pen = float(payload.get("repetition_penalty", 1.0))
            min_p = float(payload.get("min_p", 0.0))
            want_lp = bool(payload.get("logprobs", False))
            stream = bool(payload.get("stream", False))
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"bad request: {e}"}
        if stream and (want_lp or rep_pen != 1.0):
            return 400, {"error": "stream does not support logprobs "
                                  "or repetition_penalty"}
        vocab = self._model.vocab_size
        if not -1 <= eos_id < vocab:
            return 400, {"error": f"eos_id must be -1 (off) or in "
                                  f"0..{vocab - 1}"}
        if not 0 <= top_k <= vocab:
            return 400, {"error": f"top_k must be in 0..{vocab}"}
        if not 0.0 <= temperature <= 1e6:
            return 400, {"error": "temperature must be in [0, 1e6]"}
        if not 0.0 < top_p <= 1.0:
            return 400, {"error": "top_p must be in (0, 1]"}
        if not 0.0 < rep_pen <= 100.0:
            return 400, {"error": "repetition_penalty must be in "
                                  "(0, 100]"}
        if not 0.0 <= min_p < 1.0:
            return 400, {"error": "min_p must be in [0, 1)"}
        if (top_k or top_p < 1.0 or min_p > 0.0) and temperature <= 0.0:
            return 400, {"error": "top_k/top_p/min_p require "
                                  "temperature > 0"}
        if self._prefix_len and rep_pen != 1.0:
            return 400, {"error": "repetition_penalty is not "
                                  "supported on a prefix-serving "
                                  "server (the penalty needs "
                                  "prefix-token visibility)"}
        if self._prefix_len and want_lp:
            return 400, {"error": "logprobs is not supported on a "
                                  "prefix-serving server"}
        if not prompts or len(prompts) > self._max_batch:
            return 400, {"error": f"need 1..{self._max_batch} prompts"}
        if texts is None and len({len(p) for p in prompts}) != 1:
            return 400, {"error": "prompts must share one length"}
        if new == 0 and not want_lp:
            return 400, {"error": "max_new_tokens 0 (scoring mode) "
                                  "requires logprobs: true"}
        if new < 0 or new > self._max_new:
            return 400, {"error": f"max_new_tokens must be in "
                                  f"0..{self._max_new}"}
        try:
            if texts is not None:
                # Text rows may be ragged: right-padded to the widest,
                # each with its own prompt length.
                width = max(len(p) for p in prompts)
                arr = np.zeros((len(prompts), width), np.int32)
                for r, p in enumerate(prompts):
                    arr[r, :len(p)] = np.asarray(p, np.int32)
                p_lens = [len(p) for p in prompts]
            else:
                arr = np.asarray(prompts, dtype=np.int32)
                p_lens = [arr.shape[1]] * arr.shape[0]
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad prompt tokens: {e}"}
        if arr.ndim != 2 or arr.shape[1] < 1:
            return 400, {"error": "prompts must be non-empty id lists"}
        if arr.min() < 0 or arr.max() >= vocab:
            return 400, {"error": f"token ids must be in 0..{vocab - 1}"}
        p_len = arr.shape[1]
        bucket = next((b for b in self._buckets if b >= p_len), None)
        if bucket is None:
            return 400, {"error": f"prompt length {p_len} exceeds "
                                  f"max {self._buckets[-1]}"}
        padded = np.zeros((arr.shape[0], bucket), np.int32)
        padded[:, :p_len] = arr
        return self._engine_post(padded, p_lens, new, temperature,
                                 top_k, top_p, min_p, eos_id, rep_pen,
                                 want_lp, stream, texts, request_id)

    def _compose_response(self, rows, p_lens, new, want_lp, texts,
                          eos_id):
        """Result rows ([>= p_len + new] sequences, or (sequence,
        logprobs) pairs with want_lp) -> the response JSON."""
        seqs = [np.asarray(r[0] if want_lp else r) for r in rows]
        resp = {"sequences": [s[:pl + new].tolist()
                              for s, pl in zip(seqs, p_lens)]}
        if want_lp:
            resp["logprobs"] = [
                [round(float(x), 6) for x in np.asarray(r[1])[:pl + new]]
                for r, pl in zip(rows, p_lens)]
        if texts is not None:
            # The decoded generated region, trimmed at eos_id.
            comps = []
            for row, pl in zip(seqs, p_lens):
                ids = row[pl:pl + new].tolist()
                if eos_id >= 0 and eos_id in ids:
                    ids = ids[:ids.index(eos_id)]
                comps.append(self._tokenizer.decode(ids))
            resp["completions"] = comps
        return resp

    def _engine_post(self, padded, p_lens, new, temperature, top_k,
                     top_p, min_p, eos_id, rep_pen, want_lp, stream,
                     texts, request_id=None):
        """Queue one validated request's rows on the engine (a stream:
        its one row, with the ndjson body back) and wait for them."""
        with self._stats_lock:
            seed = self._seed + 1
            self._seed += len(p_lens)
        ctx = obs.TRACER.current_context()
        if self._prefix_len:
            # The rows carry prefix + suffix; the prefix index maps the
            # pinned blocks and only the suffix is prefilled.
            rows = [np.concatenate([self._prefix_arr,
                                    row[:pl].astype(np.int32)])
                    for row, pl in zip(padded, p_lens)]
            row_lens = [self._prefix_len + int(pl) for pl in p_lens]
        else:
            rows, row_lens = list(padded), [int(pl) for pl in p_lens]
        if stream:
            if padded.shape[0] != 1:
                return 400, {"error": "stream requires exactly one "
                                      "prompt"}
            if new < 1:
                return 400, {"error": "stream requires "
                                      "max_new_tokens >= 1"}
            work = _EngineWork(rows[0], row_lens[0], new, temperature,
                               top_k, top_p, min_p, rep_pen, eos_id,
                               False, seed, ctx, stream_q=queue.Queue(),
                               request_id=request_id)
            if self._engine_service.submit_many([work]) is None:
                return self._shed_reply()
            decode_text = (self._tokenizer.decode
                           if texts is not None else None)
            # close() cancels the row; the loop retires it (and
            # releases its budget) at the next step boundary.
            return 200, _StreamBody(
                self._engine_stream(work, decode_text, eos_id),
                work.cancel.set)
        works = [
            _EngineWork(row, pl, new, temperature, top_k, top_p, min_p,
                        rep_pen, eos_id, want_lp, seed + i, ctx,
                        score_only=(new == 0), request_id=request_id)
            for i, (row, pl) in enumerate(zip(rows, row_lens))]
        with obs.span("serving.admission", bucket=padded.shape[1],
                      rows=len(works)) as adm:
            if self._engine_service.submit_many(works) is None:
                adm.set(shed=True)
                return self._shed_reply()
        results = []
        with obs.span("serving.wait", rows=len(works)):
            for work in works:
                try:
                    status, out = work.done.get(timeout=600)
                except queue.Empty:
                    return 500, {"error": "decode timed out"}
                if status != "ok":
                    return 500, {"error": out}
                results.append(out)
        if self._prefix_len:
            # Suffix-relative: the shared prefix is never re-emitted
            # (logprobs are refused on a prefix server).
            results = [np.asarray(r)[self._prefix_len:] for r in results]
        return 200, self._compose_response(results, p_lens, new,
                                           want_lp, texts, eos_id)

    @staticmethod
    def _engine_stream(work, decode_text, eos_id):
        """The ndjson lines of a streamed row: {"tokens": [t]} per
        delivered token (with "completion_delta", the token decoded,
        empty at eos_id, for a text request), then {"done": true}, or
        the error envelope {"error", "retryable", "request_id"} in
        place of the rest (retryable: the service is recovering, and
        the same request replayed should succeed)."""
        while True:
            try:
                item = work.stream_q.get(timeout=120)
            except queue.Empty:
                yield {"error": "decode timed out", "retryable": True,
                       "request_id": work.request_id}
                return
            if item[0] == "tok":
                tok = item[1]
                line = {"tokens": [tok]}
                if decode_text is not None:
                    line["completion_delta"] = decode_text(
                        [] if eos_id >= 0 and tok == eos_id else [tok])
                yield line
            elif item[0] == "end":
                yield {"done": True}
                return
            else:
                yield {"error": item[1], "retryable": bool(item[2]),
                       "request_id": work.request_id}
                return

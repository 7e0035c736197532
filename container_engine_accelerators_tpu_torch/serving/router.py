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

"""Fleet router: the HTTP front door over N shared-nothing engines.

The port's own copy of the JAX package's ``serving/router.py``. One
slot engine is bounded by one block arena; this router scales serving
out by placing requests across a fleet of generation servers (the
port's or the JAX package's: the wire contract is the same) that it
watches through an in-process ``obs.fleet.FleetCollector``:

**Prefix affinity**: a request's placement key is the content-keyed
chain hash of its leading full KV blocks (``serving.affinity``, the
function the engine's block pool indexes prefixes with). The router
remembers which engine served each key last and steers repeat
prefixes back to the engine already holding those blocks; everything
else falls back to least-loaded placement outside the hot set.

**Tenant fairness**: per-tenant weighted deficit counters over token
cost (prompt + requested new tokens). Each tenant accrues allowance at
``weight * CEA_TPU_ROUTER_TENANT_RATE`` tokens/s up to a burst cap; a
request that overdraws is shed 429 with the exact Retry-After that
refills the deficit. Off by default (rate 0).

**Shedding**: once the whole steer set is hot (saturation at or above
``CEA_TPU_ROUTER_SHED_SAT``) or empty, the router sheds 503 with a
saturation-derived Retry-After: the minimum over the fleet of each
engine's own horizon (its ``/readyz`` retry_after_s when unready,
else the ``1 + 4 * saturation`` ramp a single engine's overload shed
uses).

**Mid-stream failover**: on a retryable streaming error envelope or
engine death mid-stream (a truncated read, a reset connection or an
empty read), the router re-submits prompt + tokens-delivered-so-far as
the prompt of a fresh greedy request on a sibling (max_new_tokens
shrunk by what was already delivered) and splices the continuation
into the live response. The client sees one uninterrupted token
stream.

**Request journeys**: every proxied request runs under ONE trace: the
router extracts any inbound ``traceparent``/``x-cea-request-id``
carrier (obs.propagate), opens a ``router.request`` root span, and
injects the SAME context + request id on every upstream call
(admission, stream and the splice resubmit), so the engine's
``serving.request`` span (and a failover sibling's) parents under the
original trace. A :class:`RouterLedger` over
``obs.reqledger.ROUTER_BUCKETS`` partitions each request's receipt ->
final-byte wall into ``router_queue`` / ``fairness_wait`` /
``shed_backoff`` / ``upstream_ttfb`` / ``stream`` /
``splice_resubmit`` / ``other``, per tenant, at ``/debug/requests``
(summarized in ``/fleet/stats``).

Stdlib only at import, torch-free: the front door must keep routing
while every backend is wedged. Token-id prompts only: text prompts
need a tokenizer, which lives with the model, not the router.

Metrics: ``tpu_router_routed_total{reason}``,
``tpu_router_shed_total{reason}``, ``tpu_router_failover_total``,
``tpu_router_affinity_hit_rate``, and the journey plane
(``tpu_router_latency_attribution_seconds{bucket}``,
``tpu_router_e2e_seconds``, ``tpu_router_upstream_ttfb_seconds``,
``tpu_router_slo_violations_total{slo,tenant}``).
"""

import http.client
import json
import logging
import math
import threading
import time
import urllib.parse
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import obs
from ..obs.fleet import FleetView
from ..obs.metric_names import (
    ROUTER_AFFINITY_HIT_RATE,
    ROUTER_E2E_LATENCY,
    ROUTER_FAILOVER,
    ROUTER_LATENCY_ATTRIBUTION,
    ROUTER_ROUTED,
    ROUTER_SHED,
    ROUTER_SLO_VIOLATIONS,
    ROUTER_UPSTREAM_TTFB,
)
from ..utils import env_number, env_str
from .affinity import affinity_key, default_block_size

log = logging.getLogger(__name__)

# Router knobs (the JAX package's names, so one manifest sets both).
SHED_SAT_ENV = "CEA_TPU_ROUTER_SHED_SAT"
AFFINITY_BLOCKS_ENV = "CEA_TPU_ROUTER_AFFINITY_BLOCKS"
AFFINITY_CAP_ENV = "CEA_TPU_ROUTER_AFFINITY_CAP"
TENANT_RATE_ENV = "CEA_TPU_ROUTER_TENANT_RATE"
TENANT_BURST_ENV = "CEA_TPU_ROUTER_TENANT_BURST_S"
TENANT_WEIGHTS_ENV = "CEA_TPU_ROUTER_TENANT_WEIGHTS"
FAILOVER_MAX_ENV = "CEA_TPU_ROUTER_FAILOVER_MAX"
SPILL_BOUND_ENV = "CEA_TPU_ROUTER_SPILL_BOUND"
FAIRNESS_WAIT_ENV = "CEA_TPU_ROUTER_FAIRNESS_WAIT_MS"
SHED_BACKOFF_ENV = "CEA_TPU_ROUTER_SHED_BACKOFF_MS"
SLO_TTFB_ENV = "CEA_TPU_ROUTER_SLO_TTFB_MS"
SLO_E2E_ENV = "CEA_TPU_ROUTER_SLO_E2E_MS"

DEFAULT_TENANT = "default"

# Episode-wise shed/failover journaling: the FIRST occurrence opens
# an episode and emits ONE journal event; repeats within the clear
# window re-arm nothing; a quiet gap of at least the window closes the
# episode so the next occurrence journals again. A 1000-request shed
# storm is one line.
TENANT_SHED_EVENT = "router.tenant_shed"
ENGINE_FAILOVER_EVENT = "router.engine_failover"
EPISODE_CLEAR_S = 5.0

# Routing reasons (the routed_total label set).
REASON_AFFINITY = "affinity"
REASON_LEAST_LOADED = "least_loaded"
REASON_HEDGE = "hedge"
REASON_SPILL = "spill"

# Shed reasons (the shed_total label set).
SHED_TENANT_RATE = "tenant_rate"
SHED_SATURATED = "saturated"
SHED_NO_ENGINES = "no_engines"
SHED_FAILOVER_EXHAUSTED = "failover_exhausted"


def parse_weights(spec):
    """``"teamA=3,teamB=0.5"`` -> {tenant: weight}; blank entries and
    non-numeric weights are ignored (a syntax error in an env var
    must not take the front door down)."""
    weights = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, _, value = part.partition("=")
        try:
            w = float(value)
        except ValueError:
            continue
        if name.strip() and w > 0:
            weights[name.strip()] = w
    return weights


class TenantLedger:
    """Weighted deficit counters: token-rate fairness at the door.

    Each tenant carries a deficit (its spendable token allowance)
    that refills continuously at ``weight * rate`` tokens/s and caps
    at ``burst_s`` seconds of refill (new tenants start with a full
    burst). A request costing more than the tenant's current deficit
    is shed with the exact seconds until the deficit covers it —
    the honest Retry-After, not a constant. ``rate <= 0`` disables
    fairness entirely (every request admits)."""

    def __init__(self, rate=None, burst_s=None, weights=None,
                 clock=time.monotonic):
        self.rate = (float(env_number(TENANT_RATE_ENV, 0.0))
                     if rate is None else float(rate))
        self.burst_s = (float(env_number(TENANT_BURST_ENV, 2.0))
                        if burst_s is None else float(burst_s))
        self.weights = (parse_weights(env_str(TENANT_WEIGHTS_ENV, ""))
                        if weights is None else dict(weights))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = {}   # tenant -> [deficit_tokens, last_ts]

    def weight(self, tenant):
        return self.weights.get(tenant, 1.0)

    def admit(self, tenant, cost_tokens):
        """(admitted, retry_after_s). Deducts on admit."""
        if self.rate <= 0:
            return True, None
        tenant = tenant or DEFAULT_TENANT
        rate = self.rate * self.weight(tenant)
        cap = rate * self.burst_s
        now = self._clock()
        with self._lock:
            state = self._state.get(tenant)
            if state is None:
                state = self._state[tenant] = [cap, now]
            deficit, last = state
            deficit = min(cap, deficit + (now - last) * rate)
            if deficit >= cost_tokens:
                state[0], state[1] = deficit - cost_tokens, now
                return True, None
            state[0], state[1] = deficit, now
            # A cost above the burst cap can never refill — quote the
            # full-cap wait so the client backs off hard instead of
            # retrying a request that cannot ever admit sooner.
            need = min(cost_tokens, cap) - deficit
            return False, max(1, int(math.ceil(need / rate)))

    def snapshot(self):
        with self._lock:
            return {t: {"deficit_tokens": round(s[0], 1),
                        "weight": self.weight(t)}
                    for t, s in self._state.items()}


class RouterCore:
    """The placement brain, HTTP-free and clock-injectable so unit
    tests drive it with a fake fleet view. One instance is shared by
    every proxy thread; internal state is lock-protected."""

    def __init__(self, collector, block_size=None, shed_sat=None,
                 affinity_blocks=None, affinity_cap=None,
                 tenants=None, failover_max=None, spill_bound=None,
                 clock=time.monotonic, episode_clear_s=EPISODE_CLEAR_S):
        self._collector = collector
        self._clock = clock
        self.episode_clear_s = float(episode_clear_s)
        self.block_size = (int(block_size) if block_size
                           else default_block_size())
        self.shed_sat = (float(env_number(SHED_SAT_ENV, 0.95))
                         if shed_sat is None else float(shed_sat))
        self.affinity_blocks = int(
            env_number(AFFINITY_BLOCKS_ENV, 8, parse=int)
            if affinity_blocks is None else affinity_blocks)
        self.affinity_cap = int(
            env_number(AFFINITY_CAP_ENV, 4096, parse=int)
            if affinity_cap is None else affinity_cap)
        self.failover_max = int(
            env_number(FAILOVER_MAX_ENV, 2, parse=int)
            if failover_max is None else failover_max)
        self.spill_bound = int(
            env_number(SPILL_BOUND_ENV, 4, parse=int)
            if spill_bound is None else spill_bound)
        self.tenants = (TenantLedger(clock=clock) if tenants is None
                        else tenants)
        self._lock = threading.Lock()
        self._affinity = OrderedDict()   # chain key -> engine url
        self._routed = {}                # reason -> count
        self._shed = {}                  # reason -> count
        self._failover = 0
        self._aff_lookups = 0
        self._aff_hits = 0
        self._inflight = {}              # url -> requests in proxy
        self._episodes = {}              # (event, key) -> last-seen ts

    # -- fleet view ---------------------------------------------------

    def view(self):
        """The collector's latest poll cycle (forcing one before the
        first completes — the router must route from its first
        request, not its first poll interval)."""
        view = self._collector.view()
        if view is None:
            view = self._collector.poll_once()
        return view

    def hot_set(self, view):
        """Steerable engines the router still steers AROUND: at or
        above the shed saturation. These are excluded from
        least-loaded placement while cold engines exist; once the
        hot set IS the steer set, the router sheds."""
        steer = set(view.steer_set())
        return {e["url"] for e in view.engines
                if e["url"] in steer
                and e["saturation"] >= self.shed_sat}

    def retry_after(self, view):
        """Saturation-derived Retry-After for a fleet-wide shed: the
        minimum over engines of each one's own recovery horizon
        (``/readyz`` retry_after_s when it published one, else the
        single-engine overload ramp ``1 + 4 * saturation``)."""
        hints = []
        for e in view.engines:
            if e.get("retry_after_s") is not None:
                hints.append(float(e["retry_after_s"]))
            else:
                sat = min(1.0, float(e.get("saturation") or 0.0))
                hints.append(1.0 + 4.0 * sat)
        return max(1, int(round(min(hints)))) if hints else 1

    # -- placement ----------------------------------------------------

    def inflight_begin(self, url):
        """Count a request the proxy just aimed at ``url`` — the
        between-polls load signal (see :meth:`_pick`)."""
        with self._lock:
            self._inflight[url] = self._inflight.get(url, 0) + 1

    def inflight_end(self, url):
        with self._lock:
            n = self._inflight.get(url, 0) - 1
            if n > 0:
                self._inflight[url] = n
            else:
                self._inflight.pop(url, None)

    def _pick(self, view, exclude):
        """``pick_least_loaded`` refined by the router's OWN
        in-flight counts. The fleet view's saturation/queue_depth
        are STALE between polls (an engine's published saturation is
        a step-boundary snapshot — it parks at its last value when
        the engine goes idle), so ranking on exact saturation first
        would steer a whole burst away from a recently-busy-but-idle
        engine, or — when every candidate ties — pile it onto one
        URL. The live signal the router does own is what it already
        sent: rank by (hot-or-not at the shed threshold, view queue
        depth + router in-flight count, exact saturation, URL).
        Saturation still breaks ties and the hot band still loses to
        the cold one, but a poll-stale decimal never outranks live
        placement counts."""
        exclude = set(exclude)
        steerable = set(view.steer_set()) - exclude
        candidates = [e for e in view.engines
                      if e["url"] in steerable]
        if not candidates:
            return None
        with self._lock:
            inflight = dict(self._inflight)

        def key(e):
            sat, depth, url = FleetView.load_key(e)
            return (sat >= self.shed_sat,
                    depth + inflight.get(url, 0), sat, url)

        return min(candidates, key=key)["url"]

    def _spill_target(self, view, hot, mapped):
        """Bounded-load affinity (the consistent-hashing-with-
        bounded-loads move): a prefix stays pinned only while its
        engine's live load — view queue depth plus the router's own
        in-flight count — is within ``spill_bound`` requests of the
        least-loaded alternative. Past the bound THIS request spills
        to that alternative and the map stays put: the load
        imbalance is transient, the blocks are not, so the next
        request re-tries the pin instead of flapping the prefix
        between engines. ``spill_bound`` 0 disables."""
        if self.spill_bound <= 0:
            return None
        best = self._pick(view, hot | {mapped})
        if best is None:
            return None
        with self._lock:
            inflight = dict(self._inflight)
        depths = {e["url"]: (e.get("queue_depth") or 0)
                  for e in view.engines}

        def load(url):
            return depths.get(url, 0) + inflight.get(url, 0)

        if load(mapped) > load(best) + self.spill_bound:
            return best
        return None

    def route(self, prompt_tokens, cost_tokens, tenant=None,
              record_shed=True):
        """One placement decision. Returns
        ``{"action": "route", "url", "reason", "key"}`` or
        ``{"action": "shed", "status", "reason", "retry_after"}``.
        Fairness sheds first (cheapest check), then fleet health,
        then the affinity map. ``record_shed=False`` returns the shed
        decision WITHOUT counting it — the proxy's bounded
        fairness/backoff waits probe repeatedly and must count one
        shed per request, not one per probe."""
        admitted, wait = self.tenants.admit(tenant, cost_tokens)
        if not admitted:
            return self._shed_decision(429, SHED_TENANT_RATE, wait,
                                       tenant=tenant,
                                       record=record_shed)
        view = self.view()
        steer = set(view.steer_set())
        if not steer:
            return self._shed_decision(503, SHED_NO_ENGINES,
                                       self.retry_after(view),
                                       record=record_shed)
        hot = self.hot_set(view)
        if hot >= steer:
            return self._shed_decision(503, SHED_SATURATED,
                                       self.retry_after(view),
                                       record=record_shed)
        key = affinity_key(prompt_tokens, self.block_size,
                           self.affinity_blocks)
        if key is None:
            url = self._pick(view, hot)
            return self._routed_decision(url, REASON_LEAST_LOADED,
                                         None)
        with self._lock:
            mapped = self._affinity.get(key)
            self._aff_lookups += 1
        if mapped is not None and mapped in steer \
                and mapped not in hot:
            spill = self._spill_target(view, hot, mapped)
            if spill is not None:
                self._publish_hit_rate()
                return self._routed_decision(spill, REASON_SPILL,
                                             key)
            with self._lock:
                self._aff_hits += 1
                self._affinity.move_to_end(key)
            self._publish_hit_rate()
            return self._routed_decision(mapped, REASON_AFFINITY, key)
        if mapped is None:
            # First sighting of this prefix: least-loaded seeds the
            # map — the blocks will live where this request lands.
            url = self._pick(view, hot)
            reason = REASON_LEAST_LOADED
        else:
            # The affinity engine is hot or gone: hedge to the
            # least-loaded OTHER engine and re-point the map — after
            # this request, the blocks live there.
            url = self._pick(view, hot | {mapped})
            if url is None:
                url = self._pick(view, hot)
            reason = REASON_HEDGE
        self._remember(key, url)
        self._publish_hit_rate()
        return self._routed_decision(url, reason, key)

    def sibling(self, exclude):
        """Failover target: the least-loaded steerable engine outside
        ``exclude`` (preferring cold engines, falling back to hot
        ones — a hot sibling beats a dropped stream)."""
        view = self.view()
        url = self._pick(view,
                         set(exclude) | self.hot_set(view))
        if url is None:
            url = self._pick(view, set(exclude))
        return url

    def repoint(self, key, url):
        """After a failover the prefix blocks are rebuilt on the
        sibling — keep the map honest."""
        if key is not None and url is not None:
            self._remember(key, url)

    def note_failover(self, kind, engine=None):
        with self._lock:
            self._failover += 1
        obs.counter(ROUTER_FAILOVER, kind=kind)
        if engine:
            self._note_episode(ENGINE_FAILOVER_EVENT, engine,
                               engine=engine, kind=kind)

    def note_shed(self, reason, tenant=None):
        with self._lock:
            self._shed[reason] = self._shed.get(reason, 0) + 1
        obs.counter(ROUTER_SHED, reason=reason)
        if reason == SHED_TENANT_RATE:
            self._note_episode(TENANT_SHED_EVENT,
                               tenant or DEFAULT_TENANT,
                               tenant=tenant or DEFAULT_TENANT,
                               reason=reason)

    def _note_episode(self, event, key, **fields):
        """One journal event per (event, key) episode, with
        hysteresis: occurrences within ``episode_clear_s`` of the
        last extend the open episode silently; a quiet gap closes it
        so the next occurrence journals a fresh episode."""
        now = self._clock()
        with self._lock:
            last = self._episodes.get((event, key))
            self._episodes[(event, key)] = now
        if last is None or now - last >= self.episode_clear_s:
            obs.event(event, **fields)

    # -- internals ----------------------------------------------------

    def _remember(self, key, url):
        if url is None:
            return
        with self._lock:
            self._affinity[key] = url
            self._affinity.move_to_end(key)
            while len(self._affinity) > self.affinity_cap:
                self._affinity.popitem(last=False)

    def _publish_hit_rate(self):
        with self._lock:
            lookups, hits = self._aff_lookups, self._aff_hits
        if lookups:
            obs.gauge(ROUTER_AFFINITY_HIT_RATE,
                      round(hits / lookups, 4))

    def _routed_decision(self, url, reason, key):
        if url is None:
            # Raced from steerable to empty between checks.
            return self._shed_decision(503, SHED_NO_ENGINES, 1)
        with self._lock:
            self._routed[reason] = self._routed.get(reason, 0) + 1
        obs.counter(ROUTER_ROUTED, reason=reason)
        return {"action": "route", "url": url, "reason": reason,
                "key": key}

    def _shed_decision(self, status, reason, retry_after,
                       tenant=None, record=True):
        if record:
            self.note_shed(reason, tenant=tenant)
        return {"action": "shed", "status": status, "reason": reason,
                "retry_after": int(retry_after)}

    def affinity_snapshot(self):
        with self._lock:
            return {k.hex(): u for k, u in self._affinity.items()}

    def stats(self):
        with self._lock:
            lookups, hits = self._aff_lookups, self._aff_hits
            out = {
                "routed": dict(self._routed),
                "shed": dict(self._shed),
                "failover": self._failover,
                "affinity": {
                    "entries": len(self._affinity),
                    "lookups": lookups,
                    "hits": hits,
                    "hit_rate": (round(hits / lookups, 4)
                                 if lookups else None),
                    "block_size": self.block_size,
                    "max_blocks": self.affinity_blocks,
                },
            }
        out["tenants"] = {
            "rate_tokens_per_s": self.tenants.rate,
            "burst_s": self.tenants.burst_s,
            "ledger": self.tenants.snapshot(),
        }
        return out


class RouterLedger:
    """The router-side request ledger: one retired journey record per
    proxied request, the engine ledger's sum-to-wall discipline
    applied to the front door's own wall (receipt -> final byte) over
    :data:`~..obs.reqledger.ROUTER_BUCKETS`.

    Wraps a :class:`~..obs.reqledger.RequestLedger` (ring +
    ``tpu_router_latency_attribution_seconds{bucket}`` histograms)
    and adds the router-only planes: end-to-end/TTFB histograms,
    per-tenant rollups, and router-measured SLO burn
    (``tpu_router_slo_violations_total{slo,tenant}``; thresholds
    ``CEA_TPU_ROUTER_SLO_TTFB_MS`` / ``CEA_TPU_ROUTER_SLO_E2E_MS``,
    0 disarms). Torch-free like everything else on this path."""

    def __init__(self, capacity=None, tracer=None,
                 slo_ttfb_ms=None, slo_e2e_ms=None):
        self._tracer = tracer or obs.get_tracer()
        self._ledger = obs.RequestLedger(
            capacity=capacity, tracer=self._tracer,
            bucket_names=obs.ROUTER_BUCKETS,
            metric=ROUTER_LATENCY_ATTRIBUTION)
        self.slo_ttfb_ms = float(
            env_number(SLO_TTFB_ENV, 0.0)
            if slo_ttfb_ms is None else slo_ttfb_ms)
        self.slo_e2e_ms = float(
            env_number(SLO_E2E_ENV, 0.0)
            if slo_e2e_ms is None else slo_e2e_ms)
        self._e2e = self._tracer.histogram(
            ROUTER_E2E_LATENCY,
            "Router receipt to final byte, per request")
        self._ttfb = self._tracer.histogram(
            ROUTER_UPSTREAM_TTFB,
            "Router placement to first upstream body line")
        self._lock = threading.Lock()
        # tenant -> {"requests", "wall_s", "violations": {slo: n}}
        self._tenants = {}

    def timeline(self):
        return obs.RequestTimeline(bucket_names=obs.ROUTER_BUCKETS)

    def retire(self, timeline, outcome, *, tenant, request_id,
               trace_id, engine, reason, hops, tokens, stream,
               prompt_len=None):
        """Close one journey and record it. ``trace_id`` is the
        router.request span's trace id (hex string or None when
        tracing is off) — the join key the trace gate and the
        router-tax report stitch router and engine records with."""
        record = timeline.finish(outcome, tokens=tokens,
                                 stream=stream, prompt_len=prompt_len)
        tenant = tenant or DEFAULT_TENANT
        record.update(request_id=request_id, tenant=tenant,
                      trace_id=trace_id, engine=engine,
                      reason=reason, hops=int(hops))
        self._e2e.observe(record["wall_s"])
        if record["ttft_s"] is not None:
            self._ttfb.observe(record["ttft_s"])
        burned = []
        if (self.slo_ttfb_ms > 0 and record["ttft_s"] is not None
                and record["ttft_s"] * 1e3 > self.slo_ttfb_ms):
            burned.append("ttfb")
        if self.slo_e2e_ms > 0 \
                and record["wall_s"] * 1e3 > self.slo_e2e_ms:
            burned.append("e2e")
        for slo in burned:
            self._tracer.counter(ROUTER_SLO_VIOLATIONS, slo=slo,
                                 tenant=tenant)
        with self._lock:
            roll = self._tenants.setdefault(
                tenant, {"requests": 0, "wall_s": 0.0,
                         "violations": {}})
            roll["requests"] += 1
            roll["wall_s"] = round(
                roll["wall_s"] + record["wall_s"], 6)
            for slo in burned:
                roll["violations"][slo] = \
                    roll["violations"].get(slo, 0) + 1
        self._ledger.add(record)
        return record

    def tenant_burn(self):
        """Per-tenant rollup: request count, total wall, SLO burns."""
        with self._lock:
            return {t: {"requests": r["requests"],
                        "wall_s": r["wall_s"],
                        "violations": dict(r["violations"])}
                    for t, r in self._tenants.items()}

    def debug_payload(self, limit=None):
        """The router ``/debug/requests`` body — same shape as the
        engine's (capacity / retired_total / latency_attribution /
        records) plus the per-tenant burn rollup."""
        return {
            "capacity": self._ledger.capacity,
            "retired_total": self._ledger.retired_total(),
            "latency_attribution":
                self._ledger.attribution_stats(),
            "tenants": self.tenant_burn(),
            "records": self._ledger.records(limit),
        }

    def summary(self):
        """The compact rollup ``/fleet/stats`` and ``/stats`` embed."""
        return {
            "retired_total": self._ledger.retired_total(),
            "latency_attribution":
                self._ledger.attribution_stats(),
            "tenants": self.tenant_burn(),
            "slo_ttfb_ms": self.slo_ttfb_ms or None,
            "slo_e2e_ms": self.slo_e2e_ms or None,
        }


class _ClientGone(Exception):
    """The DOWNSTREAM client dropped mid-stream — nothing to splice
    for; must not be mistaken for an engine failure."""


class _RetryableUpstream(Exception):
    """The engine died or asked for a replay — failover material."""

    def __init__(self, detail, envelope=None):
        super().__init__(detail)
        self.envelope = envelope   # parsed error line, if any


class _FatalUpstream(Exception):
    """A non-retryable engine error envelope — relay, don't retry."""

    def __init__(self, envelope):
        super().__init__(envelope.get("error", "upstream error"))
        self.envelope = envelope


class RouterServer:
    """The HTTP face of :class:`RouterCore`: accepts the engines' own
    ``POST /v1/models/<name>:generate`` wire contract and proxies it,
    with sheds answered at the door and failed streams resumed on a
    sibling. Read surfaces: ``/healthz``, ``/readyz`` (503 +
    Retry-After while the fleet is unroutable), ``/stats``,
    ``/metrics``, ``/fleet/stats``, ``/debug/requests`` (the journey
    ledger), and the obs debug pages."""

    def __init__(self, core, collector, port=0, timeout_s=150.0,
                 ledger=None, fairness_wait_ms=None,
                 shed_backoff_ms=None):
        self._core = core
        self._collector = collector
        self._timeout_s = float(timeout_s)
        self._ledger = ledger if ledger is not None else RouterLedger()
        # Bounded waits (both default 0 = shed immediately, the
        # pre-journey behavior): how long a request may park on a
        # tenant-deficit 429 / an unroutable-fleet 503 before the
        # shed goes out. Time parked lands in the fairness_wait /
        # shed_backoff journey buckets.
        self._fairness_wait_ms = float(
            env_number(FAIRNESS_WAIT_ENV, 0.0)
            if fairness_wait_ms is None else fairness_wait_ms)
        self._shed_backoff_ms = float(
            env_number(SHED_BACKOFF_ENV, 0.0)
            if shed_backoff_ms is None else shed_backoff_ms)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _send(self, status, body, headers=None):
                payload = obs.dump_json(body)
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                try:
                    self.wfile.write(payload)
                except OSError:
                    pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                debug = obs.debug_response(obs.get_tracer(), path,
                                           query)
                if debug is not None:
                    ctype, body = debug
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/metrics":
                    body = obs.prometheus_text(
                        obs.get_tracer()).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/healthz":
                    self._send(200, {
                        "status": "ok",
                        "engines": list(outer._collector.urls)})
                elif path == "/readyz":
                    outer._readyz(self)
                elif path == "/stats":
                    self._send(200, dict(
                        outer._core.stats(),
                        requests=outer._ledger.summary()))
                elif path == "/fleet/stats":
                    view = outer._core.view()
                    self._send(200, dict(
                        view.to_dict(),
                        router=outer._ledger.summary()))
                elif path == "/debug/requests":
                    params = urllib.parse.parse_qs(query)
                    limit = None
                    if params.get("limit"):
                        try:
                            limit = int(params["limit"][0])
                        except ValueError:
                            limit = None
                    self._send(200,
                               outer._ledger.debug_payload(limit))
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    length = int(self.headers.get(
                        "Content-Length", "0"))
                    payload = json.loads(self.rfile.read(length))
                except (ValueError, TypeError) as e:
                    self._send(400,
                               {"error": f"bad request: {e}"})
                    return
                outer._proxy(self, payload)

        self._httpd = ThreadingHTTPServer(("", port), Handler)
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="router-http",
            daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread = None
        self._httpd.server_close()

    # -- readiness ----------------------------------------------------

    def _readyz(self, handler):
        view = self._core.view()
        steer = set(view.steer_set())
        hot = self._core.hot_set(view)
        if steer and not hot >= steer:
            handler._send(200, {"status": "ok",
                                "steerable": len(steer - hot)})
            return
        retry = self._core.retry_after(view)
        handler._send(
            503,
            {"state": (SHED_SATURATED if steer else SHED_NO_ENGINES),
             "retry_after_s": retry,
             "saturation_cause": None},
            headers={"Retry-After": str(retry)})

    # -- the proxy path ----------------------------------------------

    def _proxy(self, handler, payload):
        parent_ctx, rid = obs.extract_headers(handler.headers)
        rid = rid or uuid.uuid4().hex[:12]
        tenant = payload.pop("tenant", None) \
            or handler.headers.get("X-Tenant")
        if "text" in payload:
            handler._send(400, {
                "error": "the router routes token-id prompts only; "
                         "text needs the model's tokenizer "
                         "(send prompts)", "request_id": rid})
            return
        prompts = payload.get("prompts")
        if (not isinstance(prompts, list) or not prompts
                or not all(isinstance(p, list) for p in prompts)):
            handler._send(400, {
                "error": "prompts must be a non-empty list of "
                         "token-id lists", "request_id": rid})
            return
        # ONE trace per journey: the router.request root span adopts
        # any inbound carrier as parent, and its context + request id
        # ride every upstream call — including the splice resubmit —
        # so the whole router->engine(s) path shares a trace id.
        timeline = self._ledger.timeline()
        with obs.span("router.request", parent=parent_ctx,
                      path=handler.path, request_id=rid,
                      tenant=tenant or DEFAULT_TENANT) as sp:
            ctx = sp.context() if sp else None
            trace_id = ("%x" % ctx[0]) if ctx else None
            self._proxy_journey(handler, payload, prompts, tenant,
                                rid, ctx, trace_id, timeline)

    def _proxy_journey(self, handler, payload, prompts, tenant, rid,
                       ctx, trace_id, timeline):
        max_new = int(payload.get("max_new_tokens", 0) or 0)
        cost = sum(len(p) for p in prompts) + max_new * len(prompts)
        decision = self._route_with_waits(prompts[0], cost, tenant,
                                          timeline)
        if decision["action"] == "shed":
            handler._send(
                decision["status"],
                {"error": f"router shed: {decision['reason']}",
                 "retry_after_s": decision["retry_after"],
                 "request_id": rid},
                headers={"Retry-After":
                         str(decision["retry_after"])})
            self._ledger.retire(
                timeline, "shed_" + decision["reason"],
                tenant=tenant, request_id=rid, trace_id=trace_id,
                engine=None, reason=decision["reason"], hops=0,
                tokens=0, stream=bool(payload.get("stream")),
                prompt_len=len(prompts[0]))
            return
        carrier = obs.inject_headers(ctx, request_id=rid)
        if payload.get("stream"):
            self._proxy_stream(handler, payload, decision, rid,
                               timeline, carrier, tenant, trace_id)
        else:
            self._proxy_unary(handler, payload, decision, rid,
                              timeline, carrier, tenant, trace_id)

    def _route_with_waits(self, prompt, cost, tenant, timeline):
        """One routing decision plus the bounded parking budgets: a
        would-be shed re-probes inside its budget (fairness_wait for
        tenant-rate 429s, shed_backoff for fleet 503s, both default
        0 = shed immediately) before the shed actually goes out.
        Probes never count sheds — the final decision counts exactly
        once, so a parked-then-admitted request sheds nothing."""
        decision = self._core.route(prompt, cost, tenant,
                                    record_shed=False)
        timeline.lap("router_queue")
        if decision["action"] == "shed":
            parked_429 = decision["status"] == 429
            budget_s = (self._fairness_wait_ms if parked_429
                        else self._shed_backoff_ms) / 1e3
            if budget_s > 0:
                deadline = time.monotonic() + budget_s
                while decision["action"] == "shed" \
                        and time.monotonic() < deadline:
                    time.sleep(min(0.05, max(
                        0.001, deadline - time.monotonic())))
                    decision = self._core.route(
                        prompt, cost, tenant, record_shed=False)
                timeline.lap("fairness_wait" if parked_429
                             else "shed_backoff")
        if decision["action"] == "shed":
            self._core.note_shed(decision["reason"], tenant=tenant)
        return decision

    def _post_upstream(self, url, path, payload, headers=None):
        """One upstream POST; returns the HTTPResponse (caller owns
        the connection via resp) — connection errors raise OSError.
        ``headers`` adds the trace carrier on top of Content-Type."""
        parsed = urllib.parse.urlsplit(url)
        conn = http.client.HTTPConnection(
            parsed.hostname, parsed.port, timeout=self._timeout_s)
        body = json.dumps(payload).encode()
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        conn.request("POST", path, body=body, headers=hdrs)
        resp = conn.getresponse()
        resp._router_conn = conn   # keep the connection alive/owned
        return resp

    def _proxy_unary(self, handler, payload, decision, rid,
                     timeline, carrier, tenant, trace_id):
        tried = set()
        url, key = decision["url"], decision["key"]
        attempts_left = self._core.failover_max
        hops = 0
        prompt_len = len(payload["prompts"][0])

        def retire(outcome, tokens=0):
            self._ledger.retire(
                timeline, outcome, tenant=tenant, request_id=rid,
                trace_id=trace_id, engine=url,
                reason=decision["reason"], hops=hops,
                tokens=tokens, stream=False, prompt_len=prompt_len)

        while True:
            self._core.inflight_begin(url)
            try:
                resp = self._post_upstream(url, handler.path,
                                           payload, headers=carrier)
                status = resp.status
                body = resp.read()
                resp._router_conn.close()
                if status == 503 and attempts_left > 0:
                    raise _RetryableUpstream(f"engine 503 from {url}")
            except (OSError, http.client.HTTPException,
                    _RetryableUpstream) as e:
                self._core.inflight_end(url)
                tried.add(url)
                sib = (self._core.sibling(tried)
                       if attempts_left > 0 else None)
                if sib is None:
                    self._core.note_shed(SHED_FAILOVER_EXHAUSTED,
                                         tenant=tenant)
                    handler._send(
                        503,
                        {"error": f"no sibling after failure: {e}",
                         "retry_after_s": 1, "request_id": rid},
                        headers={"Retry-After": "1"})
                    timeline.lap("upstream_ttfb" if hops == 0
                                 else "splice_resubmit")
                    retire("failover_exhausted")
                    return
                attempts_left -= 1
                self._core.note_failover("request", engine=url)
                self._core.repoint(key, sib)
                url = sib
                hops += 1
                continue
            self._core.inflight_end(url)
            # The whole accepted attempt — headers through body —
            # bills as time-to-first-byte (there is no stream side
            # to a unary reply); a failed first attempt's time rides
            # into the sibling's splice_resubmit lap.
            timeline.note_first_token()
            timeline.lap("upstream_ttfb" if hops == 0
                         else "splice_resubmit")
            headers = {}
            # Engine sheds carry their own saturation-derived hint;
            # relay it untouched.
            retry = resp.getheader("Retry-After")
            if retry:
                headers["Retry-After"] = retry
            self._raw_reply(handler, status, body, headers)
            timeline.lap("stream")
            tokens = 0
            if status == 200:
                try:
                    reply = json.loads(body)
                    tokens = sum(
                        len(t) for t in reply.get("tokens", [])
                        if isinstance(t, list))
                except (ValueError, AttributeError):
                    tokens = 0
            retire("completed" if status == 200
                   else f"upstream_{status}", tokens=tokens)
            return

    def _raw_reply(self, handler, status, body, headers):
        handler.send_response(status)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        for k, v in headers.items():
            handler.send_header(k, v)
        handler.end_headers()
        try:
            handler.wfile.write(body)
        except OSError:
            pass

    def _proxy_stream(self, handler, payload, decision, rid,
                      timeline, carrier, tenant, trace_id):
        """Stream with splice-on-failure. The ndjson headers go out
        lazily — before the first upstream line arrives, a total
        failure can still answer with a clean 503. The SAME carrier
        (trace context + request id) rides every hop, splices
        included: the sibling's engine-side span parents under the
        original trace instead of minting a new journey."""
        prompt = list(payload["prompts"][0])
        max_new = int(payload.get("max_new_tokens", 0) or 0)
        url, key = decision["url"], decision["key"]
        tried = set()
        delivered = []       # tokens already written to the client
        headers_sent = [False]
        hops = [0]
        # The hop's pending attribution: time up to a hop's first
        # body line bills to upstream_ttfb (hop 0) or splice_resubmit
        # (a failover sibling); once lines flow, to ``stream``.
        state = {"await": "upstream_ttfb"}

        def lap_pending():
            timeline.lap(state.pop("await", None) or "stream")

        def retire(outcome):
            self._ledger.retire(
                timeline, outcome, tenant=tenant, request_id=rid,
                trace_id=trace_id, engine=url,
                reason=decision["reason"], hops=hops[0],
                tokens=len(delivered), stream=True,
                prompt_len=len(prompt))

        def send_line(line):
            try:
                if not headers_sent[0]:
                    handler.send_response(200)
                    handler.send_header("Content-Type",
                                        "application/x-ndjson")
                    handler.end_headers()
                    headers_sent[0] = True
                handler.wfile.write(
                    (json.dumps(line) + "\n").encode())
                handler.wfile.flush()
            except OSError as e:
                raise _ClientGone(str(e))

        attempts_left = self._core.failover_max
        upstream_payload = dict(payload)
        while True:
            try:
                self._relay_stream(url, handler.path,
                                   upstream_payload, delivered,
                                   send_line, timeline, state,
                                   carrier)
                retire("completed")
                return   # clean {"done": true} reached the client
            except _ClientGone:
                lap_pending()
                retire("client_gone")
                return   # nobody left to splice for
            except _FatalUpstream as e:
                lap_pending()
                envelope = dict(e.envelope, request_id=rid)
                if headers_sent[0]:
                    self._try_line(send_line, envelope)
                else:
                    handler._send(502, envelope)
                retire("error")
                return
            except (OSError, http.client.HTTPException,
                    _RetryableUpstream) as e:
                # Bill the failed hop, then open the splice window:
                # everything until the sibling's first line is
                # splice_resubmit time.
                lap_pending()
                state["await"] = "splice_resubmit"
                tried.add(url)
                sib = (self._core.sibling(tried)
                       if attempts_left > 0 else None)
                remaining = (max_new - len(delivered)
                             if max_new else None)
                if remaining is not None and remaining <= 0:
                    # Everything owed was already delivered before
                    # the engine died — the splice is a bare close.
                    self._try_line(send_line, {"done": True})
                    lap_pending()
                    retire("completed")
                    return
                if sib is None:
                    self._core.note_shed(SHED_FAILOVER_EXHAUSTED,
                                         tenant=tenant)
                    envelope = {"error": f"stream failover "
                                         f"exhausted: {e}",
                                "retryable": True,
                                "request_id": rid}
                    if headers_sent[0]:
                        self._try_line(send_line, envelope)
                    else:
                        handler._send(
                            503, envelope,
                            headers={"Retry-After": "1"})
                    lap_pending()
                    retire("failover_exhausted")
                    return
                attempts_left -= 1
                self._core.note_failover("stream", engine=url)
                self._core.repoint(key, sib)
                hops[0] += 1
                log.info("stream %s: splicing onto %s after %d "
                         "delivered tokens (%s)", rid, sib,
                         len(delivered), e)
                # The cross-process replay contract: prompt + every
                # delivered token becomes the sibling's prompt (a
                # forced prefix — greedy decode continues token-
                # identically), and the budget shrinks by what the
                # client already has.
                upstream_payload = dict(
                    payload,
                    prompts=[prompt + [int(t) for t in delivered]],
                    stream=True)
                if max_new:
                    upstream_payload["max_new_tokens"] = \
                        max_new - len(delivered)
                url = sib

    @staticmethod
    def _try_line(send_line, line):
        try:
            send_line(line)
        except (_ClientGone, OSError):
            pass   # client went away mid-splice

    def _relay_stream(self, url, path, payload, delivered,
                      send_line, timeline, state, carrier):
        """Forward one upstream ndjson stream, accounting every
        token line into ``delivered``. Raises _RetryableUpstream on
        anything the replay contract covers (transport death,
        truncation, retryable envelope), _FatalUpstream on an
        engine's non-retryable envelope."""
        self._core.inflight_begin(url)
        try:
            self._relay_stream_inner(url, path, payload, delivered,
                                     send_line, timeline, state,
                                     carrier)
        finally:
            self._core.inflight_end(url)

    def _relay_stream_inner(self, url, path, payload, delivered,
                            send_line, timeline, state, carrier):
        resp = self._post_upstream(url, path, payload,
                                   headers=carrier)
        conn = resp._router_conn
        try:
            if resp.status == 503:
                resp.read()
                raise _RetryableUpstream(f"engine 503 from {url}")
            if resp.status != 200:
                body = resp.read()
                try:
                    envelope = json.loads(body)
                except ValueError:
                    envelope = {"error": body.decode("replace")}
                raise _FatalUpstream(dict(
                    envelope, error=envelope.get(
                        "error", f"engine HTTP {resp.status}")))
            while True:
                raw = resp.readline()
                if not raw:
                    raise _RetryableUpstream(
                        f"stream from {url} ended without done")
                raw = raw.strip()
                if not raw:
                    continue
                # First body line of the hop closes its ttfb/splice
                # window; relaying time is ``stream`` from here on.
                if state.get("await"):
                    timeline.lap(state.pop("await"))
                try:
                    line = json.loads(raw)
                except ValueError:
                    raise _RetryableUpstream(
                        f"undecodable stream line from {url}")
                if "tokens" in line:
                    delivered.extend(line["tokens"])
                    timeline.note_first_token()
                    send_line(line)
                elif line.get("done"):
                    send_line(line)
                    timeline.lap("stream")
                    return
                elif "error" in line:
                    if line.get("retryable"):
                        raise _RetryableUpstream(
                            f"retryable envelope from {url}: "
                            f"{line.get('error')}", envelope=line)
                    raise _FatalUpstream(line)
                else:   # unknown line type: pass through untouched
                    send_line(line)
        finally:
            conn.close()

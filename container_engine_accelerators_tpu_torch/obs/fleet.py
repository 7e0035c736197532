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

"""Fleet collector: N engines' endpoints folded into one FleetView.

The port's own copy of the JAX package's ``obs/fleet.py``: the same
poll loop over each engine's surfaces (``/stats``, ``/metrics``,
``/readyz``, ``/debug/requests``), so it watches PyTorch and JAX
engines alike. It maintains

  - per-engine **liveness** with hysteresis: an engine flips DOWN
    after ``CEA_TPU_FLEET_DOWN_POLLS`` consecutive failed polls (or a
    stale snapshot, ``CEA_TPU_FLEET_STALE_MS``) and emits exactly ONE
    ``fleet.engine_down`` journal event per episode; recovery takes a
    clean poll and emits ``fleet.engine_recovered``, so a flapping
    engine cannot flood the journal;
  - **exact fleet TTFT/TPOT distributions**: each engine's
    fixed-bucket serving histograms are parsed back out of its
    Prometheus ``/metrics`` text (de-cumulating the ``_bucket{le=}``
    lines) and bucket-wise merged (``Histogram.merge``): quantiles
    of the merged histogram equal quantiles over the pooled
    observations, which averaging per-engine percentiles never does;
  - cause-wise **fleet saturation** (max and mean over engines, per
    cause) published as ``tpu_fleet_saturation{cause=,agg=}``;
  - multi-window **SLO burn rates**: over a fast and a slow sliding
    window, burn = (Δviolations / Δrequests) / budget from the
    fleet-summed SLO-violation counters; crossing the threshold emits
    one ``fleet.slo_burn`` event per (slo, window) episode (hysteresis
    at half the threshold);
  - the **routing contract**: ``steer_set()`` excludes engines that
    are DOWN, failed their latest poll, read ``/readyz`` 503
    (draining / quarantined / breaker_open: the structured 503 body
    names the state), or sit inside a Retry-After horizon;
    ``pick_least_loaded()`` picks the eligible engine with the least
    saturation;
  - an HPA-shaped scale signal: ``desired_replicas = max(1,
    ceil(engines_up * sat_ewma / target))`` over an EWMA of mean
    fleet saturation (``deploy/fleet/hpa.yaml`` scales on it).

Stdlib only at import, torch-free: the observer and the router
(``serving/fleet_observer.py``, ``serving/serve_fleet.py``) never load
torch to watch a fleet.
"""

import json
import math
import re
import threading
import time
import urllib.error
import urllib.request
from collections import deque

from ..utils import env_number
from .metric_names import (
    FLEET_DESIRED_REPLICAS,
    FLEET_ENGINES,
    FLEET_POLL_ERRORS,
    FLEET_POLLS,
    FLEET_SATURATION,
    FLEET_SLO_BURN,
    FLEET_TPOT,
    FLEET_TTFT,
    SERVING_TPOT,
    SERVING_TTFT,
)
from .trace import Histogram, get_tracer

DOWN_EVENT = "fleet.engine_down"
RECOVERED_EVENT = "fleet.engine_recovered"
BURN_EVENT = "fleet.slo_burn"

POLL_MS_ENV = "CEA_TPU_FLEET_POLL_MS"
DEFAULT_POLL_MS = 1000.0
# Snapshot age past which an engine counts as failing even without a
# fetch error on THIS cycle (a wedged poll loop must not keep stale
# engines routable). Default: 3 poll intervals.
STALE_MS_ENV = "CEA_TPU_FLEET_STALE_MS"
# Consecutive failed polls before the DOWN episode opens. 1 = flip on
# the first refusal; the default 2 rides out a single transient blip.
DOWN_POLLS_ENV = "CEA_TPU_FLEET_DOWN_POLLS"
DEFAULT_DOWN_POLLS = 2
BURN_FAST_ENV = "CEA_TPU_FLEET_BURN_FAST_S"
DEFAULT_BURN_FAST_S = 60.0
BURN_SLOW_ENV = "CEA_TPU_FLEET_BURN_SLOW_S"
DEFAULT_BURN_SLOW_S = 600.0
# Burn multiple of the budget that opens a fleet.slo_burn episode
# (re-arms at half). 10x on a 1% budget means 10% of requests are
# burning SLO — the classic fast-window page point.
BURN_THRESHOLD_ENV = "CEA_TPU_FLEET_BURN_THRESHOLD"
DEFAULT_BURN_THRESHOLD = 10.0
# Error budget: the fraction of requests ALLOWED to violate the SLO.
SLO_BUDGET_ENV = "CEA_TPU_FLEET_SLO_BUDGET"
DEFAULT_SLO_BUDGET = 0.01
# HPA pair: saturation setpoint + EWMA smoothing weight per poll.
SAT_TARGET_ENV = "CEA_TPU_FLEET_SAT_TARGET"
DEFAULT_SAT_TARGET = 0.6
SAT_ALPHA_ENV = "CEA_TPU_FLEET_SAT_ALPHA"
DEFAULT_SAT_ALPHA = 0.4

# GETs per engine per cycle, the collector's overhead: /stats,
# /metrics, /readyz, /debug/requests. Growing this grows every
# engine's handler load.
FETCHES_PER_ENGINE = 4

SLO_KINDS = ("ttft", "tpot")
_SAMPLE_CAP = 4096


def _http_fetch(url, timeout=3.0):
    """(status, headers, body) — HTTP errors (e.g. the /readyz 503)
    are ANSWERS here, not exceptions; only transport failures raise."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers or {}), e.read()


# -- Prometheus exposition parsing (inverse of export.prometheus_text)

_LABELS_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def _unescape(value):
    return re.sub(r"\\(.)",
                  lambda m: "\n" if m.group(1) == "n" else m.group(1),
                  value)


def _parse_sample(line):
    """One exposition line -> (name, labels, value) or None."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    brace = line.find("{")
    if brace >= 0:
        end = line.rfind("}")
        if end < brace:
            return None
        name = line[:brace]
        labels = {m.group(1): _unescape(m.group(2))
                  for m in _LABELS_RE.finditer(line[brace + 1:end])}
        value = line[end + 1:].strip()
    else:
        name, _, value = line.partition(" ")
        labels = {}
    if not name or not value:
        return None
    return name, labels, value


def histograms_from_text(text, names=None):
    """Reconstruct :class:`Histogram` objects from a Prometheus
    exposition body — the inverse of ``export.prometheus_text``.

    Cumulative ``_bucket{le=}`` counts are de-cumulated back into
    per-bucket counts (``+Inf`` becomes the overflow bucket), ``_sum``
    and ``_count`` ride along, and the result merges exactly with any
    histogram on the same grid. ``names`` restricts to those metric
    families. Returns ``{(name, labels_tuple): Histogram}``; malformed
    families (non-monotone buckets) are dropped rather than poisoning
    a fleet merge.
    """
    fams = {}

    def fam(base, labels):
        key = (base, tuple(sorted(labels.items())))
        return fams.setdefault(
            key, {"buckets": {}, "sum": 0.0, "count": None})

    for line in text.splitlines():
        sample = _parse_sample(line)
        if sample is None:
            continue
        name, labels, value = sample
        try:
            if name.endswith("_bucket") and "le" in labels:
                base = name[:-len("_bucket")]
                if names is not None and base not in names:
                    continue
                le = labels.pop("le")
                bound = (math.inf if le == "+Inf"
                         else float(le))
                fam(base, labels)["buckets"][bound] = int(float(value))
            elif name.endswith("_sum"):
                base = name[:-len("_sum")]
                if names is not None and base not in names:
                    continue
                fam(base, labels)["sum"] = float(value)
            elif name.endswith("_count"):
                base = name[:-len("_count")]
                if names is not None and base not in names:
                    continue
                fam(base, labels)["count"] = int(float(value))
        except ValueError:
            continue
    out = {}
    for (base, labelkey), rec in fams.items():
        if not rec["buckets"]:
            continue
        bounds = sorted(b for b in rec["buckets"] if b != math.inf)
        if not bounds:
            # Overflow-only exposition (all mass past the last finite
            # bound but no finite lines) cannot name a grid; skip.
            continue
        counts, prev, bad = [], 0, False
        for b in bounds:
            cum = rec["buckets"][b]
            if cum < prev:
                bad = True
                break
            counts.append(cum - prev)
            prev = cum
        inf_cum = rec["buckets"].get(math.inf, prev)
        if bad or inf_cum < prev:
            continue
        counts.append(inf_cum - prev)
        h = Histogram(base, labels=dict(labelkey), buckets=bounds)
        h.counts = counts
        h.count = rec["count"] if rec["count"] is not None else inf_cum
        h.sum = rec["sum"]
        out[(base, labelkey)] = h
    return out


# -- per-engine state --------------------------------------------------


class EngineSnapshot:
    """One engine's last-known state as the collector saw it; the
    collector mutates it under its lock and FleetView exports a
    plain-dict copy."""

    __slots__ = ("url", "engine_id", "stats", "hists", "requests",
                 "ready", "state", "retry_after_s", "retry_until",
                 "saturation_cause", "last_ok", "failures", "error",
                 "down")

    def __init__(self, url):
        self.url = url
        self.engine_id = None
        self.stats = None
        self.hists = {}          # metric name -> merged Histogram
        self.requests = None     # /debug/requests summary
        self.ready = False
        self.state = "unknown"
        self.retry_after_s = None
        self.retry_until = 0.0   # collector-clock steer-away horizon
        self.saturation_cause = None
        self.last_ok = None
        self.failures = 0        # consecutive failed polls
        self.error = None
        self.down = False

    def saturation(self):
        sat = (self.stats or {}).get("saturation") or {}
        return (float(sat.get("max") or 0.0), sat.get("causes") or {})

    def to_dict(self, now):
        level, causes = self.saturation()
        stats = self.stats or {}
        return {
            "url": self.url,
            "engine_id": self.engine_id or self.url,
            "down": self.down,
            "ready": self.ready,
            "state": self.state,
            "failures": self.failures,
            "error": self.error,
            "age_s": (round(now - self.last_ok, 3)
                      if self.last_ok is not None else None),
            "retry_after_s": self.retry_after_s,
            "saturation": round(level, 4),
            "saturation_causes": {k: round(float(v), 4)
                                  for k, v in causes.items()},
            "saturation_cause": self.saturation_cause,
            "queue_depth": stats.get("queue_depth"),
            "requests_retired": stats.get("requests_retired"),
            "slo_violations": ((stats.get("slo") or {})
                               .get("violations")),
            "ttft_p99_ms": stats.get("ttft_p99_ms"),
            "tpot_p99_ms": stats.get("tpot_p99_ms"),
            "requests": self.requests,
        }


# -- the rollup object -------------------------------------------------


class FleetView:
    """Immutable rollup of one poll cycle: per-engine snapshots, the
    merged distributions, burn rates, and the routing contract."""

    def __init__(self, engines, ttft, tpot, saturation, burn,
                 desired_replicas, sat_ewma, polls, now):
        self.engines = engines            # list of engine dicts
        self.ttft = ttft                  # merged Histogram
        self.tpot = tpot                  # merged Histogram
        self.saturation = saturation      # {cause: {max, mean}}
        self.burn = burn                  # {slo: {fast, slow}}
        self.desired_replicas = desired_replicas
        self.sat_ewma = sat_ewma
        self.polls = polls
        self.now = now
        self._eligible = [e for e in engines
                          if not e["down"] and e["failures"] == 0
                          and e["ready"] and e["_steerable"]]

    def steer_set(self):
        """Base URLs a router may send NEW work to right now:
        polled clean this cycle, ``/readyz`` 200, outside any
        Retry-After horizon. The router's admission set."""
        return [e["url"] for e in self._eligible]

    @staticmethod
    def load_key(engine):
        """The PINNED total order behind :meth:`pick_least_loaded` —
        saturation, then queue depth (a missing/None depth sorts AS
        zero, tied with an explicit 0), then URL. The URL leg makes
        every tie deterministic: two collectors polling the same
        fleet pick the same engine, and a router replaying a decision
        log reproduces it exactly. Routers reuse this key to rank
        failover siblings the same way the fallback pick does."""
        return (engine["saturation"],
                engine.get("queue_depth") or 0,
                engine["url"])

    def pick_least_loaded(self, exclude=()):
        """The eligible engine minimizing :meth:`load_key` —
        saturation, queue depth (None == 0), then URL, so equal-load
        ties always resolve to the lexicographically smallest URL
        (and with it excluded, the next one — the exclude= chain is
        part of the pinned order). None when the
        whole fleet is unroutable — the caller sheds, exactly like a
        single engine's 503."""
        exclude = set(exclude)
        candidates = [e for e in self._eligible
                      if e["url"] not in exclude]
        if not candidates:
            return None
        return min(candidates, key=self.load_key)["url"]

    def counts(self):
        up = sum(1 for e in self.engines if not e["down"])
        unready = sum(1 for e in self.engines
                      if not e["down"] and not e["ready"])
        return {"up": up, "down": len(self.engines) - up,
                "unready": unready}

    def to_dict(self):
        """The /fleet/stats payload."""
        def q_ms(hist, q):
            v = hist.quantile(q)
            return round(v * 1e3, 3) if v is not None else None

        return {
            "engines": [{k: v for k, v in e.items()
                         if not k.startswith("_")}
                        for e in self.engines],
            "counts": self.counts(),
            "steer_set": self.steer_set(),
            "least_loaded": self.pick_least_loaded(),
            "ttft": {"count": self.ttft.count,
                     "p50_ms": q_ms(self.ttft, 0.5),
                     "p99_ms": q_ms(self.ttft, 0.99)},
            "tpot": {"count": self.tpot.count,
                     "p50_ms": q_ms(self.tpot, 0.5),
                     "p99_ms": q_ms(self.tpot, 0.99)},
            "saturation": self.saturation,
            "slo_burn": self.burn,
            "desired_replicas": self.desired_replicas,
            "saturation_ewma": round(self.sat_ewma, 4),
            "polls": self.polls,
        }


# -- the collector -----------------------------------------------------


class FleetCollector:
    """Polls N engine base URLs and maintains the FleetView.

    ``fetch`` and ``clock`` are injectable for unit tests (a fake
    fleet needs neither sockets nor sleeps); the defaults are real
    HTTP + ``time.monotonic``.
    """

    def __init__(self, urls, poll_ms=None, stale_ms=None,
                 down_after=None, fast_window_s=None,
                 slow_window_s=None, burn_threshold=None,
                 slo_budget=None, sat_target=None, sat_alpha=None,
                 tracer=None, fetch=None, clock=None):
        self.urls = [u.rstrip("/") for u in urls]
        if not self.urls:
            raise ValueError("FleetCollector needs >= 1 engine URL")
        if len(set(self.urls)) != len(self.urls):
            raise ValueError(f"duplicate engine URLs: {self.urls}")
        self.poll_ms = (poll_ms if poll_ms is not None
                        else env_number(POLL_MS_ENV, DEFAULT_POLL_MS))
        self.stale_ms = (stale_ms if stale_ms is not None
                         else env_number(STALE_MS_ENV,
                                         3.0 * self.poll_ms))
        self.down_after = max(1, int(
            down_after if down_after is not None
            else env_number(DOWN_POLLS_ENV, DEFAULT_DOWN_POLLS,
                            parse=int)))
        self.fast_window_s = (
            fast_window_s if fast_window_s is not None
            else env_number(BURN_FAST_ENV, DEFAULT_BURN_FAST_S))
        self.slow_window_s = (
            slow_window_s if slow_window_s is not None
            else env_number(BURN_SLOW_ENV, DEFAULT_BURN_SLOW_S))
        self.burn_threshold = (
            burn_threshold if burn_threshold is not None
            else env_number(BURN_THRESHOLD_ENV,
                            DEFAULT_BURN_THRESHOLD))
        self.slo_budget = max(1e-9, (
            slo_budget if slo_budget is not None
            else env_number(SLO_BUDGET_ENV, DEFAULT_SLO_BUDGET)))
        self.sat_target = max(1e-6, (
            sat_target if sat_target is not None
            else env_number(SAT_TARGET_ENV, DEFAULT_SAT_TARGET)))
        self.sat_alpha = min(1.0, max(0.0, (
            sat_alpha if sat_alpha is not None
            else env_number(SAT_ALPHA_ENV, DEFAULT_SAT_ALPHA))))
        self._tracer = tracer or get_tracer()
        self._fetch = fetch or _http_fetch
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._engines = [EngineSnapshot(u) for u in self.urls]
        self._samples = deque(maxlen=_SAMPLE_CAP)
        self._burning = set()    # (slo, window) open burn episodes
        self._sat_ewma = 0.0
        self._polls = 0
        self._fetches = 0
        self._down_events = 0
        self._recovered_events = 0
        self._burn_events = 0
        self._view = None
        self._stop = threading.Event()
        self._thread = None

    # -- one engine, one cycle ----------------------------------------

    def _poll_engine(self, eng, now):
        base = eng.url
        try:
            self._fetches += 4
            status, _, body = self._fetch(base + "/stats")
            if status != 200:
                raise OSError(f"/stats HTTP {status}")
            stats = json.loads(body)
            status, _, text = self._fetch(base + "/metrics")
            if status != 200:
                raise OSError(f"/metrics HTTP {status}")
            hists = histograms_from_text(
                text.decode("utf-8", "replace"),
                names={SERVING_TTFT, SERVING_TPOT})
            r_status, r_headers, r_body = self._fetch(base + "/readyz")
            d_status, _, d_body = self._fetch(
                base + "/debug/requests?n=8")
        except Exception as e:
            eng.failures += 1
            eng.error = f"{type(e).__name__}: {e}"[:200]
            self._tracer.counter(FLEET_POLL_ERRORS,
                                 engine=eng.engine_id or eng.url)
            return
        eng.failures = 0
        eng.error = None
        eng.last_ok = now
        eng.stats = stats
        eng.engine_id = stats.get("engine_id") or eng.url
        # Collapse the engine's per-model label sets into one
        # histogram per metric name (the fleet merge is model-blind).
        merged = {}
        for (name, _labels), h in sorted(hists.items()):
            acc = merged.get(name)
            if acc is None:
                acc = merged[name] = Histogram(
                    name, h.help, buckets=h.buckets)
            acc.merge(h)
        eng.hists = merged
        eng.ready = r_status == 200
        if eng.ready:
            eng.state = "serving"
            eng.retry_after_s = None
            eng.retry_until = 0.0
            eng.saturation_cause = None
        else:
            try:
                detail = json.loads(r_body)
            except Exception:
                detail = {}
            eng.state = (detail.get("state") or detail.get("status")
                         or "unready")
            retry = detail.get("retry_after_s")
            if retry is None:
                try:
                    retry = float(r_headers.get("Retry-After", 1))
                except (TypeError, ValueError):
                    retry = 1.0
            eng.retry_after_s = float(retry)
            eng.retry_until = now + eng.retry_after_s
            eng.saturation_cause = detail.get("saturation_cause")
        if d_status == 200:
            try:
                payload = json.loads(d_body)
                eng.requests = {
                    "retired_total": payload.get("retired_total"),
                    "records": len(payload.get("records") or ()),
                }
            except Exception:
                eng.requests = None
        else:
            eng.requests = None  # surface absent (non-engine server)

    # -- liveness transitions -----------------------------------------

    def _transition(self, eng, now):
        stale = (eng.last_ok is not None
                 and (now - eng.last_ok) * 1e3 > self.stale_ms)
        is_down = (eng.failures >= self.down_after
                   or (eng.failures > 0 and stale))
        if is_down and not eng.down:
            eng.down = True
            self._down_events += 1
            self._tracer.event(
                DOWN_EVENT, engine=eng.engine_id or eng.url,
                url=eng.url, consecutive_failures=eng.failures,
                stale=stale, error=eng.error)
        elif eng.down and eng.failures == 0:
            # Re-arm only on an actual clean poll: an engine
            # oscillating one failure under the threshold yields one
            # episode, not an event per wobble.
            eng.down = False
            self._recovered_events += 1
            self._tracer.event(
                RECOVERED_EVENT, engine=eng.engine_id or eng.url,
                url=eng.url)

    # -- burn windows --------------------------------------------------

    def _burn_rate(self, now, window_s, slo):
        """(Δviolations / Δrequests) / budget over the trailing
        window. Baseline = the newest sample at or before the window
        start (the whole history when younger than the window —
        honest dilution, not a fabricated burst)."""
        if len(self._samples) < 2:
            return 0.0
        newest = self._samples[-1]
        baseline = self._samples[0]
        for s in self._samples:
            if s[0] <= now - window_s:
                baseline = s
            else:
                break
        dv = newest[1].get(slo, 0) - baseline[1].get(slo, 0)
        dr = newest[2] - baseline[2]
        if dr <= 0 or dv <= 0:
            return 0.0
        return (dv / dr) / self.slo_budget

    def _evaluate_burn(self, now):
        burn = {}
        for slo in SLO_KINDS:
            fast = self._burn_rate(now, self.fast_window_s, slo)
            slow = self._burn_rate(now, self.slow_window_s, slo)
            burn[slo] = {"fast": round(fast, 4),
                         "slow": round(slow, 4)}
            for window, rate in (("fast", fast), ("slow", slow)):
                key = (slo, window)
                if key not in self._burning \
                        and rate >= self.burn_threshold:
                    self._burning.add(key)
                    self._burn_events += 1
                    self._tracer.event(
                        BURN_EVENT, slo=slo, window=window,
                        burn=round(rate, 4),
                        fast_burn=round(fast, 4),
                        slow_burn=round(slow, 4),
                        threshold=self.burn_threshold,
                        budget=self.slo_budget,
                        window_s=(self.fast_window_s
                                  if window == "fast"
                                  else self.slow_window_s))
                elif key in self._burning \
                        and rate <= self.burn_threshold / 2.0:
                    self._burning.discard(key)
        return burn

    # -- the cycle -----------------------------------------------------

    def poll_once(self):
        """One synchronous sweep (FETCHES_PER_ENGINE GETs per
        engine), then the rollup: liveness transitions, the merged
        distributions, burn windows, the scale signal, and gauge
        publication. Returns the new FleetView."""
        now = self._clock()
        with self._lock:
            for eng in self._engines:
                self._poll_engine(eng, now)
            for eng in self._engines:
                self._transition(eng, now)
            up = [e for e in self._engines
                  if not e.down and e.stats is not None]
            # Fleet-summed SLO counters: clamped-at-zero deltas over
            # these drive the burn windows (an engine dying mid-trace
            # shrinks the sums; a negative delta is not a recovery).
            viol = {slo: 0 for slo in SLO_KINDS}
            retired = 0
            for eng in up:
                v = ((eng.stats.get("slo") or {})
                     .get("violations") or {})
                for slo in SLO_KINDS:
                    viol[slo] += int(v.get(slo) or 0)
                retired += int(eng.stats.get("requests_retired")
                               or 0)
            self._samples.append((now, viol, retired))
            burn = self._evaluate_burn(now)
            # Saturation rollup + the HPA EWMA.
            causes = {}
            levels = []
            for eng in up:
                level, eng_causes = eng.saturation()
                levels.append(level)
                for cause, value in dict(eng_causes,
                                         overall=level).items():
                    causes.setdefault(cause, []).append(float(value))
            saturation = {
                cause: {"max": round(max(vals), 4),
                        "mean": round(sum(vals) / len(vals), 4)}
                for cause, vals in causes.items()}
            mean_sat = (sum(levels) / len(levels)) if levels else 0.0
            self._sat_ewma = (self.sat_alpha * mean_sat
                              + (1.0 - self.sat_alpha)
                              * self._sat_ewma)
            desired = max(1, math.ceil(
                max(1, len(up)) * self._sat_ewma / self.sat_target))
            # Exact fleet distributions: merge every UP engine's
            # parsed serving histograms on the shared grid.
            ttft = tpot = None
            for eng in up:
                for src_name, dst_name in (
                        (SERVING_TTFT, FLEET_TTFT),
                        (SERVING_TPOT, FLEET_TPOT)):
                    h = eng.hists.get(src_name)
                    if h is None:
                        continue
                    if src_name == SERVING_TTFT:
                        if ttft is None:
                            ttft = Histogram(dst_name,
                                             buckets=h.buckets)
                        ttft.merge(h)
                    else:
                        if tpot is None:
                            tpot = Histogram(dst_name,
                                             buckets=h.buckets)
                        tpot.merge(h)
            if ttft is None:
                ttft = Histogram(FLEET_TTFT)
            if tpot is None:
                tpot = Histogram(FLEET_TPOT)
            self._polls += 1
            engines = []
            for eng in self._engines:
                d = eng.to_dict(now)
                d["_steerable"] = now >= eng.retry_until
                engines.append(d)
            view = FleetView(engines, ttft, tpot, saturation, burn,
                             desired, self._sat_ewma, self._polls,
                             now)
            self._view = view
        self._publish(view)
        return view

    def _publish(self, view):
        """Gauge/counter/histogram publication onto the collector's
        own tracer — the observer's /metrics surface. The fleet
        histograms are re-exports of monotone upstream counters:
        reset-then-merge keeps the registered objects wired to the
        scrape (the Tracer.reset rule) while tracking the fleet."""
        t = self._tracer
        t.counter(FLEET_POLLS)
        for state, n in view.counts().items():
            t.gauge(FLEET_ENGINES, n, state=state)
        for cause, aggs in view.saturation.items():
            for agg, value in aggs.items():
                t.gauge(FLEET_SATURATION, value, cause=cause,
                        agg=agg)
        for slo, windows in view.burn.items():
            for window, rate in windows.items():
                t.gauge(FLEET_SLO_BURN, rate, slo=slo,
                        window=window)
        t.gauge(FLEET_DESIRED_REPLICAS, view.desired_replicas)
        for name, merged in ((FLEET_TTFT, view.ttft),
                             (FLEET_TPOT, view.tpot)):
            out = t.histogram(
                name, "fleet-merged serving latency distribution",
                buckets=merged.buckets)
            if tuple(out.buckets) == tuple(merged.buckets):
                out.reset()
                out.merge(merged)

    # -- surfaces ------------------------------------------------------

    def view(self):
        """The last completed FleetView (None before the first
        poll)."""
        with self._lock:
            return self._view

    def event_counts(self):
        """(down, recovered, burn) event totals — the check seam."""
        with self._lock:
            return (self._down_events, self._recovered_events,
                    self._burn_events)

    def overhead(self):
        """Deterministic collector-cost accounting: total GETs
        issued, cycles completed, and the per-engine-per-cycle
        fetch count."""
        with self._lock:
            polls = self._polls
            fetches = self._fetches
        per_cycle = (fetches / (polls * len(self.urls))
                     if polls else 0.0)
        return {"polls": polls, "fetches": fetches,
                "engines": len(self.urls),
                "fetches_per_engine_cycle": round(per_cycle, 4)}

    # -- the loop ------------------------------------------------------

    def start(self):
        """Spawn the poll loop at ``poll_ms`` cadence."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-collector", daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                # The collector must outlive any single bad cycle;
                # per-engine errors are already counted per URL.
                self._tracer.counter(FLEET_POLL_ERRORS,
                                     engine="collector")
            self._stop.wait(self.poll_ms / 1e3)

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)

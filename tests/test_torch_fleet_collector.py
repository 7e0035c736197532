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

"""The port's fleet collector (``obs/fleet.py``) and ``Histogram.merge``:
the counterparts of tests/test_fleet.py on the port's modules against a
fake fleet of the port's own (no sockets, no sleeps), then differential
cases against the JAX package on the same inputs: the Prometheus-text
parser, the merge, the registry names, and a seeded sequence of fetched
/stats, /metrics and /readyz payloads under one fake clock that must
give both collectors the same FleetView fields at every poll."""

import json
import math

import numpy as np
import pytest

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.obs import fleet as jax_fleet
from container_engine_accelerators_tpu.obs import (
    metric_names as jax_names,
)
from container_engine_accelerators_tpu.obs import trace as jax_trace
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.obs import fleet
from container_engine_accelerators_tpu_torch.obs import metric_names
from container_engine_accelerators_tpu_torch.obs import reqledger
from container_engine_accelerators_tpu_torch.obs.fleet import (
    BURN_EVENT,
    DOWN_EVENT,
    RECOVERED_EVENT,
    FleetCollector,
    FleetView,
    histograms_from_text,
)
from container_engine_accelerators_tpu_torch.obs.metric_names import (
    SERVING_TPOT,
    SERVING_TTFT,
)
from container_engine_accelerators_tpu_torch.obs.trace import Tracer

# ---------------------------------------------------------------------------
# Histogram.merge
# ---------------------------------------------------------------------------


def test_merge_empty_and_nonempty():
    full = obs.Histogram("a", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.5, 3.0, 9.0):
        full.observe(v)
    empty = obs.Histogram("b", buckets=(1.0, 2.0, 4.0))
    empty.merge(full)
    assert empty.counts == full.counts
    assert empty.count == full.count
    assert empty.sum == full.sum
    assert empty.quantile(0.5) == full.quantile(0.5)
    before = (list(full.counts), full.count, full.sum)
    full.merge(obs.Histogram("c", buckets=(1.0, 2.0, 4.0)))
    assert (list(full.counts), full.count, full.sum) == before


def test_merge_overflow_only_operands():
    a = obs.Histogram("a", buckets=(1.0, 2.0))
    b = obs.Histogram("b", buckets=(1.0, 2.0))
    for v in (5.0, 7.0):
        a.observe(v)
    b.observe(9.0)
    a.merge(b)
    assert a.counts == [0, 0, 3]
    assert a.count == 3
    assert a.quantile(0.99) == 2.0


def test_merge_mismatched_boundaries_names_the_offender():
    a = obs.Histogram("a", buckets=(0.5, 1.0, 2.0))
    b = obs.Histogram("b", buckets=(0.5, 1.5, 2.0))
    with pytest.raises(ValueError) as err:
        a.merge(b)
    msg = str(err.value)
    assert "index 1" in msg and "'b'" in msg and "'a'" in msg
    assert "1.0" in msg and "1.5" in msg
    with pytest.raises(TypeError):
        a.merge({"not": "a histogram"})


def test_merge_then_quantile_equals_pooled_quantile():
    values_a = [0.001 * i for i in range(1, 40)]
    values_b = [0.05 * i for i in range(1, 25)]
    a = obs.Histogram("a")
    b = obs.Histogram("b")
    pooled = obs.Histogram("pooled")
    for v in values_a:
        a.observe(v)
        pooled.observe(v)
    for v in values_b:
        b.observe(v)
        pooled.observe(v)
    a.merge(b)
    assert a.counts == pooled.counts
    for q in (0.1, 0.5, 0.9, 0.99):
        assert a.quantile(q) == pooled.quantile(q)


# ---------------------------------------------------------------------------
# histograms_from_text (the prometheus_text inverse)
# ---------------------------------------------------------------------------


def test_parser_roundtrips_prometheus_text_exactly():
    tracer = Tracer(enabled=True)
    h = tracer.histogram(SERVING_TTFT, "ttft")
    for v in (0.002, 0.015, 0.11, 0.9, 4.2):
        h.observe(v)
    parsed = histograms_from_text(obs.prometheus_text(tracer))
    got = parsed[(SERVING_TTFT, ())]
    assert got.counts == h.counts
    assert got.count == h.count
    assert got.sum == pytest.approx(h.sum)
    for q in (0.5, 0.99):
        assert got.quantile(q) == h.quantile(q)
    acc = obs.Histogram("acc", buckets=h.buckets)
    acc.merge(got)
    assert acc.counts == h.counts


def test_parser_names_filter_and_labels():
    tracer = Tracer(enabled=True)
    tracer.histogram(SERVING_TTFT, "ttft",
                     labels={"model": "lm"}).observe(0.01)
    tracer.histogram(SERVING_TPOT, "tpot").observe(0.002)
    tracer.histogram("other_latency_seconds", "noise").observe(1.0)
    parsed = histograms_from_text(obs.prometheus_text(tracer),
                                  names={SERVING_TTFT, SERVING_TPOT})
    assert set(parsed) == {(SERVING_TTFT, (("model", "lm"),)),
                           (SERVING_TPOT, ())}


MALFORMED_TEXT = "\n".join([
    # Overflow-only family: no finite bound can name a grid.
    'x_seconds_bucket{le="+Inf"} 5',
    'x_seconds_count 5',
    # Non-monotone cumulative counts: poisoned, dropped.
    'y_seconds_bucket{le="1.0"} 7',
    'y_seconds_bucket{le="2.0"} 3',
    'y_seconds_bucket{le="+Inf"} 7',
    # A good family parses despite the bad neighbors.
    'z_seconds_bucket{le="1.0"} 2',
    'z_seconds_bucket{le="+Inf"} 4',
    'z_seconds_sum 3.5',
    'z_seconds_count 4',
])


def test_parser_drops_malformed_families():
    parsed = histograms_from_text(MALFORMED_TEXT)
    assert set(parsed) == {("z_seconds", ())}
    z = parsed[("z_seconds", ())]
    assert z.counts == [2, 2]
    assert z.count == 4 and z.sum == 3.5


# ---------------------------------------------------------------------------
# The collector against a fake fleet
# ---------------------------------------------------------------------------


class FakeFleet:
    """Three fake engines behind an injected fetch/clock pair."""

    def __init__(self, n=3):
        self.now = 1000.0
        self.urls = [f"http://e{i}" for i in range(n)]
        self.engines = {}
        for i, url in enumerate(self.urls):
            self.engines[url] = {
                "alive": True,
                "ready": True,
                "detail": None,       # structured 503 body when set
                "engine_id": f"lm@host{i}:85{i:02d}[{i + 1}]",
                "retired": 0,
                "violations": {"ttft": 0, "tpot": 0},
                "saturation": {"max": 0.0, "causes": {"slots": 0.0}},
                "queue_depth": 0,
                "tracer": Tracer(enabled=True),
            }

    def clock(self):
        return self.now

    def hist(self, url, name=SERVING_TTFT):
        return self.engines[url]["tracer"].histogram(name, "lat")

    def fetch(self, url, timeout=3.0):
        base = next(u for u in self.urls if url.startswith(u + "/"))
        eng = self.engines[base]
        if not eng["alive"]:
            raise OSError("connection refused")
        path = url[len(base):]
        if path == "/stats":
            return 200, {}, json.dumps({
                "engine_id": eng["engine_id"],
                "requests_retired": eng["retired"],
                "queue_depth": eng["queue_depth"],
                "slo": {"violations": dict(eng["violations"])},
                "saturation": eng["saturation"],
            }).encode()
        if path == "/metrics":
            return 200, {}, obs.prometheus_text(
                eng["tracer"]).encode()
        if path == "/readyz":
            if eng["ready"]:
                return 200, {}, b'{"status": "ok"}'
            detail = eng["detail"] or {"state": "draining",
                                       "retry_after_s": 5.0,
                                       "saturation_cause": None}
            return (503,
                    {"Retry-After": str(detail["retry_after_s"])},
                    json.dumps(detail).encode())
        if path.startswith("/debug/requests"):
            return 200, {}, json.dumps(
                {"retired_total": eng["retired"],
                 "records": []}).encode()
        raise AssertionError(f"unexpected fetch {url}")


def collector_kwargs(**kw):
    kw.setdefault("poll_ms", 1000.0)
    kw.setdefault("down_after", 2)
    kw.setdefault("fast_window_s", 60.0)
    kw.setdefault("slow_window_s", 600.0)
    kw.setdefault("burn_threshold", 10.0)
    kw.setdefault("slo_budget", 0.01)
    kw.setdefault("sat_target", 0.5)
    kw.setdefault("sat_alpha", 0.5)
    return kw


def make_collector(fleet, tracer, **kw):
    return FleetCollector(fleet.urls, tracer=tracer, fetch=fleet.fetch,
                          clock=fleet.clock, **collector_kwargs(**kw))


def events(tracer, name):
    return [e["fields"] for e in tracer.snapshot()["events"]
            if e["name"] == name]


def test_collector_rejects_bad_url_sets():
    with pytest.raises(ValueError):
        FleetCollector([])
    with pytest.raises(ValueError):
        FleetCollector(["http://a", "http://a/"])


def test_merged_view_equals_pooled_and_routes_least_loaded():
    fleet = FakeFleet()
    pooled = obs.Histogram("pooled")
    for i, url in enumerate(fleet.urls):
        for k in range(4):
            v = 0.01 * (i + 1) * (k + 1)
            fleet.hist(url).observe(v)
            pooled.observe(v)
        fleet.engines[url]["saturation"] = {
            "max": 0.2 * i, "causes": {"slots": 0.2 * i}}
        fleet.engines[url]["retired"] = 4
    view = make_collector(fleet, Tracer(enabled=True)).poll_once()
    assert view.ttft.counts == pooled.counts
    for q in (0.5, 0.99):
        assert view.ttft.quantile(q) == pooled.quantile(q)
    assert view.steer_set() == fleet.urls
    assert view.pick_least_loaded() == fleet.urls[0]
    assert view.pick_least_loaded(
        exclude=[fleet.urls[0]]) == fleet.urls[1]
    assert view.counts() == {"up": 3, "down": 0, "unready": 0}
    engines = {e["url"]: e for e in view.to_dict()["engines"]}
    assert engines[fleet.urls[0]]["engine_id"] \
        == fleet.engines[fleet.urls[0]]["engine_id"]
    assert not any(k.startswith("_")
                   for e in view.to_dict()["engines"] for k in e)


def test_load_key_tie_chain_is_pinned():
    a = {"url": "http://a", "saturation": 0.1, "queue_depth": None}
    b = {"url": "http://b", "saturation": 0.1, "queue_depth": 0}
    assert FleetView.load_key(a)[:2] == FleetView.load_key(b)[:2]
    assert FleetView.load_key(a) < FleetView.load_key(b)
    fleet = FakeFleet()
    fleet.engines[fleet.urls[1]]["queue_depth"] = None
    view = make_collector(fleet, Tracer(enabled=True)).poll_once()
    assert view.pick_least_loaded() == fleet.urls[0]
    assert view.pick_least_loaded(
        exclude=[fleet.urls[0]]) == fleet.urls[1]
    assert view.pick_least_loaded(
        exclude=fleet.urls[:2]) == fleet.urls[2]
    assert view.pick_least_loaded(exclude=fleet.urls) is None


def test_unready_engine_steered_around_without_down_event():
    fleet = FakeFleet()
    draining = fleet.urls[1]
    fleet.engines[draining]["ready"] = False
    fleet.engines[draining]["detail"] = {
        "state": "draining", "retry_after_s": 5.0,
        "saturation_cause": "slots"}
    tracer = Tracer(enabled=True)
    view = make_collector(fleet, tracer).poll_once()
    assert draining not in view.steer_set()
    eng = next(e for e in view.engines if e["url"] == draining)
    assert eng["state"] == "draining" and not eng["down"]
    assert eng["retry_after_s"] == 5.0
    assert eng["saturation_cause"] == "slots"
    assert view.counts() == {"up": 3, "down": 0, "unready": 1}
    assert not events(tracer, DOWN_EVENT)


def test_down_hysteresis_exactly_one_episode():
    fleet = FakeFleet()
    tracer = Tracer(enabled=True)
    collector = make_collector(fleet, tracer, down_after=2)
    collector.poll_once()
    victim = fleet.urls[0]
    fleet.engines[victim]["alive"] = False
    fleet.now += 1
    view = collector.poll_once()
    assert victim not in view.steer_set()
    assert not events(tracer, DOWN_EVENT)
    for _ in range(3):
        fleet.now += 1
        view = collector.poll_once()
    downs = events(tracer, DOWN_EVENT)
    assert len(downs) == 1
    assert downs[0]["url"] == victim
    assert downs[0]["engine"] == fleet.engines[victim]["engine_id"]
    assert view.counts()["down"] == 1
    fleet.engines[victim]["alive"] = True
    fleet.now += 1
    view = collector.poll_once()
    recovered = events(tracer, RECOVERED_EVENT)
    assert len(recovered) == 1 and recovered[0]["url"] == victim
    assert victim in view.steer_set()
    assert collector.event_counts()[:2] == (1, 1)


def test_stale_snapshot_flips_down_before_the_failure_threshold():
    fleet = FakeFleet()
    tracer = Tracer(enabled=True)
    collector = make_collector(fleet, tracer, down_after=5,
                               stale_ms=3000.0)
    collector.poll_once()
    victim = fleet.urls[2]
    fleet.engines[victim]["alive"] = False
    fleet.now += 1
    collector.poll_once()
    assert not events(tracer, DOWN_EVENT)
    fleet.now += 10
    collector.poll_once()
    downs = events(tracer, DOWN_EVENT)
    assert len(downs) == 1 and downs[0]["stale"] is True


def _advancer(fleet, collector):
    def advance(dt, retired, ttft_viol):
        fleet.now += dt
        for url in fleet.urls:
            fleet.engines[url]["retired"] = retired
            fleet.engines[url]["violations"]["ttft"] = ttft_viol
        return collector.poll_once()
    return advance


def test_burn_fast_fires_once_slow_holds_and_rearms():
    fleet = FakeFleet()
    tracer = Tracer(enabled=True)
    advance = _advancer(fleet, make_collector(fleet, tracer))
    # Fast window baseline = the sample 90 s back -> (60/360)/0.01 =
    # 16.7 >= 10 fires; the slow window's whole history -> 4.8 < 10.
    advance(0, 0, 0)
    advance(30, 100, 0)
    advance(30, 300, 0)
    advance(60, 400, 0)
    view = advance(30, 420, 20)
    assert view.burn["ttft"]["fast"] >= 10.0
    assert view.burn["ttft"]["slow"] < 10.0
    burns = events(tracer, BURN_EVENT)
    assert [(b["slo"], b["window"]) for b in burns].count(
        ("ttft", "fast")) == 1
    advance(10, 425, 20)
    assert len(events(tracer, BURN_EVENT)) == len(burns)
    advance(120, 600, 20)
    view = advance(10, 610, 20)
    assert view.burn["ttft"]["fast"] <= 5.0
    advance(10, 615, 40)
    fast_burns = [b for b in events(tracer, BURN_EVENT)
                  if (b["slo"], b["window"]) == ("ttft", "fast")]
    assert len(fast_burns) == 2


def test_burn_slow_window_stays_diluted_on_fresh_burst():
    fleet = FakeFleet()
    tracer = Tracer(enabled=True)
    advance = _advancer(fleet, make_collector(fleet, tracer))
    advance(0, 0, 0)
    advance(300, 1000, 0)
    view = advance(300, 1020, 20)
    assert view.burn["ttft"]["fast"] >= 10.0
    assert view.burn["ttft"]["slow"] < 10.0
    windows = {(b["slo"], b["window"])
               for b in events(tracer, BURN_EVENT)}
    assert windows == {("ttft", "fast")}


def test_desired_replicas_rises_under_saturation_and_decays():
    fleet = FakeFleet()
    collector = make_collector(fleet, Tracer(enabled=True),
                               sat_target=0.5, sat_alpha=0.5)
    assert collector.poll_once().desired_replicas == 1
    for url in fleet.urls:
        fleet.engines[url]["saturation"] = {
            "max": 1.0, "causes": {"slots": 1.0, "queue_age": 0.6}}
    fleet.now += 1
    assert collector.poll_once().desired_replicas == 3
    fleet.now += 1
    view = collector.poll_once()
    assert view.desired_replicas > 3
    assert view.saturation["slots"]["max"] == 1.0
    assert view.saturation["queue_age"]["mean"] == 0.6
    for url in fleet.urls:
        fleet.engines[url]["saturation"] = {
            "max": 0.0, "causes": {"slots": 0.0}}
    for _ in range(3):
        fleet.now += 1
        view = collector.poll_once()
    assert view.desired_replicas <= 3


def test_fleet_gauges_published_on_collector_tracer():
    fleet = FakeFleet()
    for url in fleet.urls:
        fleet.hist(url).observe(0.05)
        fleet.engines[url]["retired"] = 1
    tracer = Tracer(enabled=True)
    make_collector(fleet, tracer).poll_once()
    text = obs.prometheus_text(tracer)
    for series in ("tpu_fleet_engines", "tpu_fleet_saturation",
                   "tpu_fleet_desired_replicas",
                   "tpu_fleet_slo_burn_rate",
                   "tpu_fleet_ttft_seconds_bucket",
                   "tpu_fleet_polls_total"):
        assert series in text, series
    merged = histograms_from_text(text)[("tpu_fleet_ttft_seconds", ())]
    assert merged.count == 3


def test_overhead_is_deterministic():
    fleet = FakeFleet()
    collector = make_collector(fleet, Tracer(enabled=True))
    collector.poll_once()
    fleet.now += 1
    collector.poll_once()
    assert collector.overhead() == {"polls": 2, "fetches": 24,
                                    "engines": 3,
                                    "fetches_per_engine_cycle": 4.0}


# ---------------------------------------------------------------------------
# Against the JAX package, on the same inputs
# ---------------------------------------------------------------------------


def test_registry_and_buckets_are_the_jax_packages():
    """The /metrics family names dashboards and the HPA read, the
    router's journey vocabulary, and the serving histograms' grid (a
    single differing boundary would make a mixed fleet's merge
    raise)."""
    for name, value in vars(metric_names).items():
        if name.startswith(("FLEET_", "ROUTER_")):
            assert getattr(jax_names, name) == value
            assert jax_names.METRICS[value] == metric_names.METRICS[value]
    assert metric_names.NON_METRIC_TOKENS == jax_names.NON_METRIC_TOKENS
    from container_engine_accelerators_tpu.obs import (
        reqledger as jax_reqledger,
    )
    for name in ("ROUTER_BUCKETS", "TTFT_BUCKETS", "GAP_BUCKETS"):
        assert getattr(reqledger, name) == getattr(jax_reqledger, name)
    assert obs.ROUTER_BUCKETS == jax_obs.ROUTER_BUCKETS
    assert obs.DEFAULT_BUCKETS == jax_trace.DEFAULT_BUCKETS
    assert fleet.FETCHES_PER_ENGINE == jax_fleet.FETCHES_PER_ENGINE


def _hist_fields(h):
    return (h.name, dict(h.labels), tuple(h.buckets), list(h.counts),
            h.count, h.sum)


def test_merge_matches_jax():
    rng = np.random.default_rng(7)
    grids = [(0.5, 1.0, 2.0), jax_trace.DEFAULT_BUCKETS]
    for grid in grids:
        ours = [obs.Histogram(f"h{i}", buckets=grid) for i in range(3)]
        theirs = [jax_obs.Histogram(f"h{i}", buckets=grid)
                  for i in range(3)]
        for h, j in zip(ours, theirs):
            for v in rng.exponential(0.5, 40):
                h.observe(float(v))
                j.observe(float(v))
        ours[0].merge(ours[1]).merge(ours[2])
        theirs[0].merge(theirs[1]).merge(theirs[2])
        assert _hist_fields(ours[0]) == _hist_fields(theirs[0])
        for q in (0.5, 0.9, 0.99):
            assert ours[0].quantile(q) == theirs[0].quantile(q)
    errors = []
    for mod in (obs, jax_obs):
        a = mod.Histogram("a", buckets=(0.5, 1.0, 2.0))
        b = mod.Histogram("b", buckets=(0.5, 1.0))
        with pytest.raises(ValueError) as err:
            a.merge(b)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_histograms_from_text_matches_jax():
    """The same exposition text (serving histograms with labels and
    escapes, counters, gauges and malformed families) parses to the
    same histograms in both packages."""
    rng = np.random.default_rng(11)
    tracer = Tracer(enabled=True)
    for name, labels in ((SERVING_TTFT, {"model": "lm"}),
                         (SERVING_TTFT, {"model": 'a"b\\c'}),
                         (SERVING_TPOT, {}),
                         ("other_seconds", {"x": "1"})):
        h = tracer.histogram(name, "help", labels=labels)
        for v in rng.exponential(0.05, 30):
            h.observe(float(v))
    tracer.counter("tpu_serving_slo_violations_total", slo="ttft")
    tracer.gauge("tpu_serving_saturation", 0.25)
    text = obs.prometheus_text(tracer) + "\n" + MALFORMED_TEXT + "\n"
    for names in (None, {SERVING_TTFT, SERVING_TPOT}):
        ours = histograms_from_text(text, names=names)
        theirs = jax_fleet.histograms_from_text(text, names=names)
        assert set(ours) == set(theirs)
        for key in ours:
            assert _hist_fields(ours[key]) == _hist_fields(theirs[key])
    assert fleet._parse_sample('a{b="c"} 1') \
        == jax_fleet._parse_sample('a{b="c"} 1')


class ScriptedFleet:
    """A seeded script of per-poll engine payloads: at every poll each
    engine is alive or refusing, ready or draining / quarantined with
    a Retry-After, at some saturation and queue depth, with growing
    retired and SLO-violation counts and TTFT/TPOT histograms. Both
    collectors fetch the SAME bytes at the same step."""

    def __init__(self, seed, n_engines=3, steps=40):
        rng = np.random.default_rng(seed)
        self.urls = [f"http://engine{i}:85{i:02d}" for i in range(n_engines)]
        self.times = np.cumsum(rng.uniform(1.0, 45.0, steps)) + 1000.0
        self.step = 0
        self.table = []
        tracers = [Tracer(enabled=True) for _ in self.urls]
        retired = [0] * n_engines
        viol = [{"ttft": 0, "tpot": 0} for _ in self.urls]
        outage = [0] * n_engines
        for _ in range(steps):
            row = {}
            for i, url in enumerate(self.urls):
                n = int(rng.integers(0, 30))
                retired[i] += n
                for slo in ("ttft", "tpot"):
                    burst = rng.random() < 0.2
                    viol[i][slo] += int(rng.integers(0, n + 1)) \
                        if burst else 0
                for name in (SERVING_TTFT, SERVING_TPOT):
                    h = tracers[i].histogram(name, "lat",
                                             labels={"model": "lm"})
                    for v in rng.exponential(0.08, n):
                        h.observe(float(v))
                sat = float(np.round(rng.random(), 3))
                causes = {"slots": sat,
                          "kv_blocks": float(np.round(rng.random() * sat,
                                                      3)),
                          "queue_age": float(np.round(rng.random(), 3))}
                stats = {"engine_id": f"lm@{url}",
                         "requests_retired": retired[i],
                         "queue_depth": (None if rng.random() < 0.1
                                         else int(rng.integers(0, 9))),
                         "slo": {"violations": dict(viol[i])},
                         "saturation": {"max": sat, "causes": causes}}
                kind = rng.random()
                if kind < 0.08:                # an outage of 1-4 polls
                    outage[i] = int(rng.integers(1, 5))
                if outage[i]:
                    outage[i] -= 1
                    readyz = None              # transport failure
                elif kind < 0.3:
                    state = ["draining", "quarantined",
                             "breaker_open"][int(rng.integers(0, 3))]
                    retry = float(rng.integers(1, 60))
                    detail = {"state": state, "retry_after_s": retry,
                              "saturation_cause": "slots"}
                    if rng.random() < 0.3:
                        del detail["retry_after_s"]
                    readyz = (503, {"Retry-After": str(int(retry))},
                              json.dumps(detail).encode())
                else:
                    readyz = (200, {}, b'{"status": "ok"}')
                row[url] = {
                    "/stats": (200, {}, json.dumps(stats).encode()),
                    "/metrics": (200, {}, obs.prometheus_text(
                        tracers[i]).encode()),
                    "/readyz": readyz,
                    "/debug/requests?n=8": (200, {}, json.dumps(
                        {"retired_total": retired[i],
                         "records": [{}] * min(8, retired[i])}
                    ).encode()),
                }
            self.table.append(row)

    def clock(self):
        return float(self.times[self.step])

    def fetch(self, url, timeout=3.0):
        base = next(u for u in self.urls if url.startswith(u + "/"))
        answer = self.table[self.step][base][url[len(base):]]
        if self.table[self.step][base]["/readyz"] is None:
            raise OSError("connection refused")
        return answer


def _view_fields(view):
    out = view.to_dict()
    out["now"] = view.now
    out["ttft_counts"] = list(view.ttft.counts)
    out["tpot_counts"] = list(view.tpot.counts)
    out["sat_ewma"] = view.sat_ewma
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collector_views_match_jax_on_a_seeded_script(seed):
    """Saturation, steer set, down episodes, burn alerts and desired
    replicas (with every other FleetView field) equal the JAX
    collector's at every poll of the same script."""
    script = ScriptedFleet(seed)
    kw = collector_kwargs(down_after=2, stale_ms=60000.0,
                          fast_window_s=60.0, slow_window_s=300.0,
                          burn_threshold=2.0, slo_budget=0.05,
                          sat_target=0.6, sat_alpha=0.4)
    tracers = {"port": Tracer(enabled=True),
               "jax": jax_obs.Tracer(enabled=True)}
    collectors = {
        "port": FleetCollector(script.urls, tracer=tracers["port"],
                               fetch=script.fetch, clock=script.clock,
                               **kw),
        "jax": jax_fleet.FleetCollector(
            script.urls, tracer=tracers["jax"], fetch=script.fetch,
            clock=script.clock, **kw)}
    seen = {"down": 0, "unready": 0, "burn": 0}
    for step in range(len(script.table)):
        script.step = step
        views = {k: c.poll_once() for k, c in collectors.items()}
        assert _view_fields(views["port"]) == _view_fields(views["jax"])
        for k in ("port", "jax"):
            assert views[k].steer_set() == _view_fields(
                views["port"])["steer_set"]
        assert collectors["port"].event_counts() \
            == collectors["jax"].event_counts()
        counts = views["port"].counts()
        seen["down"] += counts["down"]
        seen["unready"] += counts["unready"]
    seen["burn"] = collectors["port"].event_counts()[2]
    # The script exercised every branch it is meant to compare.
    assert seen["down"] and seen["unready"] and seen["burn"], seen
    for name in (DOWN_EVENT, RECOVERED_EVENT, BURN_EVENT):
        ours = [e["fields"] for e in tracers["port"].snapshot()["events"]
                if e["name"] == name]
        theirs = [e["fields"] for e in
                  tracers["jax"].snapshot()["events"]
                  if e["name"] == name]
        assert ours == theirs, name
    assert tracers["port"].gauges() == tracers["jax"].gauges()
    assert {k: v for k, v in tracers["port"].counters().items()} \
        == {k: v for k, v in tracers["jax"].counters().items()}
    assert collectors["port"].overhead() == collectors["jax"].overhead()
    assert not math.isnan(views["port"].sat_ewma)

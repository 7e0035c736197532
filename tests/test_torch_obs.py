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

"""The port's copies of the observability modules and the fault seam
against the JAX package's, on the same inputs: Prometheus text byte for
byte, the traceparent / request-id carrier, the request timeline, the
ledger's attribution summary, saturation, and fault-plan parsing and
counting. Then the port's own device-timed spans and one clock, which
the JAX tracer does not have, on a fake CUDA event seam."""

import json
import types

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.obs import export as jax_export
from container_engine_accelerators_tpu.obs import propagate as jax_prop
from container_engine_accelerators_tpu.obs import reqledger as jax_ledger
from container_engine_accelerators_tpu.obs import trace as jax_trace
from container_engine_accelerators_tpu.utils import faults as jax_faults
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.obs import export
from container_engine_accelerators_tpu_torch.obs import metric_names
from container_engine_accelerators_tpu_torch.obs import propagate
from container_engine_accelerators_tpu_torch.obs import reqledger
from container_engine_accelerators_tpu_torch.obs import trace
from container_engine_accelerators_tpu_torch.utils import faults


def _script(seed):
    """A seeded sequence of metric operations: (kind, name, value,
    labels, extra)."""
    rng = np.random.default_rng(seed)
    ops = []
    names = ["tpu_serving_ttft_seconds", "serving_request_latency_seconds",
             "tpu_serving_slot_occupancy"]
    for _ in range(40):
        kind = rng.choice(["hist", "counter", "gauge"])
        labels = {}
        if rng.random() < 0.6:
            labels["model"] = rng.choice(["lm", 'we"ird\\name\nx', "r"])
        if rng.random() < 0.3:
            labels["kind"] = rng.choice(["engine_step", "engine_prefill"])
        if kind == "hist":
            name = str(rng.choice(names))
            buckets = ((0.125, 0.25, 0.5, 1.0)
                       if name.endswith("occupancy") else None)
            value = float(rng.choice([rng.exponential(0.05), 100.0, 0.0,
                                      1.0]))
            ops.append(("hist", name, value, labels, buckets))
        elif kind == "counter":
            ops.append(("counter", "tpu_serving_slo_violations_total",
                        int(rng.integers(1, 4)), labels, None))
        else:
            ops.append(("gauge", "tpu_serving_saturation_cause",
                        float(rng.random()), labels, None))
    return ops


def _play(tracer, ops):
    for kind, name, value, labels, buckets in ops:
        if kind == "hist":
            tracer.histogram(name, "help " + name, labels,
                             buckets).observe(value)
        elif kind == "counter":
            tracer.counter(name, value, **labels)
        else:
            tracer.gauge(name, value, **labels)


@pytest.mark.parametrize("seed", range(4))
def test_prometheus_text_is_byte_equal(seed):
    ops = _script(seed)
    mine, theirs = trace.Tracer(enabled=True), jax_trace.Tracer(
        enabled=True)
    _play(mine, ops)
    _play(theirs, ops)
    text = export.prometheus_text(mine)
    assert text == jax_export.prometheus_text(theirs)
    assert text.count("_bucket{") > 0
    # The fleet collector's parser reads the port's text back exactly.
    from container_engine_accelerators_tpu.obs.fleet import (
        histograms_from_text,
    )
    parsed = histograms_from_text(text)
    for h in mine.histograms():
        got = parsed[(h.name, tuple(sorted(h.labels.items())))]
        assert got.snapshot()[0] == h.snapshot()[0]


@pytest.mark.parametrize("seed", range(2))
def test_histogram_quantiles_and_varz_agree(seed):
    ops = _script(seed)
    mine, theirs = trace.Tracer(enabled=True), jax_trace.Tracer(
        enabled=True)
    _play(mine, ops)
    _play(theirs, ops)
    for a, b in zip(sorted(mine.histograms(), key=lambda h: (
            h.name, sorted(h.labels.items()))),
            sorted(theirs.histograms(), key=lambda h: (
                h.name, sorted(h.labels.items())))):
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert a.quantile(q) == b.quantile(q)
    va, vb = export.varz(mine), jax_export.varz(theirs)
    for key in ("histograms", "counters", "gauges", "tracing_enabled"):
        assert va[key] == vb[key]
    assert set(va["journal"]) == set(vb["journal"])


_CONTEXTS = [(1, 1), (0xABCDEF, 0x1234), ((1 << 127) + 5, (1 << 63) + 7),
             ((1 << 51) | 99, (1 << 51) | 100)]
_HEADERS = [
    {"traceparent": "00-0000000000000000000000000000abcd-"
                    "00000000000000ef-01", "x-cea-request-id": "req-1"},
    {"TraceParent": "00-0af7651916cd43dd8448eb211c80319c-"
                    "b7ad6b7169203331-01", "X-Cea-Request-Id": "a.b_c"},
    {"traceparent": "00-00000000000000000000000000000000-"
                    "00000000000000ef-01"},
    {"traceparent": "01-0000000000000000000000000000abcd-"
                    "00000000000000ef-01", "x-cea-request-id": "bad id!"},
    {"traceparent": "garbage", "x-cea-request-id": "x" * 65},
    {},
    None,
]


@pytest.mark.parametrize("ctx", _CONTEXTS)
def test_traceparent_round_trips_equal(ctx):
    value = propagate.format_traceparent(ctx)
    assert value == jax_prop.format_traceparent(ctx)
    assert propagate.parse_traceparent(value) == \
        jax_prop.parse_traceparent(value)
    assert propagate.parse_traceparent(value) == (
        ctx[0] & ((1 << 128) - 1), ctx[1] & ((1 << 64) - 1))
    mine = propagate.inject_headers(ctx, "rid-7", {"Content-Type": "x"})
    theirs = jax_prop.inject_headers(ctx, "rid-7", {"Content-Type": "x"})
    assert mine == theirs
    assert propagate.extract_headers(mine) == jax_prop.extract_headers(
        theirs) == (ctx, "rid-7")


@pytest.mark.parametrize("i", range(len(_HEADERS)))
def test_extract_headers_equal_on_wire_inputs(i):
    headers = _HEADERS[i]
    assert propagate.extract_headers(headers) == \
        jax_prop.extract_headers(headers)
    assert (propagate.TRACEPARENT_KEY, propagate.REQUEST_ID_KEY) == (
        jax_prop.TRACEPARENT_KEY, jax_prop.REQUEST_ID_KEY)


class _Clock:
    def __init__(self, times):
        self._times = list(times)

    def __call__(self):
        return self._times.pop(0)


def _timeline_script(seed):
    rng = np.random.default_rng(seed)
    buckets = list(reqledger.ATTRIBUTION_BUCKETS)
    laps = [(str(rng.choice(buckets)), float(rng.exponential(0.01)))
            for _ in range(12)]
    return laps, float(rng.exponential(0.003))


@pytest.mark.parametrize("seed", range(4))
def test_request_timeline_and_ledger_agree(seed):
    laps, moved = _timeline_script(seed)
    times, t = [100.0], 100.0
    for _, dt in laps:
        t += dt
        times.append(t)
    times.append(t + 0.002)   # finish
    records = []
    for mod in (reqledger, jax_ledger):
        tl = mod.RequestTimeline(clock=_Clock(times))
        tl.submit_unix = 1.0e9   # wall stamps differ by construction
        for bucket, _ in laps:
            tl.lap(bucket)
        tl.note_first_token(now=times[3])
        tl.move("prefill", "rehydrate", moved)
        records.append(tl.finish("completed", tokens=5, stream=True,
                                 prompt_len=9))
    assert records[0] == records[1]
    rec = records[0]
    assert abs(sum(rec["buckets"].values()) - rec["wall_s"]) < 1e-9
    mine = reqledger.RequestLedger(capacity=4,
                                   tracer=trace.Tracer(enabled=True))
    theirs = jax_ledger.RequestLedger(capacity=4,
                                      tracer=jax_trace.Tracer(enabled=True))
    for k in range(6):
        r = dict(rec, tokens=k)
        mine.add(r)
        theirs.add(r)
    assert mine.attribution_stats() == theirs.attribution_stats()
    assert mine.records(3) == theirs.records(3)
    assert mine.retired_total() == theirs.retired_total() == 6


_SATURATION = [
    dict(slots_active=3, slots_total=8),
    dict(slots_active=2, slots_total=16, blocks_available=4,
         blocks_usable=100, oldest_wait_s=0.3),
    dict(slots_active=0, slots_total=4, blocks_available=0,
         blocks_usable=10, oldest_wait_s=5.0, queue_horizon_s=2.0),
    dict(slots_active=9, slots_total=8, oldest_wait_s=0.5,
         queue_horizon_s=0.0),
    dict(),
]


@pytest.mark.parametrize("i", range(len(_SATURATION)))
def test_saturation_agrees(i):
    kw = _SATURATION[i]
    assert obs.saturation(**kw) == jax_obs.saturation(**kw)


def test_metric_names_are_the_jax_registrys():
    from container_engine_accelerators_tpu.obs import (
        metric_names as jax_names,
    )
    for name, value in vars(metric_names).items():
        if name.startswith("SERVING_"):
            assert getattr(jax_names, name) == value
            assert jax_names.METRICS[value] == metric_names.METRICS[value]


_PLANS = [
    {"step": [1]},
    {"step": [0, 3], "prefill": [2], "hydrate": [0]},
    {"prefill": []},
    {"bogus_op": [1]},
    {"step": [-1]},
    {"step": 3},
    [1, 2],
]


def _run_plan(mod, spec, calls):
    try:
        plan = mod.install(spec)
    except ValueError as e:
        return ("error", str(e))
    out = []
    for op in calls:
        try:
            mod.fire(op)
            out.append((op, "ok"))
        except mod.InjectedFault as e:
            out.append((op, str(e)))
    return ("ok", out, plan.counts(), plan.fired(), plan.pending())


@pytest.mark.parametrize("i", range(len(_PLANS)))
def test_fault_plans_parse_and_count_equal(i):
    calls = ["step", "prefill", "step", "hydrate", "prefill", "prefill",
             "step", "step", "hydrate"]
    try:
        got = _run_plan(faults, _PLANS[i], calls)
        want = _run_plan(jax_faults, _PLANS[i], calls)
    finally:
        faults.reset()
        jax_faults.reset()
    assert got == want
    assert issubclass(faults.InjectedFault, RuntimeError)


def test_fault_plan_from_env(monkeypatch):
    spec = {"hydrate": [0], "step": [2]}
    monkeypatch.setenv(faults.FAULT_PLAN_ENV, json.dumps(spec))
    faults.reset()
    jax_faults.reset()
    try:
        assert faults.active().pending() == jax_faults.active().pending()
        assert faults.active().pending() == {"hydrate": [0], "step": [2]}
    finally:
        faults.reset()
        jax_faults.reset()
    monkeypatch.delenv(faults.FAULT_PLAN_ENV)
    assert faults.active() is None


def test_debug_surface_and_spans():
    tracer = trace.Tracer(enabled=True)
    with tracer.span("serving.request", parent=(0xAB, 0xCD)) as sp:
        with tracer.span("serving.prefill") as child:
            pass
        tracer.event("serving.engine_quarantine", reason="step")
    snap = tracer.snapshot()
    (req,) = [s for s in snap["spans"] if s["name"] == "serving.request"]
    (pre,) = [s for s in snap["spans"] if s["name"] == "serving.prefill"]
    assert req["trace_id"] == 0xAB and req["parent_id"] == 0xCD
    assert pre["trace_id"] == 0xAB and pre["parent_id"] == sp.span_id
    assert child.context() == (0xAB, pre["span_id"])
    assert snap["events"][0]["trace_id"] == 0xAB
    ctype, body = obs.debug_response(tracer, "/debug/trace", "perfetto=1")
    doc = json.loads(body)
    mine = export.perfetto_trace(snap)
    assert doc == json.loads(json.dumps(mine))
    assert mine == jax_export.perfetto_trace(snap)
    assert obs.debug_response(tracer, "/nope") is None
    assert trace.Tracer(enabled=False).span("x") is trace.NULL_SPAN


# -- device-timed spans -------------------------------------------------

CUDA = types.SimpleNamespace(type="cuda")


class _FakeEvent:
    """A CUDA timing event that completes when the test says so; a wait
    or a time read before its query answers True fails the test."""

    def __init__(self, clock):
        self.clock = clock
        self.done = False
        self.t = None
        self.queries = 0

    def record(self, stream):
        assert stream == "stream"
        self.done, self.t = False, self.clock.now

    def query(self):
        self.queries += 1
        return self.done

    def synchronize(self):
        raise AssertionError("a device span synchronised")

    def elapsed_time(self, end):
        if not (self.done and end.done):
            raise AssertionError("elapsed_time on an unresolved event")
        return 1e3 * (end.t - self.t)


class _FakeClock:
    """The tracer's device-clock seam: ``now`` is the device time the
    next recorded event stamps."""

    def __init__(self):
        self.made = []
        self.now = 0.0
        self.capture = False
        self.lookups = 0

    def new_event(self):
        self.made.append(_FakeEvent(self))
        return self.made[-1]

    def stream(self, device):
        assert device is CUDA
        self.lookups += 1
        return None if self.capture else "stream"


def _device_s(tracer):
    return {s["name"]: s["device_s"] for s in tracer.snapshot()["spans"]}


def test_device_span_on_the_cpu_is_its_duration():
    tracer = trace.Tracer(enabled=True)
    with tracer.span("work", timed_on=torch.device("cpu"), rows=2):
        torch.ones(64, 64).sum()
    (rec,) = tracer.snapshot()["spans"]
    assert rec["device_s"] == rec["duration_s"] > 0
    assert rec["attrs"] == {"rows": 2}
    # ``device`` is an attribute, as on the JAX package's spans.
    with tracer.span("rpc", device="cuda:0"):
        pass
    rec = tracer.snapshot()["spans"][-1]
    assert rec["attrs"] == {"device": "cuda:0"} and "device_s" not in rec


def test_device_spans_resolve_in_stream_order_without_a_sync():
    clock = _FakeClock()
    tracer = trace.Tracer(enabled=True, device_clock=clock)
    for i, name in enumerate("abc"):
        clock.now = 10.0 * i
        with tracer.span(name, timed_on=CUDA):
            clock.now = 10.0 * i + i + 1      # 1, 2 and 3 s a span
    # One stream lookup a span, at enter.
    assert len(clock.made) == 6 and clock.lookups == 3
    assert _device_s(tracer) == {"a": None, "b": None, "c": None}
    a0, a1, b0, b1, c0, c1 = clock.made
    for event in (a0, a1, b0, c0, c1):
        event.done = True
    # b's end has not completed: b and c (behind it) stay pending. An
    # end that completed answers for its start.
    assert _device_s(tracer) == {"a": 1.0, "b": None, "c": None}
    assert c1.queries == 0 and a0.queries == 0
    b1.done = True
    assert _device_s(tracer) == {"a": 1.0, "b": 2.0, "c": 3.0}
    # Resolved pairs go back to the pool: the next spans reuse them.
    with tracer.span("d", timed_on=CUDA):
        with tracer.span("e", timed_on=CUDA):
            pass
    assert len(clock.made) == 6


def test_device_spans_resolve_at_later_span_exits():
    """Span exits leave pending pairs alone until ``RESOLVE_EVERY`` of
    them wait; a try that finds the oldest incomplete waits as many
    more pairs before it queries again."""
    every = trace.Tracer.RESOLVE_EVERY
    clock = _FakeClock()
    tracer = trace.Tracer(enabled=True, device_clock=clock)
    for _ in range(every - 1):
        with tracer.span("a", timed_on=CUDA):
            clock.now += 0.5
    for event in clock.made:
        event.done = True
    with tracer.span("host"):
        pass
    assert all(e.queries == 0 for e in clock.made)
    assert all(r["device_s"] is None for r in tracer._spans[:-1])
    with tracer.span("b", timed_on=CUDA):
        clock.now += 0.5
    early, late = clock.made[-2:]
    assert [r["device_s"] for r in tracer._spans[:every - 1]] == (
        [0.5] * (every - 1))
    # The newest end had not completed: it stays pending, and the next
    # query waits for RESOLVE_EVERY more pairs.
    assert tracer._spans[-1]["device_s"] is None and late.queries == 1
    for _ in range(every - 1):
        with tracer.span("c", timed_on=CUDA):
            pass
    assert late.queries == 1
    early.done = late.done = True
    with tracer.span("c", timed_on=CUDA):
        pass
    assert late.queries == 2 and tracer._spans[every]["device_s"] == 0.5


def test_pending_device_pairs_are_bounded():
    clock = _FakeClock()
    tracer = trace.Tracer(capacity=2, enabled=True, device_clock=clock)
    for name in "abc":
        with tracer.span(name, timed_on=CUDA):
            pass
    snap = tracer.snapshot()
    assert snap["dropped_device"] == 1
    assert [s["name"] for s in snap["spans"]] == ["b", "c"]
    for event in clock.made:
        event.done = True
    assert _device_s(tracer) == {"b": 0.0, "c": 0.0}
    tracer.reset()
    assert tracer.snapshot()["dropped_device"] == 0


def test_no_device_event_while_disabled_or_capturing():
    clock = _FakeClock()
    off = trace.Tracer(enabled=False, device_clock=clock)
    with off.span("x", timed_on=CUDA) as sp:
        pass
    assert sp is trace.NULL_SPAN and off.snapshot()["spans"] == []
    clock.capture = True
    on = trace.Tracer(enabled=True, device_clock=clock)
    with on.span("graph", timed_on=CUDA):
        pass
    assert clock.made == []
    assert _device_s(on) == {"graph": None}


def test_span_starts_are_monotonic_from_the_anchor():
    tracer = trace.Tracer(enabled=True)
    for i in range(50):
        with tracer.span("s%d" % i):
            pass
    snap = tracer.snapshot()
    anchor = snap["anchor"]
    assert snap["started_unix"] == anchor["unix"]
    starts = [s["start_unix"] for s in snap["spans"]]
    assert starts[0] >= anchor["unix"]
    for prev, s in zip(snap["spans"], snap["spans"][1:]):
        # One clock: a span starts after the one before it ended (up
        # to the unix scale's float rounding).
        assert s["start_unix"] >= prev["start_unix"]
        assert prev["start_unix"] + prev["duration_s"] <= (
            s["start_unix"] + 1e-6)
    assert tracer.unix_at(anchor["perf_counter"]) == anchor["unix"]

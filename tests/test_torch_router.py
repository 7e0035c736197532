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

"""The port's fleet router (``serving/router.py``): the counterparts of
tests/test_router.py — tenant deficit math, the placement order
(affinity -> bounded-load spill -> hedge -> least-loaded with live
in-flight counts), shed statuses with derived Retry-After, and the
mid-stream failover splice against scripted stdlib engines, and two
real engines of the port (``serving.fleet_worker --device cpu``) with a
SIGKILL mid-stream. Then a differential case: a seeded trace of route()
calls with tenants, shared prefixes, in-flight churn and saturation
changes through the port's RouterCore and the JAX package's over the
same scripted fleet and clock, whose decisions must be equal."""

import http.client
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.obs import fleet as jax_fleet
from container_engine_accelerators_tpu.serving import router as jax_router
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.obs import fleet as port_fleet
from container_engine_accelerators_tpu_torch.obs.fleet import (
    FleetCollector,
)
from container_engine_accelerators_tpu_torch.obs.trace import Tracer
from container_engine_accelerators_tpu_torch.serving import (
    router as port_router,
)
from container_engine_accelerators_tpu_torch.serving.router import (
    REASON_AFFINITY,
    REASON_HEDGE,
    REASON_LEAST_LOADED,
    REASON_SPILL,
    SHED_NO_ENGINES,
    SHED_SATURATED,
    SHED_TENANT_RATE,
    RouterCore,
    RouterServer,
    TenantLedger,
    parse_weights,
)
from tests.test_torch_fleet_collector import (
    FakeFleet,
    collector_kwargs,
    make_collector,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BS = 4
KEYED = [1, 2, 3, 4, 5, 6, 7, 8]       # two full BS=4 blocks
UNKEYED = [1, 2, 3]                    # below one block: no key


def _sat(x):
    return {"max": x, "causes": {"slots": x}}


def make_core(fleet, **kw):
    coll = make_collector(fleet, Tracer(enabled=True))
    coll.poll_once()
    kw.setdefault("block_size", BS)
    kw.setdefault("shed_sat", 0.9)
    kw.setdefault("tenants", TenantLedger(rate=0))
    kw.setdefault("spill_bound", 2)
    return coll, RouterCore(coll, **kw)


# ---------------------------------------------------------------------------
# tenant fairness
# ---------------------------------------------------------------------------


def test_parse_weights_tolerates_junk():
    assert parse_weights("a=2, b=0.5") == {"a": 2.0, "b": 0.5}
    assert parse_weights("a=2,,=3,c=x,d=-1,e") == {"a": 2.0}
    assert parse_weights("") == {}
    assert parse_weights(None) == {}


def test_tenant_ledger_weighted_deficit_math():
    now = [1000.0]
    led = TenantLedger(rate=10.0, burst_s=2.0, weights={"big": 2.0},
                       clock=lambda: now[0])
    ok, wait = led.admit("small", 20)
    assert ok and wait is None
    ok, wait = led.admit("small", 1)
    assert not ok and wait == 1
    ok, wait = led.admit("big", 40)
    assert ok and wait is None
    now[0] += 1.0
    ok, _ = led.admit("small", 10)
    assert ok
    # A cost above the burst cap quotes the FULL-cap wait.
    ok, wait = led.admit("small", 1000)
    assert not ok and wait == 2
    assert TenantLedger(rate=0).admit("anyone", 10 ** 9) == (True, None)


def test_tenant_shed_is_429_with_retry_after():
    fleet = FakeFleet()
    now = [0.0]
    _, core = make_core(fleet, tenants=TenantLedger(
        rate=10.0, burst_s=1.0, clock=lambda: now[0]))
    assert core.route(UNKEYED, 10)["action"] == "route"
    decision = core.route(UNKEYED, 10)
    assert decision == {"action": "shed", "status": 429,
                        "reason": SHED_TENANT_RATE, "retry_after": 1}
    assert core.stats()["shed"] == {SHED_TENANT_RATE: 1}


# ---------------------------------------------------------------------------
# placement order
# ---------------------------------------------------------------------------


def test_unkeyed_routes_least_loaded_and_inflight_spreads():
    fleet = FakeFleet()
    _, core = make_core(fleet)
    d = core.route(UNKEYED, 10)
    assert d["action"] == "route" and d["key"] is None
    assert d["reason"] == REASON_LEAST_LOADED
    assert d["url"] == fleet.urls[0]   # all-equal tie: URL order
    core.inflight_begin(fleet.urls[0])
    assert core.route(UNKEYED, 10)["url"] == fleet.urls[1]
    core.inflight_end(fleet.urls[0])
    assert core.route(UNKEYED, 10)["url"] == fleet.urls[0]


def test_inflight_outranks_stale_saturation():
    # A poll-stale 0.25 saturation must not outrank live placement.
    fleet = FakeFleet()
    fleet.engines[fleet.urls[0]]["saturation"] = _sat(0.25)
    coll, core = make_core(fleet)
    coll.poll_once()
    assert core.route(UNKEYED, 10)["url"] == fleet.urls[1]
    core.inflight_begin(fleet.urls[1])
    core.inflight_begin(fleet.urls[2])
    assert core.route(UNKEYED, 10)["url"] == fleet.urls[0]


def test_affinity_seed_hit_and_lru_cap():
    fleet = FakeFleet()
    _, core = make_core(fleet, affinity_cap=2)
    seed = core.route(KEYED, 10)
    assert seed["reason"] == REASON_LEAST_LOADED
    assert seed["key"] is not None
    home = seed["url"]
    core.inflight_begin(home)   # the pin overrides least-loaded
    hit = core.route(KEYED, 10)
    assert hit == {"action": "route", "url": home,
                   "reason": REASON_AFFINITY, "key": seed["key"]}
    stats = core.stats()["affinity"]
    assert (stats["lookups"], stats["hits"]) == (2, 1)
    assert stats["hit_rate"] == 0.5
    core.route([9] * 8, 10)
    core.route([11] * 8, 10)
    snap = core.affinity_snapshot()
    assert len(snap) == 2 and seed["key"].hex() not in snap


def test_hedge_repoints_when_home_is_hot():
    fleet = FakeFleet()
    coll, core = make_core(fleet)
    home = core.route(KEYED, 10)["url"]
    fleet.engines[home]["saturation"] = _sat(0.95)
    coll.poll_once()
    d = core.route(KEYED, 10)
    assert d["reason"] == REASON_HEDGE and d["url"] != home
    assert core.affinity_snapshot()[d["key"].hex()] == d["url"]


def test_spill_past_bound_without_repointing():
    fleet = FakeFleet()
    coll, core = make_core(fleet, spill_bound=2)
    seed = core.route(KEYED, 10)
    home, key = seed["url"], seed["key"]
    fleet.engines[home]["queue_depth"] = 5   # bound(2) + best(0) < 5
    coll.poll_once()
    d = core.route(KEYED, 10)
    assert d["reason"] == REASON_SPILL and d["url"] != home
    assert core.affinity_snapshot()[key.hex()] == home
    assert core.stats()["affinity"]["hits"] == 0
    fleet.engines[home]["queue_depth"] = 1
    coll.poll_once()
    assert core.route(KEYED, 10)["reason"] == REASON_AFFINITY


def test_spill_bound_zero_disables():
    fleet = FakeFleet()
    coll, core = make_core(fleet, spill_bound=0)
    home = core.route(KEYED, 10)["url"]
    fleet.engines[home]["queue_depth"] = 50
    coll.poll_once()
    assert core.route(KEYED, 10) == {
        "action": "route", "url": home, "reason": REASON_AFFINITY,
        "key": core.route(KEYED, 10)["key"]}


# ---------------------------------------------------------------------------
# shedding and siblings
# ---------------------------------------------------------------------------


def test_saturated_fleet_sheds_with_ramp_retry_after():
    fleet = FakeFleet()
    for url in fleet.urls:
        fleet.engines[url]["saturation"] = _sat(0.95)
    coll, core = make_core(fleet)
    coll.poll_once()
    assert core.route(UNKEYED, 10) == {
        "action": "shed", "status": 503, "reason": SHED_SATURATED,
        "retry_after": 5}


def test_dead_fleet_sheds_no_engines():
    fleet = FakeFleet()
    coll, core = make_core(fleet, shed_sat=2.0)
    for url in fleet.urls:
        fleet.engines[url]["alive"] = False
    for _ in range(3):   # past the down hysteresis
        fleet.now += 10.0
        coll.poll_once()
    d = core.route(UNKEYED, 10)
    assert d["action"] == "shed" and d["status"] == 503
    assert d["reason"] == SHED_NO_ENGINES and d["retry_after"] >= 1


def test_draining_horizon_caps_retry_after():
    fleet = FakeFleet()
    for url in fleet.urls:
        fleet.engines[url]["ready"] = False
        fleet.engines[url]["detail"] = {"state": "draining",
                                        "retry_after_s": 7.0,
                                        "saturation_cause": None}
    coll, core = make_core(fleet)
    coll.poll_once()
    d = core.route(UNKEYED, 10)
    assert d["reason"] == SHED_NO_ENGINES and d["retry_after"] == 7


def test_sibling_prefers_cold_falls_back_hot():
    fleet = FakeFleet()
    failed, hot, cold = fleet.urls
    fleet.engines[hot]["saturation"] = _sat(0.95)
    coll, core = make_core(fleet)
    coll.poll_once()
    assert core.sibling({failed}) == cold
    assert core.sibling({failed, cold}) == hot
    assert core.sibling(set(fleet.urls)) is None


# ---------------------------------------------------------------------------
# the stream splice against scripted HTTP engines
# ---------------------------------------------------------------------------


class ScriptedEngine:
    """A stdlib HTTP engine that answers the collector's poll surfaces
    and streams a scripted ndjson plan on POST. Plans: ("tokens", [..])
    lines, "die" (drop the connection mid-stream), "done", or
    ("envelope", {...})."""

    def __init__(self):
        self.plan = []
        self.requests = []       # payloads this engine received
        self.headers = []        # header dicts, parallel to requests
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _json(self, body):
                payload = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def do_GET(self):
                path = self.path.partition("?")[0]
                if path == "/stats":
                    self._json({
                        "engine_id": f"fake@{outer.port}",
                        "requests_retired": 0,
                        "queue_depth": 0,
                        "slo": {"violations": {}},
                        "saturation": {"max": 0.0, "causes": {}},
                    })
                elif path == "/metrics":
                    self.send_response(200)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                elif path in ("/readyz", "/healthz"):
                    self._json({"status": "ok"})
                elif path.startswith("/debug/requests"):
                    self._json({"retired_total": 0, "records": []})
                else:
                    self.send_error(404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                outer.requests.append(payload)
                outer.headers.append(
                    {k.lower(): v for k, v in self.headers.items()})
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.end_headers()
                for step in outer.plan:
                    if step == "die":
                        self.wfile.flush()
                        self.connection.close()
                        return
                    if step == "done":
                        self.wfile.write(b'{"done": true}\n')
                    elif step[0] == "tokens":
                        self.wfile.write(json.dumps(
                            {"tokens": step[1]}).encode() + b"\n")
                    else:
                        self.wfile.write(json.dumps(
                            step[1]).encode() + b"\n")
                    self.wfile.flush()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _stream_through_router(port, payload, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/v1/models/lm:generate",
                 body=json.dumps(payload).encode(),
                 headers=dict({"Content-Type": "application/json"},
                              **(headers or {})))
    resp = conn.getresponse()
    lines = []
    while True:
        raw = resp.readline()
        if not raw:
            break
        if raw.strip():
            lines.append(json.loads(raw))
    conn.close()
    return resp.status, lines


@pytest.fixture
def scripted_pair():
    engines = [ScriptedEngine(), ScriptedEngine()]
    # The all-idle tie breaks lexicographically: the URL-smallest
    # engine receives the first request.
    first, second = sorted(engines, key=lambda e: e.url)
    collector = FleetCollector([e.url for e in engines],
                               poll_ms=10000.0)
    core = RouterCore(collector, block_size=BS, shed_sat=2.0,
                      tenants=TenantLedger(rate=0))
    server = RouterServer(core, collector, port=0, timeout_s=10.0)
    collector.poll_once()
    server.start()
    try:
        yield first, second, core, server
    finally:
        server.stop()
        for e in engines:
            e.stop()


def test_stream_splice_resubmits_prompt_plus_delivered(scripted_pair):
    first, second, core, server = scripted_pair
    first.plan = [("tokens", [10]), ("tokens", [11]), "die"]
    second.plan = [("tokens", [12]), ("tokens", [13]), "done"]
    status, lines = _stream_through_router(server.port, {
        "prompts": [UNKEYED], "max_new_tokens": 4, "stream": True})
    assert status == 200
    assert lines == [{"tokens": [10]}, {"tokens": [11]},
                     {"tokens": [12]}, {"tokens": [13]},
                     {"done": True}]
    (replay,) = second.requests
    assert replay["prompts"] == [UNKEYED + [10, 11]]
    assert replay["max_new_tokens"] == 2
    assert core.stats()["failover"] == 1


def test_stream_splice_closes_clean_when_budget_spent(scripted_pair):
    first, second, core, server = scripted_pair
    first.plan = [("tokens", [10]), ("tokens", [11]), "die"]
    status, lines = _stream_through_router(server.port, {
        "prompts": [UNKEYED], "max_new_tokens": 2, "stream": True})
    assert status == 200
    assert lines == [{"tokens": [10]}, {"tokens": [11]},
                     {"done": True}]
    assert second.requests == []


def test_fatal_envelope_is_relayed_not_retried(scripted_pair):
    first, second, core, server = scripted_pair
    first.plan = [("tokens", [10]),
                  ("envelope", {"error": "boom", "retryable": False})]
    status, lines = _stream_through_router(server.port, {
        "prompts": [UNKEYED], "max_new_tokens": 4, "stream": True})
    assert status == 200   # headers were already streaming
    assert lines[0] == {"tokens": [10]}
    assert lines[-1]["error"] == "boom"
    assert second.requests == []
    assert core.stats()["failover"] == 0


def test_failover_exhausted_surfaces_envelope(scripted_pair):
    first, second, core, server = scripted_pair
    first.plan = [("tokens", [10]), "die"]
    second.plan = [("tokens", [11]), "die"]
    status, lines = _stream_through_router(server.port, {
        "prompts": [UNKEYED], "max_new_tokens": 8, "stream": True})
    assert status == 200
    assert lines[:2] == [{"tokens": [10]}, {"tokens": [11]}]
    tail = lines[-1]
    assert "failover exhausted" in tail["error"] and tail["retryable"]
    assert core.stats()["failover"] == 1
    assert core.stats()["shed"] == {"failover_exhausted": 1}


class _DyingResponse:
    """An upstream response that delivers one token line, then fails
    its next read the way a SIGKILLed engine surfaces in http.client."""

    status = 200

    def __init__(self, failure):
        self._lines = [b'{"tokens": [10]}\n']
        self._failure = failure
        self._router_conn = self

    def readline(self):
        if self._lines:
            return self._lines.pop(0)
        if self._failure is None:
            return b""
        raise self._failure

    def close(self):
        pass


@pytest.mark.parametrize("failure", [
    http.client.IncompleteRead(b"", 7), ConnectionResetError(104, "reset"),
    None], ids=["incomplete_read", "connection_reset", "empty_read"])
def test_engine_death_mid_stream_is_retryable(scripted_pair, failure):
    """Each way an engine's death reaches http.client mid-stream is a
    splice onto the sibling, never a relayed error."""
    first, second, core, server = scripted_pair
    second.plan = [("tokens", [12]), "done"]
    real_post = server._post_upstream

    def post(url, path, payload, headers=None):
        if url == first.url:
            return _DyingResponse(failure)
        return real_post(url, path, payload, headers=headers)

    server._post_upstream = post
    status, lines = _stream_through_router(server.port, {
        "prompts": [UNKEYED], "max_new_tokens": 4, "stream": True})
    assert status == 200
    assert lines == [{"tokens": [10]}, {"tokens": [12]}, {"done": True}]
    (replay,) = second.requests
    assert replay["prompts"] == [UNKEYED + [10]]
    assert core.stats()["failover"] == 1


def test_unary_failover_retries_on_sibling(scripted_pair):
    first, second, core, server = scripted_pair
    first.stop()   # a dead socket: the unary POST fails outright
    second.plan = [("tokens", [12]), "done"]
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=30)
    conn.request("POST", "/v1/models/lm:generate",
                 body=json.dumps({"prompts": [UNKEYED],
                                  "max_new_tokens": 2}).encode())
    resp = conn.getresponse()
    assert resp.status == 200
    conn.close()
    assert len(second.requests) == 1
    assert core.stats()["failover"] == 1


# ---------------------------------------------------------------------------
# request journeys: trace propagation + latency attribution
# ---------------------------------------------------------------------------


def _router_records(port, rid, timeout_s=10.0):
    """The router's /debug/requests payload once ``rid``'s journey
    record has landed: the handler retires the record just after the
    reply's last byte, so a read right after the reply can race it."""
    deadline = time.monotonic() + timeout_s
    while True:
        payload = json.load(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/requests", timeout=10))
        if any(r["request_id"] == rid for r in payload["records"]) \
                or time.monotonic() > deadline:
            return payload
        time.sleep(0.01)


def _event_count(name):
    return sum(1 for e in obs.TRACER.snapshot()["events"]
               if e.get("name") == name)


def test_splice_preserves_trace_and_request_id(scripted_pair):
    """One journey, one identity: the inbound carrier's trace id and
    request id ride BOTH hops of a mid-stream failover splice, and the
    router's journey record attributes the whole wall to named
    buckets including the splice."""
    first, second, core, server = scripted_pair
    first.plan = [("tokens", [10]), ("tokens", [11]), "die"]
    second.plan = [("tokens", [12]), ("tokens", [13]), "done"]
    inbound_ctx = (0xfeedface12345678, 0xabcdef01)
    failovers_before = _event_count("router.engine_failover")
    status, lines = _stream_through_router(
        server.port,
        {"prompts": [UNKEYED], "max_new_tokens": 4, "stream": True},
        headers=obs.inject_headers(inbound_ctx, request_id="jrny-01"))
    assert status == 200
    assert lines == [{"tokens": [10]}, {"tokens": [11]},
                     {"tokens": [12]}, {"tokens": [13]},
                     {"done": True}]
    (h1,), (h2,) = first.headers, second.headers
    for h in (h1, h2):
        assert h["x-cea-request-id"] == "jrny-01"
        ctx = obs.parse_traceparent(h["traceparent"])
        assert ctx is not None and ctx[0] == inbound_ctx[0]
    (rec,) = _router_records(server.port, "jrny-01")["records"]
    assert rec["request_id"] == "jrny-01"
    assert rec["trace_id"] == "%x" % inbound_ctx[0]
    assert rec["outcome"] == "completed"
    assert rec["engine"] == second.url     # where the stream ended
    assert rec["hops"] == 1
    assert rec["tokens"] == 4
    buckets = rec["buckets"]
    assert buckets["splice_resubmit"] > 0
    assert buckets["upstream_ttfb"] > 0
    assert sum(buckets.values()) == pytest.approx(
        rec["wall_s"], rel=0.01, abs=1e-4)
    assert _event_count("router.engine_failover") \
        == failovers_before + 1


def test_shed_journey_retires_with_cause(scripted_pair):
    """A shed is still a journey: the 429 retires a ledger record with
    the shed outcome, zero hops, and the adopted request id."""
    first, second, core, server = scripted_pair
    core.tenants = TenantLedger(rate=0.001, burst_s=1.0)
    conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                      timeout=30)
    conn.request("POST", "/v1/models/lm:generate",
                 body=json.dumps({"prompts": [UNKEYED],
                                  "max_new_tokens": 4,
                                  "tenant": "acme"}).encode(),
                 headers={"x-cea-request-id": "shed-01"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 429
    assert body["request_id"] == "shed-01"
    payload = _router_records(server.port, "shed-01")
    (rec,) = [r for r in payload["records"]
              if r["request_id"] == "shed-01"]
    assert rec["outcome"] == "shed_tenant_rate"
    assert rec["hops"] == 0 and rec["engine"] is None
    assert rec["tenant"] == "acme"
    assert payload["tenants"]["acme"]["requests"] == 1


def test_tenant_shed_episode_hysteresis():
    """A burst of tenant sheds emits ONE router.tenant_shed event; a
    quiet gap past episode_clear_s re-arms it; distinct tenants are
    independent episodes."""
    t = [0.0]
    _, core = make_core(
        FakeFleet(), tenants=TenantLedger(rate=1.0, burst_s=1.0),
        clock=lambda: t[0], episode_clear_s=5.0)
    before = _event_count("router.tenant_shed")
    for _ in range(3):
        d = core.route(UNKEYED, 100, tenant="acme")
        assert d["action"] == "shed" and d["reason"] == SHED_TENANT_RATE
        t[0] += 1.0
    assert _event_count("router.tenant_shed") == before + 1
    t[0] += 10.0
    core.route(UNKEYED, 100, tenant="acme")
    assert _event_count("router.tenant_shed") == before + 2
    core.route(UNKEYED, 100, tenant="zeta")
    assert _event_count("router.tenant_shed") == before + 3
    assert core.stats()["shed"] == {SHED_TENANT_RATE: 5}


# ---------------------------------------------------------------------------
# two real engines of the port: the failover splice is token-identical
# ---------------------------------------------------------------------------


def test_two_process_failover_stream_token_identical():
    """Two port engines (serving.fleet_worker --device cpu, one model
    seed), a SIGKILL mid-stream, and the spliced stream must equal the
    sibling's uninterrupted greedy decode."""
    tmpdir = tempfile.mkdtemp(prefix="torch_router_test_")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    max_new = 120
    procs, urls = [], []
    for i in range(2):
        port_file = os.path.join(tmpdir, f"e{i}.port")
        procs.append((subprocess.Popen(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.serving"
             ".fleet_worker", "--device", "cpu", "--port-file",
             port_file, "--seed", "0", "--max-seq-len", "256",
             "--max-new-tokens", str(max_new)],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL), port_file))
    collector = server = None
    try:
        deadline = time.monotonic() + 120
        for proc, port_file in procs:
            while not os.path.exists(port_file):
                assert proc.poll() is None, "engine died warming up"
                assert time.monotonic() < deadline, "warm-up timeout"
                time.sleep(0.1)
            with open(port_file) as f:
                urls.append(f"http://127.0.0.1:{f.read().strip()}")
        collector = FleetCollector(urls, poll_ms=250.0)
        core = RouterCore(collector, shed_sat=2.0,
                          tenants=TenantLedger(rate=0))
        server = RouterServer(core, collector, port=0)
        collector.start()
        server.start()
        prompt = [1, 2, 3, 4, 5]
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=120)
        conn.request("POST", "/v1/models/lm:generate",
                     body=json.dumps({"prompts": [prompt],
                                      "max_new_tokens": max_new,
                                      "stream": True}).encode())
        # The in-flight ledger names the engine holding the stream the
        # moment the router aims at it: kill it before it can finish.
        kill_deadline = time.monotonic() + 60
        while not core._inflight:
            assert time.monotonic() < kill_deadline
            time.sleep(0.001)
        (victim,) = list(core._inflight)
        sibling = next(u for u in urls if u != victim)
        next(p for (p, _), u in zip(procs, urls) if u == victim).kill()
        resp = conn.getresponse()
        assert resp.status == 200
        ref_conn = http.client.HTTPConnection(
            "127.0.0.1", int(sibling.rsplit(":", 1)[1]), timeout=120)
        ref_conn.request("POST", "/v1/models/lm:generate",
                         body=json.dumps({"prompts": [prompt],
                                          "max_new_tokens": max_new}
                                         ).encode())
        reference = json.loads(ref_conn.getresponse().read())[
            "sequences"][0][len(prompt):]
        ref_conn.close()
        tokens = []
        while True:
            raw = resp.readline()
            assert raw, "stream truncated without done"
            line = json.loads(raw)
            if line.get("done"):
                break
            assert "error" not in line, line
            tokens.extend(line["tokens"])
        conn.close()
        assert len(tokens) == max_new
        assert tokens == reference
        assert core.stats()["failover"] >= 1
    finally:
        if server is not None:
            server.stop()
        if collector is not None:
            collector.stop()
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
        for proc, _ in procs:
            proc.wait(timeout=15)


# ---------------------------------------------------------------------------
# Against the JAX package's RouterCore, on the same scripted fleet
# ---------------------------------------------------------------------------


def test_route_decisions_match_jax_router_core():
    """A seeded trace of 300 route() calls (four tenants under a
    weighted deficit ledger, shared and fresh prefixes, prompts with no
    key), in-flight churn, sibling picks and repoints, and saturation,
    queue-depth, readiness and liveness changes between polls: the
    port's RouterCore and the JAX package's, each over its own
    package's collector on the same fake fleet and clock, decide the
    same engine, reason, status and Retry-After at every call."""
    rng = np.random.default_rng(1234)
    fleet = FakeFleet(n=4)
    t = [0.0]

    def clock():
        return t[0]

    kw = collector_kwargs()
    cores = {}
    for name, fleet_mod, router_mod, tracer in (
            ("port", port_fleet, port_router, Tracer(enabled=True)),
            ("jax", jax_fleet, jax_router, jax_obs.Tracer(enabled=True))):
        coll = fleet_mod.FleetCollector(
            fleet.urls, tracer=tracer, fetch=fleet.fetch,
            clock=fleet.clock, **kw)
        coll.poll_once()
        cores[name] = router_mod.RouterCore(
            coll, block_size=BS, shed_sat=0.9, affinity_blocks=2,
            affinity_cap=12, failover_max=2, spill_bound=2,
            tenants=router_mod.TenantLedger(
                rate=40.0, burst_s=2.0,
                weights={"gold": 3.0, "lead": 0.5}, clock=clock),
            clock=clock)
    prefixes = [rng.integers(1, 40, 8).tolist() for _ in range(10)]
    tenants = ["gold", "lead", "std", None]
    inflight = []
    seen = {"route": 0, "shed": 0}
    reasons = set()
    for step in range(300):
        t[0] += float(rng.exponential(0.2))
        if step % 15 == 0:
            for url in fleet.urls:
                eng = fleet.engines[url]
                sat = float(np.round(rng.random() ** 2, 3))
                eng["saturation"] = _sat(sat)
                eng["queue_depth"] = (None if rng.random() < 0.1
                                      else int(rng.integers(0, 7)))
                eng["ready"] = rng.random() > 0.1
                eng["alive"] = rng.random() > 0.05
                if step // 15 in (5, 11):      # a drained fleet
                    eng["ready"] = False
                elif step // 15 == 8:          # a saturated fleet
                    eng["saturation"] = _sat(0.95)
            fleet.now += 1.0
            for core in cores.values():
                core._collector.poll_once()
        kind = rng.random()
        if kind < 0.6:
            prompt = (prefixes[int(rng.integers(0, 10))]
                      + rng.integers(1, 40, int(rng.integers(0, 5))
                                     ).tolist())
        elif kind < 0.8:
            prompt = rng.integers(1, 40, int(rng.integers(8, 14))).tolist()
        else:
            prompt = rng.integers(1, 40, int(rng.integers(1, 4))).tolist()
        cost = len(prompt) + int(rng.integers(1, 40))
        tenant = tenants[int(rng.integers(0, 4))]
        decisions = {k: c.route(prompt, cost, tenant)
                     for k, c in cores.items()}
        assert decisions["port"] == decisions["jax"], step
        d = decisions["port"]
        seen[d["action"]] += 1
        reasons.add(d["reason"])
        if d["action"] == "route" and rng.random() < 0.7:
            inflight.append(d["url"])
            for c in cores.values():
                c.inflight_begin(d["url"])
        if inflight and rng.random() < 0.5:
            url = inflight.pop(int(rng.integers(0, len(inflight))))
            for c in cores.values():
                c.inflight_end(url)
        if d["action"] == "route" and rng.random() < 0.1:
            sibs = {k: c.sibling({d["url"]}) for k, c in cores.items()}
            assert sibs["port"] == sibs["jax"], step
            for k, c in cores.items():
                c.note_failover("stream", engine=d["url"])
                c.repoint(d["key"], sibs[k])
    assert cores["port"].stats() == cores["jax"].stats()
    assert cores["port"].affinity_snapshot() \
        == cores["jax"].affinity_snapshot()
    # The trace reached every branch it is meant to compare.
    assert seen["route"] >= 100 and seen["shed"] >= 10, seen
    assert {REASON_AFFINITY, REASON_LEAST_LOADED, REASON_HEDGE,
            REASON_SPILL, SHED_TENANT_RATE, SHED_NO_ENGINES,
            SHED_SATURATED} <= reasons, \
        reasons

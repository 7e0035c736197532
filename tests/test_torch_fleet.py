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

"""A mixed fleet: one JAX engine and one engine of the port behind the
JAX package's unchanged ``serving/router.py`` and
``obs/fleet.FleetCollector``, and behind the port's own router and
collector, both engines on the same f32 weights
(``init_flax_layout_params``).

Greedy streams are token-identical whichever engine serves them; a
SIGKILL of the port's worker mid-stream splices onto the JAX engine
token-identical, and the reverse; the collector reads the port's
/stats, /metrics and /readyz (``requests_retired``, the TTFT buckets,
the drain state); and the router's ``traceparent`` parents the port's
``serving.request`` span, with the request id carried through. The
port's router gives the same greedy streams, and the same SIGKILL
splices in both directions, as the JAX router on the same fleet."""

import http.client
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.models import TransformerLM
from container_engine_accelerators_tpu.obs.fleet import (
    FleetCollector,
    histograms_from_text,
)
from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu.serving.affinity import affinity_key
from container_engine_accelerators_tpu.serving.router import (
    RouterCore,
    RouterServer,
    TenantLedger,
)
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.obs import fleet as port_fleet
from container_engine_accelerators_tpu_torch.serving import (
    affinity as port_affinity,
)
from container_engine_accelerators_tpu_torch.serving import (
    router as port_router,
)
from container_engine_accelerators_tpu_torch.serving import server
from tests.conftest import REPO_ROOT

SEED = 0
CONFIG = dict(vocab_size=48, embed_dim=32, num_layers=2, num_heads=4,
              max_seq_len=256)
MAX_NEW = 200     # long enough that a kill lands mid-stream
MAX_BATCH = 4
WORKER_FLAGS = ["--seed", str(SEED), "--vocab-size", "48",
                "--embed-dim", "32", "--num-layers", "2", "--num-heads",
                "4", "--max-seq-len", "256", "--max-new-tokens",
                str(MAX_NEW), "--max-batch", str(MAX_BATCH)]


@pytest.fixture(scope="module")
def workers():
    """One port worker and one JAX worker in subprocesses, started
    together at module set-up (they warm up while the in-process
    engines do); each test that kills one waits for its port file."""
    tmpdir = tempfile.mkdtemp(prefix="torch_fleet_")
    # One compute thread each: the workers run beside other test
    # files' processes.
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT,
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    procs = {}
    port_cmd = [sys.executable, "-m",
                "container_engine_accelerators_tpu_torch.serving"
                ".fleet_worker", "--device", "cpu"]
    jax_cmd = [sys.executable,
               os.path.join(REPO_ROOT, "tests", "torch_fleet_worker.py")]
    # "torch" and "jax" die behind the JAX router; the _j and _p pairs
    # die behind the JAX router and the port's in the same test.
    for name, cmd in (("torch", port_cmd), ("jax", jax_cmd),
                      ("torch_j", port_cmd), ("torch_p", port_cmd),
                      ("jax_j", jax_cmd), ("jax_p", jax_cmd)):
        port_file = os.path.join(tmpdir, f"{name}.port")
        procs[name] = (subprocess.Popen(
            cmd + ["--port-file", port_file] + WORKER_FLAGS, env=env,
            cwd=REPO_ROOT, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL), port_file)
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
    for proc, _ in procs.values():
        proc.wait(timeout=30)


def _worker_url(workers, name):
    proc, port_file = workers[name]
    deadline = time.monotonic() + 120
    while not os.path.exists(port_file):
        assert proc.poll() is None, f"{name} worker died warming up"
        assert time.monotonic() < deadline, f"{name} worker warm-up"
        time.sleep(0.1)
    with open(port_file) as f:
        return proc, f"http://127.0.0.1:{f.read().strip()}"


@pytest.fixture(scope="module")
def tree():
    return convert.init_flax_layout_params(CONFIG, SEED)


@pytest.fixture(scope="module")
def jax_engine(workers, tree):
    srv = jax_server.GenerationServer(
        "lm", TransformerLM(dtype=jnp.float32, **CONFIG), tree, port=0,
        max_new_tokens=MAX_NEW, max_batch=MAX_BATCH, warm=True)
    srv.start()
    yield srv, f"http://127.0.0.1:{srv.port}"
    srv.stop()


@pytest.fixture(scope="module")
def torch_engine(workers, tree):
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    model = convert.load_lm(CONFIG, tree, device="cpu",
                            dtype=torch.float32)
    srv = server.GenerationServer("lm", model, port=0,
                                  max_new_tokens=MAX_NEW,
                                  max_batch=MAX_BATCH, warm=True,
                                  host="127.0.0.1")
    srv.start()
    yield srv, f"http://127.0.0.1:{srv.port}"
    srv.stop()
    torch.set_num_threads(prev)


class _Fleet:
    """A collector and a router over ``urls``: the JAX package's, or
    with ``port=True`` the port's own."""

    def __init__(self, urls, port=False):
        collector_cls, router_mod = (
            (port_fleet.FleetCollector, port_router) if port
            else (FleetCollector, None))
        core_cls, server_cls, ledger_cls = (
            (router_mod.RouterCore, router_mod.RouterServer,
             router_mod.TenantLedger) if port
            else (RouterCore, RouterServer, TenantLedger))
        self.key_fn = port_affinity.affinity_key if port else affinity_key
        self.collector = collector_cls(urls, poll_ms=100.0)
        self.core = core_cls(self.collector, shed_sat=2.0,
                             tenants=ledger_cls(rate=0))
        self.router = server_cls(self.core, self.collector, port=0)
        self.collector.start()
        self.router.start()

    def steer(self, prompt, url):
        """Pin ``prompt``'s affinity key to ``url`` (the router then
        places it there)."""
        key = self.key_fn(prompt, self.core.block_size,
                          self.core.affinity_blocks)
        assert key is not None
        self.core.repoint(key, url)

    def open_stream(self, prompt, new, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.router.port,
                                          timeout=120)
        conn.request("POST", "/v1/models/lm:generate",
                     body=json.dumps({"prompts": [prompt],
                                      "max_new_tokens": new,
                                      "stream": True}).encode(),
                     headers=headers or {})
        resp = conn.getresponse()
        assert resp.status == 200
        return conn, resp

    def stream(self, prompt, new, headers=None):
        conn, resp = self.open_stream(prompt, new, headers)
        tokens = _read_tokens(resp)
        conn.close()
        return tokens

    def stop(self):
        self.router.stop()
        self.collector.stop()


def _read_tokens(resp, first=()):
    tokens = list(first)
    while True:
        raw = resp.readline()
        assert raw, "stream truncated without done"
        line = json.loads(raw)
        if line.get("done"):
            return tokens
        assert "error" not in line, line
        tokens.extend(line["tokens"])


def _unary(url, prompt, new):
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    conn.request("POST", "/v1/models/lm:generate",
                 body=json.dumps({"prompts": [prompt],
                                  "max_new_tokens": new}).encode())
    out = json.loads(conn.getresponse().read())
    conn.close()
    return out["sequences"][0][len(prompt):]


def _wait_requests(srv, n):
    """Wait until ``srv`` counts ``n`` requests: a stream's handler
    counts it once the last line is written, just after the client
    has read it."""
    deadline = time.monotonic() + 30
    while srv.stats()["requests"] < n:
        assert time.monotonic() < deadline, srv.stats()["requests"]
        time.sleep(0.01)
    return srv.stats()["requests"] == n


def _prompt(seed, n):
    return [(seed * 7 + 3 * i) % CONFIG["vocab_size"] for i in range(n)]


def test_greedy_streams_identical_whichever_engine(jax_engine,
                                                   torch_engine):
    (jsrv, jurl), (tsrv, turl) = jax_engine, torch_engine
    fleet = _Fleet([jurl, turl])
    try:
        for seed, n, new in ((1, 16, 24), (2, 21, 40), (3, 40, 64)):
            prompt = _prompt(seed, n)
            got = {}
            for name, srv, url in (("jax", jsrv, jurl),
                                   ("torch", tsrv, turl)):
                before = srv.stats()["requests"]
                fleet.steer(prompt, url)
                got[name] = fleet.stream(prompt, new)
                assert _wait_requests(srv, before + 1), name
            assert got["jax"] == got["torch"]
            assert len(got["jax"]) == new
            assert got["torch"] == _unary(turl, prompt, new)
    finally:
        fleet.stop()


def _splice(fleet, victim_proc, victim_url, sibling_url, prompt):
    """Stream ``prompt`` through the router to the victim, SIGKILL it
    after the first token line, and read the spliced rest."""
    fleet.steer(prompt, victim_url)
    conn, resp = fleet.open_stream(prompt, MAX_NEW)
    first = json.loads(resp.readline())
    assert first.get("tokens"), first
    victim_proc.kill()
    victim_proc.wait(timeout=30)
    tokens = _read_tokens(resp, first["tokens"])
    conn.close()
    assert fleet.core.stats()["failover"] >= 1
    return tokens


def test_sigkill_of_the_port_worker_splices_onto_jax(workers, jax_engine):
    jsrv, jurl = jax_engine
    proc, turl = _worker_url(workers, "torch")
    fleet = _Fleet([jurl, turl])
    try:
        prompt = _prompt(5, 24)
        assert _unary(turl, prompt, 8) == _unary(jurl, prompt, 8)
        tokens = _splice(fleet, proc, turl, jurl, prompt)
        assert tokens == _unary(jurl, prompt, MAX_NEW)
    finally:
        fleet.stop()


def test_sigkill_of_the_jax_worker_splices_onto_the_port(workers,
                                                         torch_engine):
    tsrv, turl = torch_engine
    proc, jurl = _worker_url(workers, "jax")
    fleet = _Fleet([jurl, turl])
    try:
        prompt = _prompt(6, 24)
        before = tsrv.stats()["requests"]
        tokens = _splice(fleet, proc, jurl, turl, prompt)
        assert _wait_requests(tsrv, before + 1)
        assert tokens == _unary(turl, prompt, MAX_NEW)
    finally:
        fleet.stop()


def test_collector_reads_the_ports_surfaces(jax_engine, torch_engine):
    (_, jurl), (tsrv, turl) = jax_engine, torch_engine
    _unary(turl, _prompt(9, 17), 4)
    collector = FleetCollector([jurl, turl], poll_ms=100.0)
    view = collector.poll_once()
    (mine,) = [e for e in view.engines if e["url"] == turl]
    assert mine["ready"] and mine["state"] == "serving"
    assert isinstance(mine["requests_retired"], int)
    assert mine["requests_retired"] >= 1
    assert mine["engine_id"] == tsrv.stats()["engine_id"]
    assert mine["requests"]["retired_total"] >= 1
    assert turl in view.steer_set()
    with urllib.request.urlopen(turl + "/metrics", timeout=30) as resp:
        hists = histograms_from_text(resp.read().decode())
    ttft = [h for (name, _), h in hists.items()
            if name == "tpu_serving_ttft_seconds"]
    assert ttft and sum(h.count for h in ttft) >= 1
    assert view.ttft.count >= 1
    tsrv.begin_drain()
    try:
        view = collector.poll_once()
        (mine,) = [e for e in view.engines if e["url"] == turl]
        assert not mine["ready"] and mine["state"] == "draining"
        assert mine["retry_after_s"] >= 1
        assert turl not in view.steer_set()
        assert jurl in view.steer_set()
    finally:
        tsrv._draining = False
    assert set(collector.poll_once().steer_set()) == {jurl, turl}


def test_router_traceparent_parents_the_ports_span(jax_engine,
                                                    torch_engine):
    (_, jurl), (tsrv, turl) = jax_engine, torch_engine
    fleet = _Fleet([jurl, turl])
    trace_id, rid = 0x5EED0000C0FFEE, "journey-42"
    try:
        prompt = _prompt(11, 18)
        fleet.steer(prompt, turl)
        headers = jax_obs.inject_headers((trace_id, 0xABC), rid)
        fleet.stream(prompt, 6, headers)
    finally:
        fleet.stop()
    spans = [s for s in obs.TRACER.snapshot()["spans"]
             if s["name"] == "serving.request"
             and s["trace_id"] == trace_id]
    assert len(spans) == 1
    (span,) = spans
    assert span["attrs"]["request_id"] == rid
    router_spans = {s["span_id"]: s for s in
                    jax_obs.TRACER.snapshot()["spans"]
                    if s["trace_id"] == trace_id}
    assert span["parent_id"] in router_spans
    assert router_spans[span["parent_id"]]["name"].startswith("router.")
    records = tsrv._engine_service.debug_requests()["records"]
    assert any(r["request_id"] == rid and r["trace_id"] == "%x" % trace_id
               for r in records)


def test_port_router_greedy_streams_match_the_jax_router(jax_engine,
                                                        torch_engine):
    """The same prompts steered to each engine through the JAX router
    and through the port's give the same greedy streams."""
    (jsrv, jurl), (tsrv, turl) = jax_engine, torch_engine
    fleets = {"jax": _Fleet([jurl, turl]),
              "port": _Fleet([jurl, turl], port=True)}
    try:
        for seed, n, new in ((21, 16, 24), (22, 33, 48)):
            prompt = _prompt(seed, n)
            for srv, url in ((jsrv, jurl), (tsrv, turl)):
                got = {}
                for name, fleet in fleets.items():
                    before = srv.stats()["requests"]
                    fleet.steer(prompt, url)
                    got[name] = fleet.stream(prompt, new)
                    assert _wait_requests(srv, before + 1), name
                assert got["port"] == got["jax"], url
                assert len(got["port"]) == new
    finally:
        for fleet in fleets.values():
            fleet.stop()


@pytest.mark.parametrize("victim", ["torch", "jax"])
def test_port_router_sigkill_splices_match_the_jax_router(
        workers, jax_engine, torch_engine, victim):
    """A SIGKILL of a worker mid-stream splices onto the in-process
    engine of the other kind: the port's router delivers the same
    tokens as the JAX router on the same fleet, and both equal the
    sibling's uninterrupted answer."""
    sibling_srv, sibling_url = (jax_engine if victim == "torch"
                                else torch_engine)
    prompt = _prompt(31 if victim == "torch" else 32, 24)
    got = {}
    for name in ("jax", "port"):
        proc, victim_url = _worker_url(workers, f"{victim}_{name[0]}")
        fleet = _Fleet([sibling_url, victim_url], port=name == "port")
        try:
            before = sibling_srv.stats()["requests"]
            got[name] = _splice(fleet, proc, victim_url, sibling_url,
                                prompt)
            assert _wait_requests(sibling_srv, before + 1), name
        finally:
            fleet.stop()
    assert got["port"] == got["jax"]
    assert len(got["port"]) == MAX_NEW
    assert got["port"] == _unary(sibling_url, prompt, MAX_NEW)

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

"""Serving survivability of the port, case for case with the JAX
package's tests/test_survivability.py: quarantine, rebuild and replay
after a step, prefill or hydrate fault; the circuit breaker; drain; the
FIFO cancel purge; the bare (unsupervised) failure path; /readyz and
the stream error envelope over HTTP. Faults go through the port's
``CEA_TPU_FAULT_PLAN`` seam at the JAX engine's sites, on the same f32
weights as the JAX model (converted from one numpy init): every
replayed greedy stream equals the JAX package's uninterrupted decode(),
and the same plan on the same trace fires at the same invocation and
leaves the same counters in both services."""

import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu.utils import faults as jax_faults
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.serving import server
from container_engine_accelerators_tpu_torch.serving.server import (
    _Admission,
    _EngineService,
    _EngineWork,
)
from container_engine_accelerators_tpu_torch.utils import faults
from tests import torch_parity
from tests.conftest import REPO_ROOT

LM = dict(vocab_size=48, embed_dim=32, num_layers=2, num_heads=4,
          max_seq_len=32)


@pytest.fixture(autouse=True)
def _reset_faults():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lm():
    """(flax model, numpy params, the port's model): the JAX test's
    shape, f32."""
    model, tree, config = torch_parity.flax_lm_of(seed=1, **LM)
    return model, tree, torch_parity.port_lm(config, tree)


def _factory(model, slots=3, slot_len=20, **kw):
    def build():
        return decode.SlotDecodeEngine(
            model, slots, slot_len, paged=kw.get("paged", True),
            kv_block_size=4, buckets=[8, 16], kv_quant="bf16",
            kv_spill=False, **{k: v for k, v in kw.items()
                               if k != "paged"})
    return build


def _jax_factory(model, params, slots=3, slot_len=20):
    def build():
        return jax_decode.SlotDecodeEngine(
            model, params, slots=slots, slot_len=slot_len, paged=True,
            kv_block_size=4, buckets=[8, 16], kv_quant="bf16",
            kv_spill=False)
    return build


def _hydrate_factory(model):
    """The JAX chaos check's hydrate geometry: one slot and a tiny
    arena, so a retired row's registered blocks move to the host tier
    and a repeat prompt rehydrates at admission."""
    def build():
        return decode.SlotDecodeEngine(
            model, 1, 16, paged=True, kv_block_size=4, kv_blocks=5,
            buckets=[8], kv_quant="bf16", kv_spill=True,
            kv_spill_bytes=1 << 20)
    return build


def _work(prompt, p_len, new, seed=0, cls=_EngineWork, **kw):
    row = np.zeros((max(8, p_len),), np.int32)
    row[:p_len] = prompt[:p_len]
    return cls(row, p_len, new, 0.0, 0, 1.0, 0.0, 1.0, -1, False, seed,
               None, **kw)


def _pool_is_clean(eng):
    pool = eng._pool
    pinned = set(eng._pinned)
    return (pool.free_count() == pool.usable - len(pinned)
            and pool.shared_count() == 0
            and pool.committed == 0
            and bool((eng._tables == eng._trash).all())
            and int(np.abs(pool.ref).sum()) == len(pinned))


def _events(name):
    return [e for e in obs.TRACER.snapshot()["events"]
            if e["name"] == name]


def _greedy_ref(model, params, prompts, news):
    """The JAX package's uninterrupted greedy decode()."""
    width = max(len(p) for p in prompts)
    padded = np.zeros((len(prompts), width), np.int32)
    p_lens = np.zeros((len(prompts),), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = p
        p_lens[i] = len(p)
    ref = np.asarray(jax_decode.decode(
        model, params, jnp.asarray(padded), max(news), prompt_len=p_lens,
        fast_prefill=False))
    return [ref[i, len(p):len(p) + n].tolist()
            for i, (p, n) in enumerate(zip(prompts, news))]


def _warm(svc, width=8, cls=_EngineWork):
    work = _work(np.zeros((width,), np.int32), width, 2, cls=cls,
                 account=False, no_prefix=True)
    assert svc.submit_many([work]) is not None
    status, out = work.done.get(timeout=600)
    assert status == "ok", out
    svc.reset_counters()


def _run(svc, works):
    assert svc.submit_many(works) is not None
    for w in works:
        status, out = w.done.get(timeout=600)
        assert status == "ok", out


PROMPTS = [np.array([5, 6, 7, 8], np.int32),
           np.array([9, 8, 7, 6, 5], np.int32),
           np.array([11, 12, 13], np.int32)]
NEWS = [6, 5, 6]


def test_step_fault_quarantines_rebuilds_and_replays(lm):
    """A step failure quarantines the engine, rebuilds it through the
    factory and replays every in-flight row as a forced prefix: the
    streams equal the JAX decode(), the stall lands in `recovery`
    (buckets still sum to wall), the rebuilt pool is clean, and exactly
    one quarantine/recovered event pair is recorded, naming the
    InjectedFault."""
    model, params, pm = lm
    q0, r0 = len(_events("serving.engine_quarantine")), len(
        _events("serving.engine_recovered"))
    svc = _EngineService(_factory(pm)(), _Admission(0),
                         engine_factory=_factory(pm))
    try:
        _warm(svc)
        faults.install({"step": [2]})
        works = [_work(p, len(p), n, seed=i)
                 for i, (p, n) in enumerate(zip(PROMPTS, NEWS))]
        _run(svc, works)
        faults.reset()
        ref = _greedy_ref(model, params, PROMPTS, NEWS)
        for w, want in zip(works, ref):
            assert w.tokens == want
        stats = svc.stats()
        assert stats["engine_state"] == "serving"
        assert stats["engine_rebuilds"] == 1
        assert stats["quarantine_episodes"] == 1
        assert stats["replayed_rows"] == 3
        quarantines = _events("serving.engine_quarantine")[q0:]
        assert len(quarantines) == 1
        assert quarantines[0]["fields"]["error_type"] == "InjectedFault"
        assert len(_events("serving.engine_recovered")) - r0 == 1
        records = svc.debug_requests()["records"]
        assert sum(r["buckets"]["recovery"] for r in records) > 0
        for rec in records:
            total = sum(rec["buckets"].values())
            assert abs(total - rec["wall_s"]) <= max(
                0.01 * rec["wall_s"], 2e-5), rec
        assert _pool_is_clean(svc.engine)
    finally:
        svc.stop()


_PARITY_PLANS = [{"step": [2]}, {"prefill": [1]}, {"step": [0, 4]}]


@pytest.mark.parametrize("plan", _PARITY_PLANS,
                         ids=["step2", "prefill1", "step0_4"])
def test_fault_plan_fires_where_the_jax_engine_does(lm, plan):
    """The same plan on the same trace, through the JAX service and the
    port's: the faults fire at the same invocations, every op is
    counted the same number of times, the streams are identical and the
    lifecycle counters agree."""
    model, params, pm = lm
    out = []
    for mod, svc_mod, factory, cls in (
            (faults, server, _factory(pm), _EngineWork),
            (jax_faults, jax_server, _jax_factory(model, params),
             jax_server._EngineWork)):
        svc = svc_mod._EngineService(factory(), svc_mod._Admission(0),
                                     engine_factory=factory)
        try:
            _warm(svc, cls=cls)
            fault_plan = mod.install(plan)
            works = [_work(p, len(p), n, seed=i, cls=cls)
                     for i, (p, n) in enumerate(zip(PROMPTS, NEWS))]
            _run(svc, works)
            mod.reset()
            stats = svc.stats()
            out.append(dict(
                tokens=[w.tokens for w in works],
                counts=fault_plan.counts(), fired=fault_plan.fired(),
                stats={k: stats[k] for k in (
                    "engine_rebuilds", "quarantine_episodes",
                    "replayed_rows", "replayed_tokens",
                    "requests_admitted", "requests_retired")}))
        finally:
            svc.stop()
    assert out[0] == out[1]
    assert out[0]["fired"]


def test_prefill_fault_replays_with_zero_generated_tokens(lm):
    """An admission-time failure: the failing row (no tokens yet)
    replays as a plain admission and still matches decode()."""
    model, params, pm = lm
    svc = _EngineService(_factory(pm)(), _Admission(0),
                         engine_factory=_factory(pm))
    try:
        _warm(svc)
        faults.install({"prefill": [0]})
        prompt = np.array([3, 1, 4, 1], np.int32)
        work = _work(prompt, 4, 5)
        _run(svc, [work])
        faults.reset()
        assert work.tokens == _greedy_ref(model, params, [prompt], [5])[0]
        assert svc.stats()["engine_rebuilds"] == 1
        assert _pool_is_clean(svc.engine)
    finally:
        svc.stop()


def test_hydrate_fault_replays_on_the_rebuilt_arena(lm):
    """The chaos check's hydrate episode: A, two fillers that push A's
    registered blocks into the host tier, then A again, whose admission
    rehydrates and faults mid-upload; the replay re-prefills on the
    rebuilt (empty) arena, token-identical to decode()."""
    model, params, pm = lm
    trace = [np.array([1, 2, 3, 4, 5, 6], np.int32),
             np.array([9, 8, 7, 6, 5, 4], np.int32),
             np.array([11, 12, 13, 14, 15, 16], np.int32)]
    ref = _greedy_ref(model, params, trace, [2, 2, 2])
    factory = _hydrate_factory(pm)
    svc = _EngineService(factory(), _Admission(0), engine_factory=factory)
    q0 = len(_events("serving.engine_quarantine"))
    try:
        _warm(svc)
        for i, prompt in enumerate(trace):
            work = _work(prompt, 6, 2, seed=i)
            _run(svc, [work])
            assert work.tokens == ref[i]
        assert svc.engine.kv_block_stats()["kv_spill_blocks"] > 0
        svc.reset_counters()
        plan = faults.install({"hydrate": [0]})
        work = _work(trace[0], 6, 2)
        _run(svc, [work])
        assert plan.fired() == {"hydrate": [0]}
        faults.reset()
        assert work.tokens == ref[0]
        stats = svc.stats()
        assert stats["engine_rebuilds"] == 1
        (event,) = _events("serving.engine_quarantine")[q0:]
        assert event["fields"]["reason"] == "prefill"
        assert event["fields"]["error_type"] == "InjectedFault"
        assert _pool_is_clean(svc.engine)
    finally:
        svc.stop()


def test_dense_pool_step_fault_replays_the_delivered_prefix(lm):
    """On the dense pool (whose admission prefill is the flash kernel's
    path on the card) a step fault replays each row as one admission of
    its prompt plus its delivered tokens: the rebuilt engine prefills
    those widths and the streams equal decode()."""
    model, params, pm = lm
    factory = _factory(pm, paged=False)
    svc = _EngineService(factory(), _Admission(0), engine_factory=factory)
    try:
        _warm(svc)
        faults.install({"step": [2]})
        works = [_work(p, len(p), n, seed=i)
                 for i, (p, n) in enumerate(zip(PROMPTS, NEWS))]
        _run(svc, works)
        faults.reset()
        for w, want in zip(works, _greedy_ref(model, params, PROMPTS,
                                              NEWS)):
            assert w.tokens == want
        # Admission + two steps: three tokens delivered a row.
        assert dict(svc.engine.prefill_widths) == {
            len(p) + 3: 1 for p in PROMPTS}
        assert svc.stats()["replayed_tokens"] == sum(
            len(p) + 3 for p in PROMPTS)
        assert svc.engine.pool_leak_report() is None
    finally:
        svc.stop()


def test_spec_episode_keeps_the_draft_counters_consistent(lm):
    """A self-draft engine with a mid-verify step fault: the streams
    equal decode(), the dead engine's speculation counters fold into
    the service (draft_prefills = admissions + replayed rows), accepted
    never exceeds proposed, and pool and draft arena are clean."""
    model, params, pm = lm
    factory = _factory(pm, slot_len=24, draft_model=pm, spec_k=3)
    svc = _EngineService(factory(), _Admission(0), engine_factory=factory)
    try:
        _warm(svc)
        faults.install({"step": [1]})
        news = [8, 8, 8]
        works = [_work(p, len(p), n, seed=i)
                 for i, (p, n) in enumerate(zip(PROMPTS, news))]
        _run(svc, works)
        faults.reset()
        for w, want in zip(works, _greedy_ref(model, params, PROMPTS,
                                              news)):
            assert w.tokens == want
        stats = svc.stats()
        assert stats["engine_rebuilds"] == 1
        assert stats["draft_prefills"] == 3 + stats["replayed_rows"]
        assert stats["replayed_rows"] == 3
        assert stats["spec_accepted_tokens"] <= \
            stats["spec_proposed_tokens"]
        assert stats["spec_steps"] > 0
        assert svc.engine.pool_leak_report() is None
    finally:
        svc.stop()


def test_circuit_breaker_trips_sheds_and_reopens(lm, monkeypatch):
    """Repeated rebuild failures: retries with backoff, then the breaker
    opens (submissions shed, retry_after advertised, streams failed
    retryable), and a later successful probe closes it; one
    quarantine/recovered pair for the whole episode."""
    monkeypatch.setenv("CEA_TPU_ENGINE_REBUILD_RETRIES", "2")
    monkeypatch.setenv("CEA_TPU_ENGINE_REBUILD_BACKOFF_MS", "20")
    _, _, pm = lm
    q0, r0 = len(_events("serving.engine_quarantine")), len(
        _events("serving.engine_recovered"))
    good = _factory(pm)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if 2 <= calls["n"] <= 4:  # both retries and the first probe
            raise RuntimeError("factory down")
        return good()

    svc = _EngineService(flaky(), _Admission(0), engine_factory=flaky)
    try:
        _warm(svc)
        faults.install({"step": [0]})
        stream_q = queue.Queue()
        work = _work(np.array([5, 6, 7, 8], np.int32), 4, 6,
                     stream_q=stream_q)
        assert svc.submit_many([work]) is not None
        while True:
            item = stream_q.get(timeout=120)
            if item[0] != "tok":
                break
        faults.reset()
        assert item[0] == "error" and item[2] is True
        assert svc.engine_state() == "breaker_open"
        assert svc.retry_after_s() >= 1
        assert not svc.ready()
        assert svc.submit_many([_work(np.arange(1, 4), 3, 2)]) is None
        deadline = time.monotonic() + 30
        while (svc.engine_state() != "serving"
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert svc.engine_state() == "serving"
        work2 = _work(np.array([9, 8, 7], np.int32), 3, 3)
        _run(svc, [work2])
        assert len(_events("serving.engine_quarantine")) - q0 == 1
        assert len(_events("serving.engine_recovered")) - r0 == 1
    finally:
        svc.stop()


def test_a_row_that_keeps_failing_is_given_up(lm, monkeypatch):
    """A fault that follows the row and not the engine (every admission
    of it fails): after CEA_TPU_ENGINE_REBUILD_RETRIES replays the row
    fails retryably instead of quarantining forever, and the service
    serves the next row."""
    monkeypatch.setenv("CEA_TPU_ENGINE_REBUILD_RETRIES", "2")
    _, _, pm = lm
    svc = _EngineService(_factory(pm)(), _Admission(0),
                         engine_factory=_factory(pm))
    try:
        _warm(svc)
        faults.install({"prefill": [0, 1, 2]})
        work = _work(np.array([5, 6, 7], np.int32), 3, 4)
        assert svc.submit_many([work]) is not None
        status, out = work.done.get(timeout=120)
        assert status == "error" and "retry later" in out
        faults.reset()
        # The third episode still rebuilds (with nothing to replay).
        deadline = time.monotonic() + 30
        while (svc.stats()["engine_rebuilds"] < 3
               and time.monotonic() < deadline):
            time.sleep(0.01)
        stats = svc.stats()
        assert stats["quarantine_episodes"] == 3
        assert stats["engine_rebuilds"] == 3
        assert svc.engine_state() == "serving"
        work2 = _work(np.array([9, 8, 7], np.int32), 3, 3)
        _run(svc, [work2])
        assert _pool_is_clean(svc.engine)
    finally:
        svc.stop()


def test_cancelled_queued_request_purged_before_prefill(lm):
    """A client that leaves while QUEUED is dropped from the FIFO
    without being prefilled, its admission budget released at once."""
    _, _, pm = lm
    factory = _factory(pm, slots=1)
    svc = _EngineService(factory(), _Admission(3), engine_factory=factory)
    try:
        _warm(svc)
        w1 = _work(np.array([5, 6, 7, 8], np.int32), 4, 12, seed=0)
        w2 = _work(np.array([1, 2, 3], np.int32), 3, 4, seed=1)
        w3 = _work(np.array([9, 9, 9], np.int32), 3, 4, seed=2)
        for w in (w1, w2, w3):
            assert svc.submit_many([w]) is not None
        assert svc.submit_many([_work(np.arange(1, 4), 3, 2)]) is None
        prefills_before = svc.stats()["engine_prefills"]
        w3.cancel.set()
        status, out = w3.done.get(timeout=120)
        assert status == "error" and out == "cancelled"
        w4 = _work(np.array([4, 4, 4], np.int32), 3, 2, seed=3)
        assert svc.submit_many([w4]) is not None
        for w in (w1, w2, w4):
            status, out = w.done.get(timeout=600)
            assert status == "ok", out
        assert svc.stats()["engine_prefills"] - prefills_before <= 3
        rec = [r for r in svc.debug_requests()["records"]
               if r["outcome"] == "cancelled"]
        assert len(rec) == 1
        assert rec[0]["buckets"]["prefill"] == 0.0
    finally:
        svc.stop()


def test_drain_completes_inflight_and_sheds_new(lm):
    """Drain: in-flight work runs to completion within the grace
    window; submissions after begin_drain shed; readiness flips at
    once."""
    _, _, pm = lm
    factory = _factory(pm)
    svc = _EngineService(factory(), _Admission(0), engine_factory=factory)
    try:
        _warm(svc)
        work = _work(np.array([7, 7, 2, 9], np.int32), 4, 8)
        assert svc.submit_many([work]) is not None
        assert svc.drain(grace_s=120) is True
        assert not svc.ready()
        assert svc.engine_state() == "draining"
        status, out = work.done.get(timeout=10)
        assert status == "ok", out
        assert svc.submit_many([_work(np.arange(1, 4), 3, 2)]) is None
    finally:
        svc.stop()


def test_bare_step_failure_releases_and_audits_pool(lm):
    """Without a factory a step failure fails the in-flight work
    (retryable), releases every slot, block and reservation, and the
    same engine keeps serving."""
    _, _, pm = lm
    eng = _factory(pm)()
    svc = _EngineService(eng, _Admission(0))
    try:
        _warm(svc)
        faults.install({"step": [1]})
        stream_q = queue.Queue()
        work = _work(np.array([5, 6, 7, 8], np.int32), 4, 6,
                     stream_q=stream_q)
        assert svc.submit_many([work]) is not None
        while True:
            item = stream_q.get(timeout=120)
            if item[0] != "tok":
                break
        faults.reset()
        assert item[0] == "error" and item[2] is True
        assert svc.engine is eng
        assert eng.pool_leak_report() is None
        assert _pool_is_clean(eng)
        assert svc.stats()["engine_rebuilds"] == 0
        work2 = _work(np.array([1, 2, 3], np.int32), 3, 3)
        _run(svc, [work2])
    finally:
        svc.stop()


def test_force_reclaim_restores_torn_pool(lm):
    """A row abandoned mid-flight is fully reclaimed by force_reclaim,
    and pool_leak_report names the tear first."""
    _, _, pm = lm
    eng = _factory(pm)()
    eng.admit(np.array([5, 6, 7, 8], np.int32), 4, max_new=4)
    leaks = eng.pool_leak_report()
    assert leaks is not None and "active_rows" in leaks
    assert eng.force_reclaim() is None
    assert _pool_is_clean(eng)


def test_fault_plan_parsing_and_counting(monkeypatch):
    with pytest.raises(ValueError):
        faults.FaultPlan({"bogus_op": [1]})
    with pytest.raises(ValueError):
        faults.FaultPlan({"step": [-1]})
    plan = faults.install({"step": [1]})
    faults.fire("step")
    with pytest.raises(faults.InjectedFault):
        faults.fire("step")
    faults.fire("step")
    assert plan.fired() == {"step": [1]}
    assert plan.counts()["step"] == 3
    faults.reset()
    monkeypatch.setenv("CEA_TPU_FAULT_PLAN", json.dumps({"hydrate": [0]}))
    assert faults.active().pending() == {"hydrate": [0]}
    faults.reset()


# -- HTTP lifecycle: /readyz, Retry-After, the error envelope -----------------


@pytest.fixture(scope="module")
def gen_server(lm):
    srv = server.GenerationServer("lm", lm[2], port=0, max_new_tokens=8,
                                  max_batch=2, buckets=[8], warm=True,
                                  host="127.0.0.1")
    srv.start()
    yield srv
    srv.stop()


def _get(srv, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}{path}", timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), json.loads(err.read())


def _post(srv, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/models/lm:generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as err:
        return err.code, dict(err.headers), err.read()


def test_readyz_transitions_and_drain_contract(gen_server):
    """/readyz mirrors the lifecycle while /healthz stays live: a drain
    turns /readyz 503 {"state": "draining"} with Retry-After at once,
    /healthz keeps 200 and POSTs answer 503 with Retry-After and the
    request id; a quarantine reads "quarantined"."""
    code, _, body = _get(gen_server, "/readyz")
    assert code == 200 and body["status"] == "ready"
    assert _get(gen_server, "/healthz")[0] == 200
    assert gen_server.stats()["engine_state"] == "serving"
    gen_server.begin_drain()
    try:
        code, headers, body = _get(gen_server, "/readyz")
        assert code == 503
        assert body["status"] == body["state"] == "draining"
        assert set(body) >= {"state", "retry_after_s",
                             "saturation_cause"}
        assert int(headers["Retry-After"]) >= 1
        assert _get(gen_server, "/healthz")[0] == 200
        code, headers, raw = _post(gen_server, {"prompts": [[1, 2, 3]],
                                                "max_new_tokens": 2})
        assert code == 503
        assert int(headers["Retry-After"]) >= 1
        assert "request_id" in json.loads(raw)
    finally:
        gen_server._draining = False
        with gen_server._engine_service._lock:
            gen_server._engine_service._draining = False
    assert _get(gen_server, "/readyz")[0] == 200
    svc = gen_server._engine_service
    with svc._lock:
        svc._quarantined = True
    try:
        code, _, body = _get(gen_server, "/readyz")
        assert code == 503 and body["state"] == "quarantined"
        assert _get(gen_server, "/healthz")[0] == 200
    finally:
        with svc._lock:
            svc._quarantined = False


def test_stream_error_envelope_over_http(gen_server):
    """A mid-stream failure with supervision off ends the stream with
    the error envelope {"error", "retryable", "request_id"}; the service
    serves on."""
    svc = gen_server._engine_service
    saved = svc._engine_factory
    svc._engine_factory = None
    faults.install({"step": [1]})
    try:
        code, _, raw = _post(gen_server, {"prompts": [[5, 6, 7]],
                                          "max_new_tokens": 6,
                                          "stream": True})
        assert code == 200
        lines = [json.loads(line) for line in raw.decode().splitlines()]
        assert lines and "error" in lines[-1]
        assert lines[-1]["retryable"] is True
        assert lines[-1]["request_id"]
    finally:
        faults.reset()
        svc._engine_factory = saved
    code, _, _ = _post(gen_server, {"prompts": [[5, 6, 7]],
                                    "max_new_tokens": 2})
    assert code == 200


def test_stream_resumes_through_quarantine_over_http(gen_server, lm):
    """With supervision on, a mid-stream fault is invisible to the
    client: the stream stalls, resumes, and its tokens equal the same
    request served fault-free and the JAX decode()."""
    payload = {"prompts": [[4, 2, 4, 2]], "max_new_tokens": 6,
               "stream": True}
    code, _, raw = _post(gen_server, payload)
    assert code == 200
    clean = [t for line in raw.decode().splitlines()
             for t in json.loads(line).get("tokens", [])]
    faults.install({"step": [2]})
    try:
        code, _, raw = _post(gen_server, payload)
    finally:
        faults.reset()
    assert code == 200
    lines = [json.loads(line) for line in raw.decode().splitlines()]
    assert not any("error" in line for line in lines), lines
    assert lines[-1] == {"done": True}
    faulted = [t for line in lines for t in line.get("tokens", [])]
    assert faulted == clean
    model, params, _ = lm
    assert clean == _greedy_ref(model, params, [[4, 2, 4, 2]], [6])[0]
    assert gen_server.stats()["engine_rebuilds"] >= 1


def test_drain_with_a_stream_in_flight(lm):
    """GenerationServer.drain with a stream mid-flight: the stream
    finishes with its done line, a new POST gets 503, drain returns True
    once the response is written."""
    srv = server.GenerationServer("lm", lm[2], port=0, max_new_tokens=8,
                                  max_batch=2, buckets=[8],
                                  host="127.0.0.1")
    srv.start()
    gate = threading.Event()
    real_step = srv.engine.step

    def held_step():
        gate.wait(30)
        return real_step()

    srv.engine.step = held_step
    result = {}

    def client():
        result["stream"] = _post(srv, {"prompts": [[1, 2, 3]],
                                       "max_new_tokens": 6,
                                       "stream": True})

    t = threading.Thread(target=client)
    t.start()
    try:
        deadline = time.monotonic() + 30
        while srv.stats()["slots_active"] == 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        drained = {}
        d = threading.Thread(
            target=lambda: drained.setdefault("ok", srv.drain(60)))
        d.start()
        deadline = time.monotonic() + 30
        while not srv._draining:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        code, headers, _ = _post(srv, {"prompts": [[1, 2]],
                                       "max_new_tokens": 2})
        assert code == 503 and int(headers["Retry-After"]) >= 1
        gate.set()
        d.join(60)
        t.join(60)
        assert drained["ok"] is True
        code, _, raw = result["stream"]
        lines = [json.loads(line) for line in raw.decode().splitlines()]
        assert code == 200 and lines[-1] == {"done": True}
        assert sum(len(line.get("tokens", [])) for line in lines) == 6
    finally:
        gate.set()
        srv.stop()


def test_launcher_sigterm_drains_then_exits_zero():
    """The launcher as a process: SIGTERM with a stream in flight turns
    /readyz 503 {"state": "draining"}, answers a new POST 503 with
    Retry-After, lets the stream finish with its done line, and the
    process exits 0."""
    argv = [sys.executable, "-m",
            "container_engine_accelerators_tpu_torch.serving.serve",
            "--model", "transformer", "--model-name", "lm", "--port", "0",
            "--device", "cpu", "--vocab-size", "48", "--embed-dim", "32",
            "--num-layers", "2", "--num-heads", "4", "--max-seq-len",
            "512", "--max-new-tokens", "400", "--max-batch", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(argv, cwd=REPO_ROOT, env=env, text=True,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        port = None
        while port is None:
            line = proc.stderr.readline()
            assert line, "launcher exited before serving"
            m = re.search(r"on port (\d+)", line)
            port = int(m.group(1)) if m else None
        srv = types.SimpleNamespace(port=port)
        conn = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/lm:generate",
            data=json.dumps({"prompts": [[1, 2, 3]],
                             "max_new_tokens": 400,
                             "stream": True}).encode()), timeout=120)
        first = json.loads(conn.readline())
        assert first.get("tokens")
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        while _get(srv, "/readyz")[0] != 503:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        code, headers, body = _get(srv, "/readyz")
        assert body["state"] == "draining"
        code, headers, raw = _post(srv, {"prompts": [[4, 5]],
                                         "max_new_tokens": 2})
        assert code == 503 and int(headers["Retry-After"]) >= 1
        lines = [first] + [json.loads(x) for x in conn.read().splitlines()]
        conn.close()
        assert lines[-1] == {"done": True}
        assert sum(len(x.get("tokens", [])) for x in lines) == 400
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_rebuild_keeps_the_pool_chosen_at_construction(lm):
    """A server built while CEA_TPU_PAGED_KV=0 selects the dense pool
    rebuilds a dense engine after a quarantine even once the variable
    is gone (a rebuilt engine is the same engine), and the replay
    admissions prefill each row's prompt plus its delivered tokens."""
    os.environ[decode.PAGED_KV_ENV] = "0"
    try:
        srv = server.GenerationServer("lm", lm[2], port=0,
                                      max_new_tokens=8, max_batch=2,
                                      buckets=[8], host="127.0.0.1")
    finally:
        os.environ.pop(decode.PAGED_KV_ENV)
    srv.start()
    try:
        assert not srv.engine.paged
        faults.install({"step": [2]})
        try:
            code, _, raw = _post(srv, {"prompts": [[4, 2, 4, 2]],
                                       "max_new_tokens": 6})
        finally:
            faults.reset()
        assert code == 200
        assert srv.stats()["engine_rebuilds"] == 1
        assert not srv.engine.paged
        assert dict(srv.engine.prefill_widths) == {4 + 3: 1}
        model, params, _ = lm
        assert json.loads(raw)["sequences"][0][4:] == _greedy_ref(
            model, params, [[4, 2, 4, 2]], [6])[0]
    finally:
        srv.stop()

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

"""Server-level system prefixes (``prefix_tokens``) in the port against
the JAX package's GenerationServer on the same f32 weights: suffix-
relative greedy sequences identical (and equal to the JAX decode() of
prefix + suffix), the same prefix hits and shared tokens, the same 400s
and construction errors, the same again with ``speculative_k``, streams,
a quarantine rebuild that re-pins the prefix, and the launcher's
``--system-prefix-ids`` / ``--system-prefix``."""

import json
import os
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.serving import serve
from container_engine_accelerators_tpu_torch.serving import server
from container_engine_accelerators_tpu_torch.utils import faults
from tests import torch_parity

LM = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
          max_seq_len=40)
PREFIX = [9, 8, 7, 6, 5, 4]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
    faults.reset()


@pytest.fixture(scope="module")
def lm():
    model, tree, config = torch_parity.flax_lm_of(seed=1, **LM)
    return model, tree, torch_parity.port_lm(config, tree)


@pytest.fixture(scope="module")
def servers(lm):
    model, params, pm = lm
    theirs = jax_server.GenerationServer(
        "lm-sys", model, params, port=0, max_new_tokens=8, max_batch=4,
        prefix_tokens=PREFIX, warm=True)
    mine = server.GenerationServer(
        "lm-sys", pm, port=0, max_new_tokens=8, max_batch=4,
        prefix_tokens=PREFIX, warm=True, host="127.0.0.1")
    mine.start()
    yield mine, theirs
    mine.stop()
    theirs.stop()


def _call(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(url, data=data, timeout=120) as resp:
            body = resp.read()
            if resp.headers["Content-Type"] == "application/x-ndjson":
                return resp.status, [json.loads(x) for x in
                                     body.decode().splitlines()]
            return resp.status, json.loads(body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _gen(srv, payload, name="lm-sys"):
    return _call(srv, f"/v1/models/{name}:generate", payload)


_PAYLOADS = [
    {"prompts": [[1, 2, 3]], "max_new_tokens": 6},
    {"prompts": [[2, 4, 6], [1, 3, 5]], "max_new_tokens": 8},
    {"prompts": [list(range(1, 21))], "max_new_tokens": 8},
    {"prompts": [[30, 31, 32, 33, 34]], "max_new_tokens": 8, "eos_id": 9},
    {"prompts": [[7]], "max_new_tokens": 1},
]


@pytest.mark.parametrize("case", range(len(_PAYLOADS)))
def test_suffix_relative_sequences_equal_the_jax_server(servers, lm, case):
    mine, theirs = servers
    model, params, _ = lm
    payload = _PAYLOADS[case]
    code, got = _gen(mine, payload)
    assert code == 200
    assert (code, got) == theirs._handle_post(dict(payload))
    new = payload["max_new_tokens"]
    for prompt, seq in zip(payload["prompts"], got["sequences"]):
        assert len(seq) == len(prompt) + new
        assert seq[:len(prompt)] == prompt
        if "eos_id" not in payload:
            full = np.asarray(jax_decode.decode(
                model, params, jnp.asarray([PREFIX + prompt], jnp.int32),
                new))[0]
            assert seq == full[len(PREFIX):].tolist()


def test_prefix_hits_and_shared_tokens_equal(servers):
    """The same requests on both servers move the prefix counters alike:
    every admission maps the pinned blocks (a hit sharing the prefix's
    full blocks)."""
    mine, theirs = servers
    before = (mine.stats(), theirs.stats())
    payloads = [{"prompts": [[1, 2]], "max_new_tokens": 2},
                {"prompts": [[3, 4], [5, 6]], "max_new_tokens": 2}]
    for payload in payloads:
        assert _gen(mine, payload)[0] == 200
        assert theirs._handle_post(dict(payload))[0] == 200
    after = (mine.stats(), theirs.stats())
    deltas = [{k: a[k] - b[k] for k in ("prefix_lookups", "prefix_hits",
                                        "prefix_tokens_shared")}
              for a, b in zip(after, before)]
    assert deltas[0] == deltas[1]
    assert deltas[0]["prefix_hits"] == 3
    assert mine.engine._pinned and mine.engine.block_pool_state()[
        "pinned_blocks"] == theirs._engine_service._engine \
        .block_pool_state()["pinned_blocks"]


_REFUSED = [
    {"prompts": [[1, 2]], "max_new_tokens": 2, "repetition_penalty": 1.3},
    {"prompts": [[1, 2]], "max_new_tokens": 2, "logprobs": True},
    {"prompts": [[1, 2]], "max_new_tokens": 0, "logprobs": True},
    {"prompts": [list(range(1, 40))], "max_new_tokens": 2},
]


@pytest.mark.parametrize("case", range(len(_REFUSED)))
def test_refused_requests_get_the_jax_servers_400s(servers, case):
    mine, theirs = servers
    want = theirs._handle_post(dict(_REFUSED[case]))
    assert want[0] == 400
    assert _gen(mine, _REFUSED[case]) == want


def test_metadata_stream_and_sampling(servers):
    mine, theirs = servers
    code, meta = _call(mine, "/v1/models/lm-sys")
    info = meta["model_version_status"][0]["metadata"]
    assert info == theirs._model_metadata()
    assert info["prefix_len"] == len(PREFIX)
    one = _gen(mine, {"prompts": [[2, 4, 6]], "max_new_tokens": 6})[1]
    code, lines = _gen(mine, {"prompts": [[2, 4, 6]],
                              "max_new_tokens": 6, "stream": True})
    assert code == 200 and lines[-1] == {"done": True}
    assert [t for line in lines[:-1] for t in line["tokens"]] == \
        one["sequences"][0][3:]
    code, out = _gen(mine, {"prompts": [[1, 2], [3, 4]],
                            "max_new_tokens": 4, "temperature": 0.8,
                            "top_k": 8, "top_p": 0.9})
    assert code == 200
    for s in out["sequences"]:
        assert len(s) == 6 and all(0 <= t < LM["vocab_size"] for t in s)


def test_construction_errors_are_the_jax_servers(lm, monkeypatch):
    model, params, pm = lm
    cases = [
        dict(prefix_tokens=[1, 99]),
        dict(prefix_tokens=[1, 2],
             warm_filters=[{"repetition_penalty": 1.2}]),
        dict(max_new_tokens=8, prefix_tokens=list(range(32))),
        dict(prefix_tokens=[]),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            jax_server.GenerationServer("x", model, params, port=0, **kw)
        with pytest.raises(ValueError) as got:
            server.GenerationServer("x", pm, port=0, **kw)
        assert str(got.value) == str(want.value)
    monkeypatch.setenv(decode.PAGED_KV_ENV, "0")
    with pytest.raises(ValueError) as want:
        jax_server.GenerationServer("x", model, params, port=0,
                                    prefix_tokens=[1, 2])
    with pytest.raises(ValueError) as got:
        server.GenerationServer("x", pm, port=0, prefix_tokens=[1, 2])
    assert str(got.value) == str(want.value)
    assert "requires the paged KV pool" in str(got.value)


def test_prefix_with_speculation_matches_plain_prefix(lm):
    """prefix_tokens + speculative_k (a self-draft): default-knob
    traffic speculates over the pinned prefix and returns exactly what
    the prefix-only server and the JAX speculative prefix server
    return; the draft admission prefills the full row (one draft
    prefill a greedy admission); penalty traffic still gets the 400."""
    _, _, _ = lm
    config = dict(LM, max_seq_len=64)
    model, params, cfg = torch_parity.flax_lm_of(seed=1, **config)
    pm = torch_parity.port_lm(cfg, params)
    prefix = [7, 11, 13, 17]

    def make(mod, *weights, **kw):
        return mod.GenerationServer("lm", *weights, port=0,
                                    max_new_tokens=8, max_batch=2,
                                    buckets=[8], prefix_tokens=prefix,
                                    **kw)

    plain = make(server, pm, host="127.0.0.1")
    spec = make(server, pm, host="127.0.0.1", draft_model=pm,
                speculative_k=4, warm=True)
    theirs = make(jax_server, model, params, draft_model=model,
                  draft_params=params, speculative_k=4, warm=True)
    plain.start()
    spec.start()
    try:
        payloads = [{"prompts": [[1, 2, 3]], "max_new_tokens": 8},
                    {"prompts": [[1, 2, 3]], "max_new_tokens": 8,
                     "eos_id": 9},
                    {"prompts": [[4, 5, 6, 7, 8]], "max_new_tokens": 8,
                     "temperature": 0.0}]
        for payload in payloads:
            a = _gen(plain, payload, "lm")
            b = _gen(spec, payload, "lm")
            assert a == b, payload
            assert b == theirs._handle_post(dict(payload))
        stats = spec.stats()
        assert stats["spec_steps"] >= 3
        assert stats["draft_prefills"] == 3
        assert stats["draft_prefills"] == \
            theirs.stats()["draft_prefills"]
        rate = stats["speculative_acceptance_rate"]
        assert rate is not None and rate >= 0.5
        assert stats["prefix_hits"] == 3
        code, body = _gen(spec, {"prompts": [[1, 2, 3]],
                                 "max_new_tokens": 4,
                                 "repetition_penalty": 1.3}, "lm")
        assert code == 400
    finally:
        plain.stop()
        spec.stop()
        theirs.stop()


def test_rebuild_re_pins_the_prefix(servers, lm):
    """A step fault mid-request quarantines the prefix server's engine;
    the rebuilt engine pins the prefix again, the replayed stream
    equals the uninterrupted one, and later admissions still hit."""
    mine, _ = servers
    payload = {"prompts": [[3, 1, 4, 1, 5]], "max_new_tokens": 8}
    clean = _gen(mine, payload)[1]
    old_engine = mine.engine
    faults.install({"step": [3]})
    try:
        code, faulted = _gen(mine, payload)
    finally:
        faults.reset()
    assert code == 200 and faulted == clean
    assert mine.engine is not old_engine
    assert mine.stats()["engine_rebuilds"] >= 1
    eng = mine.engine
    assert len(eng._pinned) == -(-len(PREFIX) // eng._block_size)
    hits = mine.stats()["prefix_hits"]
    assert _gen(mine, payload)[1] == clean
    assert mine.stats()["prefix_hits"] == hits + 1
    assert eng.pool_leak_report() is None


def test_launcher_system_prefix_flags(lm):
    """--system-prefix-ids and --system-prefix (byte tokenizer) build the
    prefix server; the prefix-ids server's suffix response equals the
    prefix server built directly."""
    base = ["--model", "transformer", "--vocab-size", "256",
            "--embed-dim", "32", "--num-layers", "2", "--num-heads", "4",
            "--max-seq-len", "48", "--max-new-tokens", "4",
            "--max-batch", "2", "--port", "0", "--device", "cpu",
            "--model-name", "lm"]
    srv = serve.build_server(serve.parse_args(
        base + ["--system-prefix-ids", "9,8,7,6,5"]))
    srv.start()
    try:
        assert srv._prefix_len == 5
        assert srv._model_metadata()["prefix_len"] == 5
        code, out = _gen(srv, {"prompts": [[1, 2]], "max_new_tokens": 4},
                         "lm")
        assert code == 200 and len(out["sequences"][0]) == 6
        assert srv.stats()["prefix_hits"] == 1
    finally:
        srv.stop()
    srv = serve.build_server(serve.parse_args(
        base + ["--tokenizer", "byte", "--system-prefix", "You are"]))
    try:
        assert srv._prefix_arr.tolist() == list(b"You are")
    finally:
        srv.stop()
    os.environ.pop(decode.PAGED_KV_ENV, None)

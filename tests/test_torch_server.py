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

"""The port's GenerationServer on the CPU (device="cpu", port 0).

The server builds its engine as the JAX server does, so it serves the
paged pool unless ``CEA_TPU_PAGED_KV=0`` selects the dense one; both
are served here. Greedy responses must equal the port's greedy_decode
and the JAX package's decode() token for token (f32 model); logprob
rows agree with decode(return_logprobs=True) at 1e-4 (the server rounds
them to six decimals). Invalid requests get the JAX server's 400
bodies. Text requests (the byte tokenizer, on a model of vocab 256)
get the JAX server's bodies; an ndjson stream carries the tokens of
the same request unstreamed; warm-up holds /healthz at 503 and leaves
no trace in /stats; the launcher takes demo/serving/lm-serving.yaml's
command line as written, and the demo's load generator runs against
the server.
"""

import importlib.util
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu.serving import (
    tokenizer as jax_tokenizer,
)
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import quantized
from container_engine_accelerators_tpu_torch.models import transformer
from container_engine_accelerators_tpu_torch.serving import serve
from container_engine_accelerators_tpu_torch.serving import server
from container_engine_accelerators_tpu_torch.serving import tokenizer
from tests import torch_drivers, torch_parity
from tests.conftest import REPO_ROOT

MAX_NEW = 8


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lm():
    model, tree, config = torch_parity.flax_lm("rope_gqa")
    return model, tree, torch_parity.port_lm(config, tree)


def _server(port_model, paged_env, **kwargs):
    """A started server, built with CEA_TPU_PAGED_KV set to
    ``paged_env`` (None: unset, the default pool)."""
    prev = os.environ.pop(decode.PAGED_KV_ENV, None)
    if paged_env is not None:
        os.environ[decode.PAGED_KV_ENV] = paged_env
    try:
        s = server.GenerationServer("lm", port_model, port=0,
                                    max_new_tokens=MAX_NEW, max_batch=4,
                                    host="127.0.0.1", **kwargs)
    finally:
        os.environ.pop(decode.PAGED_KV_ENV, None)
        if prev is not None:
            os.environ[decode.PAGED_KV_ENV] = prev
    s.start()
    return s


@pytest.fixture(scope="module")
def srv(lm):
    s = _server(lm[2], None)
    yield s
    s.stop()


@pytest.fixture(scope="module")
def dense_srv(lm):
    s = _server(lm[2], "0")
    yield s
    s.stop()


def _call(srv, path, payload=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(url, data=data, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _generate(srv, payload):
    return _call(srv, "/v1/models/lm:generate", payload)


def test_greedy_responses_match_oracles(srv, lm):
    """Two buckets, a two-prompt request and concurrent clients: every
    row equals the port's greedy_decode and JAX decode()."""
    model, tree, port = lm
    requests = [torch_parity.tokens(20, (2, 5)).tolist(),
                torch_parity.tokens(21, (1, 20)).tolist(),
                torch_parity.tokens(22, (1, 16)).tolist()]
    results = [None] * len(requests)

    def client(i):
        results[i] = _generate(srv, {"prompts": requests[i],
                                     "max_new_tokens": 6})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for prompts, (code, body) in zip(requests, results):
        assert code == 200, body
        arr = np.asarray(prompts, np.int32)
        want = np.asarray(jax_decode.decode(model, tree, jnp.asarray(arr),
                                            6))
        oracle = decode.greedy_decode(port, torch.from_numpy(arr), 6)
        np.testing.assert_array_equal(oracle.numpy(), want)
        assert body["sequences"] == want.tolist()
        assert "logprobs" not in body


def test_logprobs_and_eos_match_jax_decode(srv, lm):
    model, tree, _ = lm
    prompt = torch_parity.tokens(23, (1, 9))
    seq, lps = jax_decode.decode(model, tree, jnp.asarray(prompt), MAX_NEW,
                                 return_logprobs=True)
    code, body = _generate(srv, {"prompts": prompt.tolist(),
                                 "max_new_tokens": MAX_NEW,
                                 "logprobs": True})
    assert code == 200, body
    assert body["sequences"] == np.asarray(seq).tolist()
    np.testing.assert_allclose(body["logprobs"], np.asarray(lps), rtol=0,
                               atol=1e-4)
    # An EOS id the greedy stream emits at its third new token: the row
    # retires there and is EOS-padded, as decode(eos_id=...) pads it.
    eos = int(np.asarray(seq)[0, 9 + 2])
    want = np.asarray(jax_decode.decode(model, tree, jnp.asarray(prompt),
                                        MAX_NEW, eos_id=eos))
    code, body = _generate(srv, {"prompts": prompt.tolist(),
                                 "max_new_tokens": MAX_NEW, "eos_id": eos})
    assert code == 200 and body["sequences"] == want.tolist()
    # Scoring mode: echo logprobs of the prompt alone.
    code, body = _generate(srv, {"prompts": prompt.tolist(),
                                 "max_new_tokens": 0, "logprobs": True})
    assert code == 200 and body["sequences"] == prompt.tolist()
    np.testing.assert_allclose(body["logprobs"][0], np.asarray(lps)[0, :9],
                               rtol=0, atol=1e-4)


def test_sampled_request_is_served(srv):
    code, body = _generate(srv, {
        "prompts": torch_parity.tokens(24, (2, 6)).tolist(),
        "max_new_tokens": MAX_NEW, "temperature": 0.8, "top_k": 10,
        "top_p": 0.9, "min_p": 0.01, "repetition_penalty": 1.2})
    assert code == 200, body
    for row in body["sequences"]:
        assert len(row) == 6 + MAX_NEW
        assert all(0 <= t < torch_parity.TINY["vocab_size"] for t in row)


_BAD = [
    {"prompts": [[1, 2]], "eos_id": 64},
    {"prompts": [[1, 2]], "top_k": 65},
    {"prompts": [[1, 2]], "temperature": -1.0},
    {"prompts": [[1, 2]], "temperature": 0.5, "top_p": 0.0},
    {"prompts": [[1, 2]], "repetition_penalty": 0.0},
    {"prompts": [[1, 2]], "temperature": 0.5, "min_p": 1.0},
    {"prompts": [[1, 2]], "top_k": 5},
    {"prompts": []},
    {"prompts": [[1]] * 5},
    {"prompts": [[1, 2], [1]]},
    {"prompts": [[1, 2]], "max_new_tokens": 0},
    {"prompts": [[1, 2]], "max_new_tokens": MAX_NEW + 1},
    {"prompts": [["a", "b"]]},
    {"prompts": [[]]},
    {"prompts": [[1, 64]]},
    {"prompts": [[1] * 41]},
    {"max_new_tokens": 2},
    {"prompts": [[1, 2]], "max_new_tokens": "many"},
    {"text": ["hi"]},
    {"prompts": [[1, 2]], "stream": True, "logprobs": True},
    {"prompts": [[1, 2]], "stream": True, "repetition_penalty": 1.2},
    {"prompts": [[1, 2], [3, 4]], "stream": True},
    {"prompts": [[1, 2]], "stream": True, "max_new_tokens": 0},
    {"prompts": [[1, 2]], "stream": True, "max_new_tokens": -1},
]


@pytest.fixture(scope="module")
def jax_srv(lm):
    model, tree, _ = lm
    s = jax_server.GenerationServer("lm", model, tree, port=0,
                                    max_new_tokens=MAX_NEW, max_batch=4)
    yield s
    s.stop()


@pytest.mark.parametrize("case", range(len(_BAD)))
def test_bad_requests_get_the_jax_servers_400s(srv, jax_srv, case):
    want = jax_srv._handle_post(dict(_BAD[case]))
    assert want[0] == 400
    assert _generate(srv, _BAD[case]) == (want[0], want[1])


def test_unported_request_options_and_routes(srv):
    """Streaming is served now (see the stream tests below); a stream
    the contract refuses gets its 400, and unknown routes 404."""
    code, body = _generate(srv, {"prompts": [[1, 2]], "stream": True,
                                 "logprobs": True})
    assert code == 400 and "stream does not support" in body["error"]
    assert _call(srv, "/v1/models/other:generate", {})[0] == 404
    assert _call(srv, "/nope")[0] == 404


_BLOCK_KEYS = ("kv_blocks_total", "kv_blocks_free", "kv_blocks_shared",
               "kv_block_size", "kv_block_utilization", "prefix_lookups",
               "prefix_hits", "prefix_hit_rate", "prefix_tokens_shared",
               "kv_quant_mode", "kv_arena_bytes", "kv_spill_blocks",
               "kv_spill_bytes", "kv_spill_hits", "kv_spill_hit_rate",
               "kv_rehydrated_blocks")


@pytest.mark.parametrize("pool", ["paged", "dense"])
def test_healthz_stats_and_metadata(request, pool):
    srv = request.getfixturevalue("srv" if pool == "paged" else "dense_srv")
    assert _call(srv, "/healthz") == (200, {"status": "ok", "model": "lm"})
    code, stats = _call(srv, "/stats")
    assert code == 200
    assert stats["kv_pool"] == pool and stats["device"] == "cpu"
    # CPU tensors take the plain version: no kernel launches here.
    assert stats["flash_fwd_launches"] == 0
    for key in ("requests", "slots_active", "slots_free", "queue_depth",
                "engine_prefills", "engine_steps", "tokens_generated"):
        assert key in stats
    if pool == "paged":
        assert set(_BLOCK_KEYS) <= set(stats)
        assert stats == dict(stats, **srv.engine.kv_block_stats())
        # 4 slots of ceil(48 / 16) blocks: the dense pool's bytes.
        assert stats["kv_blocks_total"] == 12
        assert stats["kv_block_size"] == 16
    else:
        assert not set(_BLOCK_KEYS) & set(stats)
    code, meta = _call(srv, "/v1/models/lm")
    assert code == 200
    info = meta["model_version_status"][0]["metadata"]
    assert info["prompt_buckets"] == [16, 32, 40]
    assert info["max_new_tokens"] == MAX_NEW


def test_launcher_builds_a_cpu_server_and_refuses_the_rest(monkeypatch,
                                                           tmp_path,
                                                           capsys):
    flags = ["--model", "transformer", "--vocab-size", "64",
             "--embed-dim", "32", "--num-layers",
             "1", "--num-heads", "4", "--num-kv-heads", "2",
             "--pos-embedding", "rope", "--max-seq-len", "48",
             "--max-new-tokens", "4", "--max-batch", "2", "--port", "0"]
    parser = serve.build_parser()
    assert parser.parse_args([]).device == "cuda"
    for extra, kv_quant, int8_layers in (
            ([], "bf16", 0), (["--kv-cache-dtype", "int8"], "int8", 0),
            (["--quantize-weights", "int8"], "bf16", 5)):
        s = serve.build_server(parser.parse_args(
            flags + ["--device", "cpu"] + extra))
        try:
            assert s.engine.slots == 2 and s.engine.device.type == "cpu"
            assert s.engine.kv_quant == kv_quant
            assert int8_layers == sum(
                isinstance(m, quantized.Int8Linear)
                for m in s.engine._model.modules())
        finally:
            s.stop()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            serve.build_server(parser.parse_args(flags))
    # Ported: the launcher builds the windowed server, on the paged pool
    # and at CEA_TPU_PAGED_KV=0 on the dense one.
    for paged in ("1", "0"):
        monkeypatch.setenv(decode.PAGED_KV_ENV, paged)
        s = serve.build_server(parser.parse_args(
            flags + ["--device", "cpu", "--attention-window", "16"]))
        try:
            assert s.engine.paged == (paged == "1")
            assert s.engine._model.attention_window == 16
            assert not isinstance(s.engine._cache, transformer.RingCache)
        finally:
            s.stop()
    monkeypatch.delenv(decode.PAGED_KV_ENV)
    # Ported: a directory without a finished checkpoint serves the
    # weights made from --seed, with the demo launcher's message.
    s = serve.build_server(parser.parse_args(
        flags + ["--device", "cpu", "--model-dir", "/ckpt"]))
    s.stop()
    assert ("no checkpoints under '/ckpt'; serving initialized weights"
            in capsys.readouterr().err)
    for bad in ('{"top_k": 40}', '[1, 2]', '[{"top_k": 40}, 3]'):
        with pytest.raises(SystemExit, match="list of dicts"):
            serve.build_server(parser.parse_args(
                flags + ["--device", "cpu", "--warm-filters", bad]))
    # Ported: a local Hugging Face tokenizer directory (its 300 ids need
    # a vocab above 256; the later flag wins).
    pytest.importorskip("transformers")
    path = torch_drivers.hf_tokenizer_dir(tmp_path / "tok")
    s = serve.build_server(parser.parse_args(
        flags + ["--device", "cpu", "--tokenizer", path,
                 "--vocab-size", "320"]))
    try:
        assert isinstance(s._tokenizer, tokenizer._HFTokenizer)
        assert (s._tokenizer.encode("hi")
                == jax_tokenizer.load_tokenizer(path).encode("hi"))
    finally:
        s.stop()


def test_paged_server_shares_a_resident_prefix(srv, lm):
    """A prompt sent twice: the second admission maps the first's
    blocks (a prefix hit, only its last token prefilled) and streams
    the same tokens as JAX decode(); a logprobs request neither shares
    nor registers. The pool is clean once the server is idle."""
    model, tree, _ = lm
    prompt = torch_parity.tokens(25, (1, 21))
    want = np.asarray(jax_decode.decode(model, tree, jnp.asarray(prompt),
                                        MAX_NEW)).tolist()
    before = srv.engine.kv_block_stats()
    for _ in range(2):
        code, body = _generate(srv, {"prompts": prompt.tolist(),
                                     "max_new_tokens": MAX_NEW})
        assert code == 200 and body["sequences"] == want
    stats = _call(srv, "/stats")[1]
    assert stats["prefix_hits"] >= before["prefix_hits"] + 1
    assert stats["prefix_tokens_shared"] >= (
        before["prefix_tokens_shared"] + 20)
    lookups = stats["prefix_lookups"]
    code, body = _generate(srv, {"prompts": prompt.tolist(),
                                 "max_new_tokens": 2, "logprobs": True})
    assert code == 200 and body["sequences"][0] == want[0][:23]
    assert _call(srv, "/stats")[1]["prefix_lookups"] == lookups
    assert srv.engine.pool_leak_report() is None


def test_dense_pool_serves_the_same_streams(dense_srv, lm):
    model, tree, _ = lm
    prompt = torch_parity.tokens(26, (2, 11))
    want = np.asarray(jax_decode.decode(model, tree, jnp.asarray(prompt),
                                        MAX_NEW))
    code, body = _generate(dense_srv, {"prompts": prompt.tolist(),
                                       "max_new_tokens": MAX_NEW})
    assert code == 200 and body["sequences"] == want.tolist()
    assert dense_srv.engine.pool_leak_report() is None


# -- text in and out: the byte tokenizer ------------------------------------


@pytest.fixture(scope="module")
def byte_lm():
    model, tree, config = torch_parity.flax_lm("rope_gqa", vocab=256)
    return model, tree, torch_parity.port_lm(config, tree)


@pytest.fixture(scope="module")
def byte_srv(byte_lm):
    s = _server(byte_lm[2], None, tokenizer=tokenizer.ByteTokenizer())
    yield s
    s.stop()


@pytest.fixture(scope="module")
def jax_byte_srv(byte_lm):
    model, tree, _ = byte_lm
    s = jax_server.GenerationServer("lm", model, tree, port=0,
                                    max_new_tokens=MAX_NEW, max_batch=4,
                                    tokenizer=jax_tokenizer.ByteTokenizer())
    yield s
    s.stop()


def test_byte_tokenizer_is_the_jax_codec():
    ours, theirs = tokenizer.ByteTokenizer(), jax_tokenizer.ByteTokenizer()
    assert ours.vocab_size == theirs.vocab_size == 256
    for text in ("Hello, world", "", "naïve 東京 ✓", "a\nb\tc"):
        assert ours.encode(text) == theirs.encode(text)
        assert ours.decode(ours.encode(text)) == text
    for ids in ([72, 105, 300, 195, 169, -1, 65], [226, 156], [999]):
        assert ours.decode(ids) == theirs.decode(ids)
    assert isinstance(tokenizer.load_tokenizer("byte"),
                      tokenizer.ByteTokenizer)
    # Any other spec is a local Hugging Face directory (ported): a
    # missing one raises what the JAX loader raises.
    pytest.importorskip("transformers")
    with pytest.raises(Exception) as ours:
        tokenizer.load_tokenizer("/models/llama-tokenizer")
    with pytest.raises(Exception) as theirs:
        jax_tokenizer.load_tokenizer("/models/llama-tokenizer")
    assert type(ours.value) is type(theirs.value)


def test_text_requests_match_the_jax_server(byte_srv, jax_byte_srv):
    """Ragged text rows, then the same rows with an eos_id the first
    row generates: sequences and completions (trimmed at eos_id) equal
    the JAX server's, and the token-id request of the same rows."""
    texts = ["Hello, world", "hi", "naïve"]
    payload = {"text": texts, "max_new_tokens": MAX_NEW}
    code, body = _generate(byte_srv, payload)
    assert code == 200, body
    assert (code, body) == jax_byte_srv._handle_post(dict(payload))
    ids = [list(t.encode()) for t in texts]
    for row, seq, text in zip(ids, body["sequences"], body["completions"]):
        assert seq[:len(row)] == row and len(seq) == len(row) + MAX_NEW
        assert text == tokenizer.ByteTokenizer().decode(seq[len(row):])
        code, one = _generate(byte_srv, {"prompts": [row],
                                         "max_new_tokens": MAX_NEW})
        assert code == 200 and one["sequences"] == [seq]
    eos = body["sequences"][0][len(ids[0]) + 2]
    payload = dict(payload, eos_id=eos)
    code, trimmed = _generate(byte_srv, payload)
    assert (code, trimmed) == jax_byte_srv._handle_post(dict(payload))
    first = trimmed["sequences"][0][len(ids[0]):]
    assert trimmed["completions"][0] == tokenizer.ByteTokenizer().decode(
        first[:first.index(eos)])


_BAD_TEXT = [
    {"text": ["hi"], "prompts": [[1, 2]]},
    {"text": "hi"},
    {"text": ["hi", 3]},
    {"text": ["hi", ""]},
    {"text": ["x" * 41]},
    {"text": ["hi"] * 5},
    {"text": ["hi"], "stream": True, "logprobs": True},
    {"text": ["hi", "there"], "stream": True},
    {"text": ["hi"], "max_new_tokens": 0},
]


@pytest.mark.parametrize("case", range(len(_BAD_TEXT)))
def test_bad_text_requests_get_the_jax_servers_400s(byte_srv, jax_byte_srv,
                                                    case):
    want = jax_byte_srv._handle_post(dict(_BAD_TEXT[case]))
    assert want[0] == 400
    assert _generate(byte_srv, _BAD_TEXT[case]) == (want[0], want[1])


def test_tokenizer_vocab_must_fit_the_model(lm):
    with pytest.raises(ValueError,
                       match="tokenizer vocab 256 exceeds model vocab 64"):
        server.GenerationServer("lm", lm[2], port=0, host="127.0.0.1",
                                tokenizer=tokenizer.ByteTokenizer())


# -- ndjson streaming --------------------------------------------------------


def _stream(srv, payload):
    """(Content-Type, the ndjson lines) of a streamed request."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/models/lm:generate",
        data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        lines = [json.loads(line) for line in resp.read().splitlines()]
        return resp.headers["Content-Type"], lines


def test_stream_equals_the_unstreamed_response(srv, lm):
    """One {"tokens": [t]} line a step, then {"done": true}: the tokens
    of the same greedy request unstreamed (and of JAX decode()); with
    an eos_id the stream ends at it."""
    model, tree, _ = lm
    prompt = torch_parity.tokens(27, (1, 10))
    want = np.asarray(jax_decode.decode(model, tree, jnp.asarray(prompt),
                                        MAX_NEW))[0, 10:].tolist()
    payload = {"prompts": prompt.tolist(), "max_new_tokens": MAX_NEW}
    code, body = _generate(srv, payload)
    assert code == 200 and body["sequences"][0][10:] == want
    kind, lines = _stream(srv, dict(payload, stream=True))
    assert kind == "application/x-ndjson"
    assert lines[-1] == {"done": True}
    assert [line["tokens"] for line in lines[:-1]] == [[t] for t in want]
    eos = want[3]
    _, lines = _stream(srv, dict(payload, stream=True, eos_id=eos))
    cut = want.index(eos) + 1
    assert lines == [{"tokens": [t]} for t in want[:cut]] + [{"done": True}]


def test_text_stream_carries_completion_deltas(byte_srv):
    payload = {"text": ["Hello"], "max_new_tokens": MAX_NEW}
    code, body = _generate(byte_srv, payload)
    assert code == 200
    gen = body["sequences"][0][5:]
    _, lines = _stream(byte_srv, dict(payload, stream=True, eos_id=gen[-1]))
    cut = gen.index(gen[-1])
    codec = tokenizer.ByteTokenizer()
    assert lines[:-1] == [
        {"tokens": [t],
         "completion_delta": "" if i == cut else codec.decode([t])}
        for i, t in enumerate(gen[:cut + 1])]
    assert lines[-1] == {"done": True}


def _wait_idle(srv, timeout=60):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        stats = srv.stats()
        if stats["slots_active"] == 0 and stats["queue_depth"] == 0:
            return stats
        time.sleep(0.02)
    raise AssertionError(f"server not idle: {srv.stats()}")


def test_cancelled_stream_frees_its_slot_and_blocks(srv, monkeypatch):
    """Closing a stream cancels its row: with the step held, the row
    that has its first token is closed, and the loop retires it at the
    next step boundary with one more token, slot and blocks returned. A
    client that hangs up mid-stream leaves no row behind either."""
    _wait_idle(srv)
    gate = threading.Event()
    real_step = srv.engine.step

    def held_step():
        gate.wait(30)
        return real_step()

    monkeypatch.setattr(srv.engine, "step", held_step)
    before = srv.stats()
    code, body = srv._handle_post({
        "prompts": torch_parity.tokens(28, (1, 6)).tolist(),
        "max_new_tokens": MAX_NEW, "stream": True})
    assert code == 200 and set(next(body)) == {"tokens"}
    body.close()
    gate.set()
    after = _wait_idle(srv)
    assert after["requests_retired"] == before["requests_retired"] + 1
    assert after["tokens_generated"] - before["tokens_generated"] == 2
    assert srv.engine.pool_leak_report() is None
    monkeypatch.setattr(srv.engine, "step", real_step)

    request = json.dumps({"prompts": torch_parity.tokens(29, (1, 6)).tolist(),
                          "max_new_tokens": MAX_NEW, "stream": True})
    with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as c:
        c.sendall((f"POST /v1/models/lm:generate HTTP/1.0\r\n"
                   f"Content-Length: {len(request)}\r\n\r\n{request}"
                   ).encode())
        seen = b""
        while b'{"tokens": [' not in seen:
            chunk = c.recv(4096)
            assert chunk, seen
            seen += chunk
    _wait_idle(srv)
    assert srv.engine.pool_leak_report() is None
    assert srv.engine.free_slots() == srv.engine.slots


# -- warm-up ------------------------------------------------------------------


def test_warm_up_gates_healthz_and_leaves_stats_clean(lm, monkeypatch):
    """/healthz answers 503 {"status": "warming"} while the warm rows
    run and 200 after; the rows went through the engine (one prefill
    per bucket width) but /stats counts none of them, and the prefix
    index holds none of their blocks."""
    release = threading.Event()
    real_warm = server.GenerationServer._warm_up

    def held_warm(self):
        release.wait(30)
        real_warm(self)

    monkeypatch.setattr(server.GenerationServer, "_warm_up", held_warm)
    s = _server(lm[2], None, warm=True, warm_async=True)
    try:
        assert not s.ready
        assert _call(s, "/healthz") == (503, {"status": "warming",
                                              "model": "lm"})
        release.set()
        deadline = time.monotonic() + 60
        while _call(s, "/healthz")[0] != 200:
            assert time.monotonic() < deadline, "warm-up did not finish"
            time.sleep(0.02)
        assert s.warm_seconds > 0
        assert dict(s.engine.prefill_widths) == {16: 1, 32: 1, 40: 1}
        stats = _call(s, "/stats")[1]
        for key in ("requests_admitted", "requests_retired",
                    "tokens_generated",
                    "engine_steps", "engine_prefills", "prefix_lookups",
                    "prefix_hits", "requests"):
            assert stats[key] == 0, key
        assert stats["ttft_p50_ms"] is None
        assert s.engine.block_pool_state()["indexed_keys"] == 0
        assert s.engine.pool_leak_report() is None
        code, body = _generate(s, {"prompts": [[1, 2, 3]],
                                   "max_new_tokens": 2})
        assert code == 200 and _call(s, "/stats")[1]["requests_retired"] == 1
    finally:
        s.stop()


def test_failed_warm_up_leaves_the_server_unready(lm, monkeypatch):
    """An admission that fails during warm-up: the background warm-up
    logs it and /healthz stays 503; the synchronous one raises from the
    constructor."""

    def broken_admit(*args, **kwargs):
        raise RuntimeError("synthetic device failure")

    monkeypatch.setattr(decode.SlotDecodeEngine, "admit", broken_admit)
    s = _server(lm[2], None, warm=True, warm_async=True)
    try:
        for t in threading.enumerate():
            if t.name == "serving-warmup":
                t.join(timeout=60)
                assert not t.is_alive()
        assert not s.ready
        assert _call(s, "/healthz")[0] == 503
    finally:
        s.stop()
    with pytest.raises(RuntimeError, match="warm-up decode failed"):
        server.GenerationServer("lm", lm[2], port=0, host="127.0.0.1",
                                max_new_tokens=MAX_NEW, warm=True)


# -- the deployment's command line and its load generator ---------------------


def _manifest_command():
    with open(os.path.join(REPO_ROOT, "demo", "serving",
                           "lm-serving.yaml")) as f:
        deployment = next(yaml.safe_load_all(f))
    return deployment["spec"]["template"]["spec"]["containers"][0]["command"]


def test_launcher_takes_the_deployment_command_line():
    """lm-serving.yaml's command, read from the file, parses as
    written; with the widths cut for the CPU (vocab 256 for the byte
    tokenizer), --device cpu and --port 0 appended, it builds the int8
    server (int8 KV cache, int8 projections, byte tokenizer) and warms
    it up in the background before it serves text."""
    command = _manifest_command()
    assert command[:2] == ["python3", "/demos/serving/serve.py"]
    argv = command[2:]
    args = serve.build_parser().parse_args(argv)
    assert (args.kv_cache_dtype, args.quantize_weights, args.tokenizer,
            args.warm, args.num_kv_heads, args.pos_embedding) == (
                "int8", "int8", "byte", True, 2, "rope")
    small = ["--vocab-size=256", "--embed-dim=32", "--num-layers=2",
             "--num-heads=4", "--max-seq-len=64", "--max-new-tokens=8",
             "--max-batch=2", "--device=cpu", "--port=0"]
    s = serve.build_server(serve.build_parser().parse_args(argv + small))
    s.start()
    try:
        model = s.engine._model
        assert model.kv_cache_dtype == "int8" and model.weights == "int8"
        assert s.engine.kv_quant == "int8" and len(s.engine._cache[0]) == 4
        assert sum(isinstance(m, quantized.Int8Linear)
                   for m in model.modules()) == 10
        deadline = time.monotonic() + 60
        while _call(s, "/healthz")[0] != 200:
            assert time.monotonic() < deadline, "warm-up did not finish"
            time.sleep(0.02)
        code, body = _generate(s, {"text": ["Hello"], "max_new_tokens": 4})
        assert code == 200 and len(body["completions"]) == 1
        stats = _call(s, "/stats")[1]
        assert stats["kv_quant_mode"] == "int8"
        assert stats["requests_retired"] == 1
    finally:
        s.stop()


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "load_generator",
        os.path.join(REPO_ROOT, "demo", "serving", "load_generator.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("stream", [False, True], ids=["json", "ndjson"])
def test_load_generator_payloads_are_served(srv, capsys, stream):
    """demo/serving/load_generator.py --mode generate (random prompt
    lengths, greedy and sampled rows, --stream) against the server:
    every request answered."""
    argv = ["--mode", "generate", "--model-name", "lm", "--host",
            "127.0.0.1", "--port", str(srv.port), "-n", "8",
            "--parallelism", "2", "--max-prompt-len", "16",
            "--max-new-tokens", "4", "--vocab-size", "64"]
    _load_generator().main(argv + (["--stream"] if stream else []))
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["requests"] == 8 and summary["errors"] == 0, summary
    if stream:
        assert summary["ttfb_p50_ms"] > 0
    assert srv.engine.pool_leak_report() is None

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
bodies.
"""

import json
import os
import threading
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
from tests import torch_parity

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


def _server(port_model, paged_env):
    """A started server, built with CEA_TPU_PAGED_KV set to
    ``paged_env`` (None: unset, the default pool)."""
    prev = os.environ.pop(decode.PAGED_KV_ENV, None)
    if paged_env is not None:
        os.environ[decode.PAGED_KV_ENV] = paged_env
    try:
        s = server.GenerationServer("lm", port_model, port=0,
                                    max_new_tokens=MAX_NEW, max_batch=4,
                                    host="127.0.0.1")
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
    code, body = _generate(srv, {"prompts": [[1, 2]], "stream": True})
    assert code == 400 and "not yet ported" in body["error"]
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


def test_launcher_builds_a_cpu_server_and_refuses_the_rest():
    flags = ["--vocab-size", "64", "--embed-dim", "32", "--num-layers",
             "1", "--num-heads", "4", "--num-kv-heads", "2",
             "--pos-embedding", "rope", "--max-seq-len", "48",
             "--max-new-tokens", "4", "--max-batch", "2", "--port", "0"]
    parser = serve.build_parser()
    assert parser.parse_args([]).device == "cuda"
    s = serve.build_server(parser.parse_args(flags + ["--device", "cpu"]))
    try:
        assert s.engine.slots == 2 and s.engine.device.type == "cpu"
    finally:
        s.stop()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            serve.build_server(parser.parse_args(flags))
    for extra in (["--kv-cache-dtype", "int8"],
                  ["--quantize-weights", "int8"],
                  ["--attention-window", "16"]):
        with pytest.raises(ValueError, match="not yet ported"):
            serve.build_server(parser.parse_args(
                flags + ["--device", "cpu"] + extra))
    with pytest.raises(SystemExit, match="model-dir"):
        serve.build_server(parser.parse_args(
            flags + ["--device", "cpu", "--model-dir", "/ckpt"]))


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

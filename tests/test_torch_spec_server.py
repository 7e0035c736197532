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

"""The port's GenerationServer with a draft model (``speculative_k``),
on the CPU: the counterparts of tests/test_serving.py's speculative
server tests on their fixtures (f32 target vocab 64, E 32, 2 layers, 4
heads from PRNGKey(1); draft E 16, 1 layer, 2 heads from PRNGKey(2)),
and the launcher's ``--speculative-k`` flags.

Greedy responses of a speculative server equal the plain server's and
the JAX package's decode() token for token; sampled and penalized rows
take the single-token lane and move no speculation counter; warm-up's
drafting rows leave /stats zeroed; streams carry 1..k tokens a step
whose concatenation is the unstreamed response.
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.serving import serve
from container_engine_accelerators_tpu_torch.serving import server
from tests import torch_parity


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _lm(seed, embed=32, layers=2, heads=4, seq=48, **options):
    return torch_parity.flax_lm_of(seed, vocab_size=64, embed_dim=embed,
                                   num_layers=layers, num_heads=heads,
                                   max_seq_len=seq, **options)


@pytest.fixture(scope="module")
def target():
    model, tree, config = _lm(1)
    return model, tree, torch_parity.port_lm(config, tree)


@pytest.fixture(scope="module")
def draft():
    _, tree, config = _lm(2, embed=16, layers=1, heads=2)
    return torch_parity.port_lm(config, tree)


def _server(model, **kwargs):
    s = server.GenerationServer("lm", model, port=0, max_new_tokens=8,
                                max_batch=2, buckets=kwargs.pop("buckets",
                                                                [8]),
                                host="127.0.0.1", **kwargs)
    s.start()
    return s


def _post(srv, payload):
    req = urllib.request.urlopen(
        f"http://127.0.0.1:{srv.port}/v1/models/lm:generate",
        data=json.dumps(payload).encode(), timeout=120)
    return json.loads(req.read())


def _stream(srv, payload):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/v1/models/lm:generate",
            data=json.dumps(dict(payload, stream=True)).encode(),
            timeout=120) as resp:
        return [json.loads(line) for line in resp.read().splitlines()]


def _stats(srv):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats",
                                timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def servers(target, draft):
    plain = _server(target[2])
    spec = _server(target[2], draft_model=draft, speculative_k=4)
    yield plain, spec
    plain.stop()
    spec.stop()


def test_generate_speculative_greedy_path(servers, target):
    """Greedy requests draft and verify inside the engine and return
    exactly what the plain server (and JAX decode()) returns; sampled
    and penalized rows move no speculation counter."""
    plain, spec = servers
    model, tree, _ = target
    for payload in ({"prompts": [[1, 2, 3]], "max_new_tokens": 6},
                    {"prompts": [[1, 2, 3]], "max_new_tokens": 6,
                     "eos_id": 7},
                    {"prompts": [[4, 5, 6, 7, 8]], "max_new_tokens": 8}):
        got = _post(spec, payload)["sequences"]
        assert got == _post(plain, payload)["sequences"], payload
        if "eos_id" not in payload:
            prompt = jnp.asarray(payload["prompts"], jnp.int32)
            assert got == np.asarray(jax_decode.decode(
                model, tree, prompt, payload["max_new_tokens"])).tolist()
    stats = _stats(spec)
    assert stats["spec_steps"] >= 3, stats
    assert stats["spec_proposed_tokens"] > 0, stats
    assert stats["draft_prefills"] >= 3, stats
    for payload in ({"prompts": [[1, 2, 3]], "max_new_tokens": 4,
                     "temperature": 0.9},
                    {"prompts": [[1, 2, 3]], "max_new_tokens": 4,
                     "temperature": 0.9, "top_p": 0.8},
                    {"prompts": [[1, 2, 3]], "max_new_tokens": 4,
                     "repetition_penalty": 1.3}):
        assert len(_post(spec, payload)["sequences"][0]) == 7
    stats2 = _stats(spec)
    for key in ("spec_proposed_tokens", "spec_accepted_tokens",
                "draft_prefills"):
        assert stats2[key] == stats[key], (key, stats2)
    assert spec.engine.pool_leak_report() is None


def test_generate_speculative_serves_logprobs(servers):
    """Greedy logprobs requests draft (the verify logits score the
    committed tokens) and equal the plain server's response."""
    plain, spec = servers
    before = _stats(spec)["spec_steps"]
    payload = {"prompts": [[1, 2, 3]], "max_new_tokens": 6,
               "logprobs": True}
    a, b = _post(plain, payload), _post(spec, payload)
    assert a["sequences"] == b["sequences"]
    np.testing.assert_allclose(a["logprobs"], b["logprobs"], rtol=0,
                               atol=1e-4)
    assert _stats(spec)["spec_steps"] > before


def test_generate_speculative_filtered_topk1_is_greedy(servers):
    """A top_k 1 sampled row (the single-token lane: no draft prefill,
    no proposal) reproduces the drafted greedy output."""
    _, spec = servers
    greedy = _post(spec, {"prompts": [[1, 2, 3]], "max_new_tokens": 6})
    stats = _stats(spec)
    topk1 = _post(spec, {"prompts": [[1, 2, 3]], "max_new_tokens": 6,
                         "temperature": 1.0, "top_k": 1})
    assert greedy["sequences"] == topk1["sequences"]
    stats2 = _stats(spec)
    assert stats2["spec_proposed_tokens"] == stats["spec_proposed_tokens"]
    assert stats2["draft_prefills"] == stats["draft_prefills"]


def test_stream_on_spec_server_matches_plain_greedy(servers):
    """A verify step commits 1..k tokens; the stream's tokens, in
    order, are the unstreamed response's, and the stream ends at its
    budget even when a step accepted more."""
    _, spec = servers
    before = _stats(spec)["draft_prefills"]
    one = _post(spec, {"prompts": [[1, 2, 3]], "max_new_tokens": 6})
    lines = _stream(spec, {"prompts": [[1, 2, 3]], "max_new_tokens": 6})
    assert [t for line in lines[:-1] for t in line["tokens"]] == (
        one["sequences"][0][3:])
    assert lines[-1] == {"done": True}
    assert _stats(spec)["draft_prefills"] == before + 2


def test_generate_speculative_warm_and_acceptance_telemetry(target,
                                                           monkeypatch):
    """A self-draft server with warm-up: the warm rows drafted (their
    draft prefills ran) but /stats opens with a zeroed speculation
    surface; one request's acceptance is then at or near 1 (the floor
    of the JAX tool's gate, 0.5) and more than one token commits a
    step."""
    warm_drafts = []
    real_reset = server._EngineService.reset_counters

    def spy(self):
        warm_drafts.append((self._engine.draft_prefills,
                            self._engine.spec_steps))
        real_reset(self)

    monkeypatch.setattr(server._EngineService, "reset_counters", spy)
    s = _server(target[2], buckets=[8, 16], draft_model=target[2],
                speculative_k=4, warm=True)
    try:
        # One drafting warm row a bucket, each verifying at least once.
        assert warm_drafts[0][0] == 2 and warm_drafts[0][1] >= 2
        stats0 = _stats(s)
        for key in ("spec_steps", "spec_proposed_tokens", "draft_prefills"):
            assert stats0[key] == 0, key
        assert stats0["speculative_acceptance_rate"] is None
        for payload in ({"prompts": [[1, 2, 3]], "max_new_tokens": 4,
                         "repetition_penalty": 1.3},
                        {"prompts": [[1, 2, 3]], "max_new_tokens": 4,
                         "temperature": 0.9, "top_k": 8}):
            assert len(_post(s, payload)["sequences"][0]) == 7
        assert _stats(s)["draft_prefills"] == 0
        _post(s, {"prompts": [[1, 2, 3]], "max_new_tokens": 8})
        stats = _stats(s)
        assert stats["draft_prefills"] == 1
        rate = stats["speculative_acceptance_rate"]
        assert rate is not None and 0.5 <= rate <= 1.0, stats
        assert stats["spec_accepted_tokens"] <= stats["spec_proposed_tokens"]
        assert stats["accepted_tokens_per_step"] > 1.0, stats
    finally:
        s.stop()


def test_generate_speculative_tight_headroom_gates_per_row():
    """max_seq_len 16 = bucket 8 + max_new 8: a full-horizon row drafts
    while pos + k fits its span and finishes single-token in the same
    chunk; the response equals JAX decode()."""
    model, tree, config = _lm(1, seq=16)
    port = torch_parity.port_lm(config, tree)
    s = _server(port, draft_model=port, speculative_k=4)
    try:
        prompt = [4, 5, 6, 7, 8, 9, 10, 11]
        out = _post(s, {"prompts": [prompt], "max_new_tokens": 8})
        want = jax_decode.decode(model, tree, jnp.asarray([prompt],
                                                          jnp.int32), 8)
        assert out["sequences"][0] == np.asarray(want)[0].tolist()
        stats = _stats(s)
        assert stats["spec_steps"] >= 1 and stats["spec_proposed_tokens"] > 0
        assert stats["spec_accepted_tokens"] <= stats["spec_proposed_tokens"]
    finally:
        s.stop()


def test_generate_speculative_windowed_model_routes_spec(draft):
    """A windowed target (W 8) beside a dense draft drafts and returns
    the plain windowed server's responses; a windowed draft is refused
    at construction."""
    _, tree, config = _lm(1, attention_window=8)
    port = torch_parity.port_lm(config, tree)
    with pytest.raises(ValueError, match="dense cache"):
        server.GenerationServer("lm", port, port=0, max_new_tokens=8,
                                max_batch=2, buckets=[8],
                                host="127.0.0.1", draft_model=port,
                                speculative_k=4)
    plain = _server(port)
    spec = _server(port, draft_model=draft, speculative_k=4)
    try:
        for payload in ({"prompts": [[1, 2, 3]], "max_new_tokens": 8},
                        {"prompts": [[1, 2, 3]], "max_new_tokens": 8,
                         "eos_id": 7},
                        {"prompts": [[4, 5, 6, 7, 8, 9, 10, 11]],
                         "max_new_tokens": 8}):
            assert (_post(plain, payload)["sequences"]
                    == _post(spec, payload)["sequences"]), payload
        stats = _stats(spec)
        assert stats["spec_steps"] >= 3 and stats["spec_proposed_tokens"] > 0
    finally:
        plain.stop()
        spec.stop()


def test_server_refuses_what_speculation_cannot_serve(target, draft):
    """Construction-time checks (a replica refuses to build):
    speculative_k without a draft, a negative k, a vocab mismatch; k 1
    builds the draft-free engine."""
    port = target[2]
    _, tree, config = torch_parity.flax_lm_of(
        2, vocab_size=32, embed_dim=16, num_layers=1, num_heads=2,
        max_seq_len=48)
    narrow = torch_parity.port_lm(config, tree)
    for kwargs, match in ((dict(speculative_k=4), "requires draft_model"),
                          (dict(draft_model=draft, speculative_k=-1),
                           ">= 1"),
                          (dict(draft_model=narrow, speculative_k=4),
                           "draft vocab")):
        with pytest.raises(ValueError, match=match):
            server.GenerationServer("lm", port, port=0, max_new_tokens=8,
                                    max_batch=2, buckets=[8],
                                    host="127.0.0.1", **kwargs)
    s = _server(port, draft_model=draft, speculative_k=1)
    try:
        assert s.engine._draft_model is None
        out = _post(s, {"prompts": [[1, 2, 3]], "max_new_tokens": 4})
        assert out["sequences"][0] == decode.greedy_decode(
            port, torch.tensor([[1, 2, 3]]), 4)[0].tolist()
    finally:
        s.stop()


def test_launcher_speculative_flags(capsys):
    """``--speculative-k`` builds the demo's draft (``--draft-layers``,
    ``--draft-embed-dim``, ``--draft-num-heads`` or the target's,
    seed + 1), validated with the demo's messages;
    ``--draft-model-dir`` restores the draft (its empty case here)."""
    flags = ["--model", "transformer", "--vocab-size", "64",
             "--embed-dim", "32", "--num-layers",
             "1", "--num-heads", "4", "--pos-embedding", "rope",
             "--max-seq-len", "48", "--max-new-tokens", "4",
             "--max-batch", "2", "--port", "0", "--device", "cpu",
             "--model-name", "lm"]
    parser = serve.build_parser()
    defaults = parser.parse_args([])
    assert (defaults.speculative_k, defaults.draft_layers,
            defaults.draft_embed_dim, defaults.draft_num_heads) == (
                0, 2, 128, 0)
    s = serve.build_server(parser.parse_args(
        flags + ["--speculative-k", "4", "--draft-embed-dim", "16",
                 "--seed", "3"]))
    s.start()
    try:
        d = s.engine._draft_model
        assert s.engine._spec_k == 4
        assert (d.num_layers, d.embed_dim, d.num_heads, d.num_kv_heads,
                d.pos_embedding, d.max_seq_len) == (2, 16, 4, None, "rope",
                                                    48)
        config = dict(vocab_size=64, embed_dim=16, num_layers=2,
                      num_heads=4, pos_embedding="rope", max_seq_len=48)
        want = convert.load_lm(config, convert.init_flax_layout_params(
            config, 4), device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            d.state_dict().values(), want.state_dict().values()))
        out = _post(s, {"prompts": [[1, 2, 3]], "max_new_tokens": 4})
        assert len(out["sequences"][0]) == 7
        assert s.stats()["draft_prefills"] == 1
    finally:
        s.stop()
    with pytest.raises(SystemExit, match="not divisible by draft heads 3"):
        serve.build_server(parser.parse_args(
            flags + ["--speculative-k", "4", "--draft-num-heads", "3"]))
    # Ported: a draft directory without a finished checkpoint serves the
    # random draft (seed + 1) with the demo launcher's message; the
    # trained draft is tests/test_torch_serve_checkpoint.py's.
    s = serve.build_server(parser.parse_args(
        flags + ["--speculative-k", "4", "--draft-embed-dim", "16",
                 "--seed", "3", "--draft-model-dir", "/ckpt"]))
    try:
        assert all(torch.equal(a, b) for a, b in zip(
            s.engine._draft_model.state_dict().values(),
            want.state_dict().values()))
    finally:
        s.stop()
    assert ("no checkpoints under '/ckpt'; serving initialized weights"
            in capsys.readouterr().err)

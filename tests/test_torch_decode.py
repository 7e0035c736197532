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

"""The port's samplers, greedy oracle and dense slot engine against
the JAX package's models/decode.py, in f32 on the CPU.

Masks and greedy tokens must be identical. Logprobs agree at 1e-4
(log-softmax over two layers' worth of reduction-order noise).
Sampled rows draw from a torch.Generator, not from threefry, so they
are held to the JAX chain's distribution (and the Gumbel-max draw to
its formula on injected uniforms), never to JAX's stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu_torch.models import decode
from tests import torch_parity

LP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _logits(seed, shape=(6, 64)):
    rng = np.random.default_rng(seed)
    return (3.0 * rng.standard_normal(shape)).astype(np.float32)


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_repetition_penalty_matches_jax():
    logits = _logits(0)
    seen = np.random.default_rng(1).random(logits.shape) < 0.3
    pen = np.array([1.0, 1.3, 0.7, 2.0, 1.0, 5.0], np.float32)
    _same(decode._apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(seen),
        torch.from_numpy(pen)),
        jax_decode._apply_repetition_penalty(logits, seen, pen))


@pytest.mark.parametrize("mask,knob", [
    ("_mask_top_k_rows", np.array([0, 1, 5, 17, 64, 3], np.int64)),
    ("_mask_top_p", np.array([1.0, 0.9, 0.5, 0.05, 0.99, 0.7],
                             np.float32)),
    ("_mask_min_p", np.array([0.0, 0.1, 0.5, 0.01, 0.9, 0.3],
                             np.float32)),
])
def test_sampler_masks_match_jax(mask, knob):
    """Identical masks. The one exception is a top_p = 1.0 row: there
    both versions compare a cumulative sum that rounds to about 1.0
    against 1.0, so each may drop tail tokens of mass below 1e-6 (the
    cumulative sums' rounding) that the other keeps."""
    for seed in range(3):
        logits = _logits(seed)
        want = np.asarray(getattr(jax_decode, mask)(jnp.asarray(logits),
                                                    jnp.asarray(knob)))
        got = getattr(decode, mask)(torch.from_numpy(logits),
                                    torch.from_numpy(knob)).numpy()
        assert np.isneginf(want).any()
        exact = knob < 1.0 if mask == "_mask_top_p" else knob == knob
        np.testing.assert_array_equal(got[exact], want[exact])
        probs = np.asarray(jax.nn.softmax(logits[~exact], axis=-1))
        differ = np.isneginf(got[~exact]) != np.isneginf(want[~exact])
        assert (probs[differ] < 1e-6).all()


def _jax_slot_sample(raw, seen, knobs):
    tok, lp, _ = jax_decode._slot_sample(
        jnp.asarray(raw), jnp.asarray(seen), jnp.asarray(knobs.temps),
        jnp.asarray(knobs.top_ks, jnp.int32), jnp.asarray(knobs.top_ps),
        jnp.asarray(knobs.min_ps), jnp.asarray(knobs.rep_pens),
        jax.random.split(jax.random.PRNGKey(0), raw.shape[0]))
    return np.asarray(tok), np.asarray(lp)


def test_slot_sample_greedy_rows_match_jax():
    """Greedy rows take the argmax of the penalised logits; every
    row's logprob scores its token under the RAW logits."""
    raw = _logits(4)
    seen = np.random.default_rng(5).random(raw.shape) < 0.2
    knobs = decode.SamplingKnobs(raw.shape[0])
    for row, pen in enumerate((1.0, 1.5, 3.0, 0.5, 1.0, 2.0)):
        knobs.set(row, repetition_penalty=pen)
    want_tok, want_lp = _jax_slot_sample(raw, seen, knobs)
    got_tok, got_lp = decode._slot_sample(
        torch.from_numpy(raw), torch.from_numpy(seen), knobs,
        [None] * raw.shape[0])
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    np.testing.assert_allclose(got_lp.numpy(), want_lp, rtol=0,
                               atol=1e-6)


def test_gumbel_draw_on_injected_uniforms():
    logits = _logits(6)
    u = np.random.default_rng(7).random(logits.shape).astype(np.float32)
    want = jnp.argmax(logits - jnp.log(-jnp.log(u)), axis=-1)
    got = decode._gumbel_argmax(torch.from_numpy(logits),
                                torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_rows_follow_the_jax_chain_distribution():
    """4096 rows, each with its own generator, sample one filtered
    distribution (temperature, top_k, top_p, min_p, penalty); the
    empirical frequencies match softmax of the JAX chain's filtered
    logits within 0.03 (binomial sd <= 0.008 at this count)."""
    n = 4096
    raw = np.tile(_logits(8, (1, 64)) / 3.0, (n, 1))
    seen = np.zeros(raw.shape, bool)
    seen[:, :8] = True
    knobs = decode.SamplingKnobs(n)
    for row in range(n):
        knobs.set(row, temperature=0.7, top_k=12, top_p=0.95, min_p=0.02,
                  repetition_penalty=1.2)
    gens = [torch.Generator().manual_seed(row) for row in range(n)]
    tok, lp = decode._slot_sample(torch.from_numpy(raw),
                                  torch.from_numpy(seen), knobs, gens)
    pen = jax_decode._apply_repetition_penalty(
        jnp.asarray(raw[:1]), jnp.asarray(seen[:1]), jnp.float32(1.2))
    scaled = pen / 0.7
    scaled = jax_decode._mask_top_k_rows(scaled, jnp.array([12]))
    scaled = jax_decode._mask_top_p(scaled, jnp.array([0.95]))
    scaled = jax_decode._mask_min_p(scaled, jnp.array([0.02]))
    want = np.asarray(jax.nn.softmax(scaled, axis=-1))[0]
    freq = np.bincount(tok.numpy(), minlength=64) / n
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(want))
    assert np.abs(freq - want).max() < 0.03
    lsm = np.asarray(jax.nn.log_softmax(raw[0]))
    np.testing.assert_allclose(lp.numpy(), lsm[tok.numpy()], atol=1e-6)


@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_greedy_decode_matches_jax_decode(variant):
    model, tree, config = torch_parity.flax_lm(variant)
    port = torch_parity.port_lm(config, tree)
    prompt = torch_parity.tokens(9, (2, 7))
    want = jax_decode.decode(model, tree, jnp.asarray(prompt), 8)
    got = decode.greedy_decode(port, torch.from_numpy(prompt), 8)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 15)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module", params=sorted(torch_parity.VARIANTS))
def engines(request):
    model, tree, config = torch_parity.flax_lm(request.param)
    want = jax_decode.SlotDecodeEngine(model, tree, slots=3, slot_len=24,
                                       paged=False, buckets=[8, 16])
    got = decode.SlotDecodeEngine(torch_parity.port_lm(config, tree),
                                  slots=3, slot_len=24, paged=False,
                                  buckets=[8, 16])
    return want, got


def test_dense_engine_matches_jax_engine(engines):
    """A mixed-bucket admit/step/release script: greedy rows (one with
    a repetition penalty, one ragged in its bucket) and one sampled row
    share the pool. Greedy rows are token-identical to the JAX dense
    engine's, logprobs (echo included) at 1e-4; the sampled row only
    has to produce valid tokens (its stream is the generator's)."""
    want_eng, got_eng = engines
    prompts = {
        "a": (torch_parity.tokens(10, (8,)), 5, {}),
        "b": (torch_parity.tokens(11, (16,)), 11,
              {"repetition_penalty": 1.3}),
        "c": (torch_parity.tokens(12, (8,)), 3, {}),
        "s": (torch_parity.tokens(13, (8,)), 8,
              {"temperature": 0.9, "top_k": 10, "seed": 3}),
    }
    script = ["a", 2, "b", "s", 3, "-a", "c", 4, "-s", "-b", 2, "-c"]
    slots = {}
    for op in script:
        if isinstance(op, int):
            for _ in range(op):
                want_tok, want_lp = want_eng.step()
                got_tok, got_lp = got_eng.step()
                for name, slot in slots.items():
                    if name == "s":
                        assert 0 <= got_tok[slot] < torch_parity.TINY[
                            "vocab_size"]
                        continue
                    assert got_tok[slot] == want_tok[slot], (name, slot)
                    np.testing.assert_allclose(got_lp[slot], want_lp[slot],
                                               rtol=0, atol=LP_TOL)
        elif op.startswith("-"):
            want_eng.release(slots[op[1:]])
            got_eng.release(slots.pop(op[1:]))
        else:
            row, p_len, knobs = prompts[op]
            w = want_eng.admit(row, p_len, **knobs)
            g = got_eng.admit(row, p_len, **knobs)
            assert g[0] == w[0]
            slots[op] = g[0]
            if op != "s":
                assert g[1] == w[1]
                np.testing.assert_allclose(g[2], w[2], rtol=0, atol=LP_TOL)
            np.testing.assert_allclose(g[3][:p_len], np.asarray(w[3])[:p_len],
                                       rtol=0, atol=LP_TOL)
    assert got_eng.active_count() == 0 and got_eng.free_slots() == 3
    assert got_eng.prefill_widths == {8: 3, 16: 1}
    score_want = want_eng.score(prompts["b"][0], 11)
    score_got = got_eng.score(prompts["b"][0], 11)
    np.testing.assert_allclose(score_got[:11], score_want[:11], rtol=0,
                               atol=LP_TOL)


def test_full_pool_and_unported_options_raise(engines):
    """A full dense pool refuses another admission; the paged pool,
    pin_reserve_tokens, the quantized caches and a draft model build
    (tests/test_torch_paging.py, tests/test_torch_quant.py and
    tests/test_torch_spec_engine.py hold them to the JAX engine), and a
    draft with a verify chunk narrower than 2 raises."""
    _, eng = engines
    row = torch_parity.tokens(14, (8,))
    for _ in range(3):
        eng.admit(row, 8)
    assert eng.admission_block_cause(row, 8) == "slots"
    assert not eng.can_admit(row, 8)
    with pytest.raises(decode.EngineCapacityError):
        eng.admit(row, 8)
    assert eng.pool_leak_report() == {"active_rows": [0, 1, 2]}
    assert eng.force_reclaim() is None
    assert eng.block_availability() is None
    model = eng._model
    paged = decode.SlotDecodeEngine(model, 2, 16, paged=True,
                                    pin_reserve_tokens=8)
    assert paged.paged and paged.block_availability() == (2 + 1, 2 + 1)
    for kwargs in (dict(kv_quant="int8"), dict(kv_quant="int4", paged=False)):
        quantized = decode.SlotDecodeEngine(model, 2, 16, **kwargs)
        assert quantized.kv_quant == kwargs["kv_quant"]
        assert len(quantized._cache[0]) == 4
    spec = decode.SlotDecodeEngine(model, 2, 16, paged=True,
                                   draft_model=model, spec_k=2)
    assert spec.kv_block_stats()["spec_kv_blocks_total"] == 2
    with pytest.raises(ValueError, match="spec_k must be >= 2"):
        decode.SlotDecodeEngine(model, 2, 16, draft_model=model, spec_k=1)


def test_paged_env_gate_raises(monkeypatch):
    """CEA_TPU_PAGED_KV selects the pool as in the JAX package: paged
    when unset or on, dense at 0; an explicit ``paged`` wins."""
    _, tree, config = torch_parity.flax_lm("learned_mha")
    port = torch_parity.port_lm(config, tree)
    monkeypatch.delenv(decode.PAGED_KV_ENV, raising=False)
    assert decode.paged_kv_enabled() and decode.kv_spill_enabled()
    eng = decode.SlotDecodeEngine(port, 2, 16)
    assert eng.paged and eng._pool.spill_enabled()
    assert eng._block_size == 16 and eng._pool.usable == 2
    monkeypatch.setenv(decode.PAGED_KV_ENV, "1")
    assert decode.SlotDecodeEngine(port, 2, 16).paged
    monkeypatch.setenv(decode.PAGED_KV_ENV, "0")
    assert not decode.SlotDecodeEngine(port, 2, 16).paged
    assert decode.SlotDecodeEngine(port, 2, 16, paged=True).paged
    with pytest.raises(ValueError, match="kv_blocks"):
        decode.SlotDecodeEngine(port, 2, 16, paged=True, kv_blocks=1)


def _tree(spans):
    """{span name: [(record, [child records])]}."""
    kids = {}
    for s in spans:
        kids.setdefault(s["parent_id"], []).append(s)
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append((s, kids.get(s["span_id"], [])))
    return out


@pytest.mark.parametrize("window", [0, 8])
def test_admission_and_step_spans(window):
    """The engine's spans through the serving loop, on the CPU: an
    admission is ``serving.prefill`` (the prompt, its prefix hit and the
    padded width, set by the engine) over the prefix gather, the chunk's
    forward (one ``model.attention`` a layer), the first token and the
    KV insert; a
    step is ``serving.engine_step`` over the host's upkeep, the forward
    (slots x span keys attended, the live ones counted from the rows'
    positions) and the sampling. Device spans read their own duration
    on the CPU. The same prompt twice hits the prefix index."""
    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM)
    from container_engine_accelerators_tpu_torch.serving import server

    torch.manual_seed(0)
    model = TransformerLM(vocab_size=64, embed_dim=32, num_layers=2,
                          num_heads=4, num_kv_heads=2, max_seq_len=64,
                          pos_embedding="rope", attention_window=window,
                          dtype=torch.float32, device="cpu")
    eng = decode.SlotDecodeEngine(model, 2, 32, paged=True, kv_block_size=4,
                                  buckets=[8, 16], kv_quant="bf16",
                                  kv_spill=False)
    obs.TRACER.reset()
    svc = server._EngineService(eng, server._Admission(0))
    try:
        for _ in range(2):
            row = np.zeros((16,), np.int32)
            row[:9] = np.arange(1, 10)
            work = server._EngineWork(row, 9, 3, 0.0, 0, 1.0, 0.0, 1.0, -1,
                                      False, 0, None)
            assert svc.submit_many([work]) is not None
            assert work.done.get(timeout=60)[0] == "ok"
    finally:
        svc.stop()
    spans = obs.TRACER.snapshot()["spans"]
    tree = _tree(spans)

    def cap(pos):
        return min(pos + 1, window) if window else pos + 1

    prefills = tree["serving.prefill"]
    assert [p["attrs"] for p, _ in prefills] == [
        {"phase": "engine_admission", "prompt_tokens": 9,
         "shared_tokens": shared, "width": width}
        for shared, width in ((0, 16), (8, 8))]
    for _, kids in prefills:
        assert [k["name"] for k in kids] == [
            "engine.prefix_gather", "engine.prefill_forward",
            "engine.first_token", "engine.kv_insert"]
        assert [k["attrs"] for k in kids] == [{}] * 4
        fwd = kids[1]
        (_, attn), = [t for t in tree["engine.prefill_forward"]
                      if t[0] is fwd]
        assert [a["name"] for a in attn] == ["model.attention"] * 2
    steps = tree["serving.engine_step"]
    assert len(steps) == 4
    for step, kids in steps:
        assert step["attrs"] == {}
        assert [k["name"] for k in kids] == [
            "engine.prestep", "engine.forward", "engine.sample"]
        assert kids[0]["attrs"] == kids[2]["attrs"] == {}
        fwd = kids[1]["attrs"]
        assert fwd["keys_attended"] == 2 * 32
        assert 0 < fwd["keys_live"] <= fwd["keys_attended"]
    # One row at positions 9 and 10 in each request's two steps.
    assert [s["attrs"]["keys_live"] for s, _ in tree["engine.forward"]] == [
        cap(9), cap(10)] * 2
    assert len(tree["model.attention"]) == 2 * (2 + 4)
    for s in spans:
        if s["name"].startswith(("engine.", "model.")) and (
                s["name"] != "engine.prestep"):
            assert s["device_s"] == s["duration_s"] > 0, s["name"]
        else:
            assert "device_s" not in s, s["name"]


@pytest.mark.parametrize("paged", [False, True])
def test_score_gives_the_callers_span_the_prefill_width(paged):
    """``score`` (as ``admit``) hands the caller's admission span the
    prefill's prefix hit and padded width: the row's own length on the
    dense pool, the bucket on the paged one. The echo is the same with
    and without a span."""
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM)
    from container_engine_accelerators_tpu_torch.obs import trace

    torch.manual_seed(0)
    model = TransformerLM(vocab_size=64, embed_dim=32, num_layers=2,
                          num_heads=4, num_kv_heads=2, max_seq_len=64,
                          pos_embedding="rope", dtype=torch.float32,
                          device="cpu")
    kw = (dict(paged=True, kv_block_size=4, buckets=[8, 16], kv_spill=False)
          if paged else dict(paged=False))
    eng = decode.SlotDecodeEngine(model, 2, 32, **kw)
    row = np.zeros((12,), np.int32)
    row[:9] = np.arange(1, 10)
    tracer = trace.Tracer(enabled=True)
    with tracer.span("serving.prefill") as sp:
        echo = eng.score(row, 9, span=sp)
    (rec,) = tracer.snapshot()["spans"]
    assert rec["attrs"] == {"shared_tokens": 0, "width": 16 if paged else 12}
    np.testing.assert_array_equal(echo, eng.score(row, 9))

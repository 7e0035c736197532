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

"""The port's single-request decoding against the JAX package's
models/decode.py on the same params, in f32 on the CPU: ``decode``,
``prefill_prefix``/``decode_with_prefix``, ``stream_decode`` and
``beam_search``, each without a window, with one (W 6, 8 or 24: a ring
that wraps, and one that does not) and with the int8 cache.

Greedy tokens and beam sequences must be identical. Logprobs and beam
scores agree at 1e-4 (two layers of f32 reduction order through a
log-softmax and a sum over at most 12 tokens). Sampled paths draw from
a torch.Generator, not threefry: they are held to the JAX functions on
the JAX chain's own uniforms (injected through ``uniforms``), token
for token, and a generator's draws to the chain's distribution.
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
VARIANTS = sorted(torch_parity.VARIANTS)
CONFIGS = {"dense": {}, "window6": {"attention_window": 6},
           "window24": {"attention_window": 24},
           "int8": {"kv_cache_dtype": "int8"},
           "window8_int8": {"attention_window": 8, "kv_cache_dtype": "int8"}}


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(variant, config="dense", **options):
    """(flax model, params, the port's model) with the options of
    CONFIGS[config] and ``options`` on both sides."""
    model, tree, base = torch_parity.flax_lm(variant)
    options = dict(CONFIGS[config], **options)
    return (model.clone(**options) if options else model, tree,
            torch_parity.port_lm(dict(base, **options), tree))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=LP_TOL)


class _JaxUniforms:
    """The uniforms the JAX sampling chain draws: each pick splits its
    key (``rng, sub = split(rng)``) and ``jax.random.categorical(sub,
    logits)`` adds Gumbel noise made from ``uniform(sub, shape, tiny,
    1)``. ``per_chunk``: stream_decode splits a fresh key for every
    chunk of that many picks first."""

    def __init__(self, key, per_chunk=None):
        self.rng, self.per_chunk, self.picks = key, per_chunk, 0
        self.chunk_rng = None

    def __call__(self, shape):
        if self.per_chunk is not None:
            if self.picks % self.per_chunk == 0:
                self.rng, self.chunk_rng = jax.random.split(self.rng)
            self.chunk_rng, sub = jax.random.split(self.chunk_rng)
        else:
            self.rng, sub = jax.random.split(self.rng)
        self.picks += 1
        return np.asarray(jax.random.uniform(
            sub, shape, jnp.float32, jnp.finfo(jnp.float32).tiny, 1.0))


def test_jax_categorical_is_gumbel_argmax_of_those_uniforms():
    """The reconstruction ``_JaxUniforms`` rests on."""
    key = jax.random.PRNGKey(3)
    logits = jnp.asarray(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    u = jax.random.uniform(key, logits.shape, jnp.float32,
                           jnp.finfo(jnp.float32).tiny, 1.0)
    _same(jax.random.categorical(key, logits, axis=-1),
          jnp.argmax(logits - jnp.log(-jnp.log(u)), axis=-1))


def test_pick_token_matches_the_jax_chain_on_injected_uniforms():
    """Temperature (per row), top_k, top_p, min_p, then the draw: the
    JAX chain's masks and categorical on the same uniforms."""
    rng = np.random.default_rng(1)
    logits = (3.0 * rng.standard_normal((6, 64))).astype(np.float32)
    temps = np.array([0.5, 0.9, 1.3, 0.7, 2.0, 1.0], np.float32)
    key = jax.random.PRNGKey(4)
    want, _ = jax_decode._pick_token(
        jnp.asarray(logits), key, jnp.asarray(temps), jnp.float32(0.9),
        jnp.float32(0.05), sample=True, top_k=10, use_top_p=True,
        use_min_p=True, out_dtype=jnp.int32)
    draws = _JaxUniforms(key)
    got = decode._pick_token(
        torch.from_numpy(logits), lambda shape: torch.tensor(
            draws(shape)), torch.from_numpy(temps), torch.tensor(0.9),
        torch.tensor(0.05), sample=True, top_k=10, use_top_p=True,
        use_min_p=True)
    _same(got, want)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_greedy_decode_matches_jax(variant, config):
    """The fast prefill (full-width rows) then steps: 9 + 14 tokens
    wrap a 6-slot ring (the prompt alone overruns it) and stay inside
    a 24-slot one. ``greedy_decode`` (the oracle) gives the same."""
    model, tree, port = _pair(variant, config)
    prompt = torch_parity.tokens(3, (2, 9))
    want = jax_decode.decode(model, tree, jnp.asarray(prompt), 14)
    got = decode.decode(port, prompt, 14)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 23)
    _same(got, want)
    _same(decode.greedy_decode(port, torch.from_numpy(prompt), 14), got)


@pytest.mark.parametrize("config", ["dense", "window6", "window8_int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ragged_prompt_len_eos_and_logprobs_match_jax(variant, config):
    """Right-padded rows of true lengths 4 and 9 (stepwise with the
    prompt takeover), an EOS that freezes rows, and logprobs (echo
    included)."""
    model, tree, port = _pair(variant, config)
    prompt = torch_parity.tokens(5, (2, 9))
    plen = np.array([4, 9])
    w_seq, w_lp = jax_decode.decode(model, tree, jnp.asarray(prompt), 12,
                                    prompt_len=jnp.asarray(plen), eos_id=7,
                                    return_logprobs=True)
    g_seq, g_lp = decode.decode(port, prompt, 12, prompt_len=plen,
                                eos_id=7, return_logprobs=True)
    _same(g_seq, w_seq)
    _close(g_lp, w_lp)


@pytest.mark.parametrize("config", ["dense", "window6", "int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_fast_prefill_logprobs_and_repetition_penalty_match_jax(variant,
                                                                 config):
    """The one-shot prefill's echo logprobs and a per-row repetition
    penalty (1.0 on one row, 1.6 on the other); and a per-row EOS on
    the fast path."""
    model, tree, port = _pair(variant, config)
    prompt = torch_parity.tokens(6, (2, 8))
    pen = np.array([1.0, 1.6], np.float32)
    w_seq, w_lp = jax_decode.decode(model, tree, jnp.asarray(prompt), 10,
                                    repetition_penalty=jnp.asarray(pen),
                                    return_logprobs=True)
    g_seq, g_lp = decode.decode(port, prompt, 10, repetition_penalty=pen,
                                return_logprobs=True)
    _same(g_seq, w_seq)
    _close(g_lp, w_lp)
    eos = np.array([int(w_seq[0, 10]), 3])
    _same(decode.decode(port, prompt, 10, eos_id=eos),
          jax_decode.decode(model, tree, jnp.asarray(prompt), 10,
                            eos_id=jnp.asarray(eos)))


@pytest.mark.parametrize("config", ["dense", "window6"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_sampled_decode_matches_jax_on_its_uniforms(variant, config):
    """Sampling with per-row temperatures, top_k, top_p and min_p, fast
    and stepwise: on the JAX chain's uniforms the tokens are JAX's."""
    model, tree, port = _pair(variant, config)
    prompt = torch_parity.tokens(7, (2, 7))
    knobs = dict(temperature=np.array([0.8, 1.2], np.float32), top_k=12,
                 top_p=0.9, min_p=0.02)
    for plen in (None, np.array([3, 7])):
        key = jax.random.PRNGKey(11)
        extra = {} if plen is None else {"prompt_len": jnp.asarray(plen)}
        want = jax_decode.decode(
            model, tree, jnp.asarray(prompt), 10, rng=key,
            temperature=jnp.asarray(knobs["temperature"]), top_k=12,
            top_p=0.9, min_p=0.02, **extra)
        got = decode.decode(port, prompt, 10, uniforms=_JaxUniforms(key),
                            prompt_len=plen, **knobs)
        _same(got, want)


def test_sampled_decode_follows_the_jax_chain_distribution():
    """2048 copies of one prompt draw their first token from a
    generator: the frequencies match softmax of the JAX chain's
    filtered logits within 0.035 (binomial sd <= 0.011)."""
    model, tree, port = _pair("rope_gqa", "window6")
    n = 2048
    prompt = np.tile(torch_parity.tokens(8, (1, 9)), (n, 1))
    got = decode.decode(port, prompt, 1, temperature=0.9, top_k=16,
                        top_p=0.95, min_p=0.01,
                        generator=torch.Generator().manual_seed(5))
    logits = model.apply({"params": tree}, jnp.asarray(prompt[:1]))[:, -1]
    scaled = jax_decode._mask_top_k(logits / 0.9, 16)
    scaled = jax_decode._mask_top_p(scaled, jnp.float32(0.95))
    scaled = jax_decode._mask_min_p(scaled, jnp.float32(0.01))
    want = np.asarray(jax.nn.softmax(scaled, axis=-1))[0]
    freq = np.bincount(got[:, -1].numpy(), minlength=64) / n
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(want))
    assert np.abs(freq - want).max() < 0.035


@pytest.mark.parametrize("config", ["dense", "window8_int8", "int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_prefix_fan_out_matches_jax(variant, config):
    """A 2-row prefix fanned out to 4 requests (row i continues prefix
    row i // 2): the fast chunk and a ragged stepwise suffix; the state
    serves two calls unchanged, and a continuation equals ``decode`` on
    the concatenated rows."""
    model, tree, port = _pair(variant, config)
    prefix = torch_parity.tokens(9, (2, 6))
    suffix = torch_parity.tokens(10, (4, 4))
    w_state = jax_decode.prefill_prefix(model, tree, jnp.asarray(prefix),
                                        max_total_len=22)
    g_state = decode.prefill_prefix(port, prefix, max_total_len=22)
    assert g_state[1:] == (6, 22)
    for kwargs in ({}, {"prompt_len": np.array([4, 2, 3, 4])}):
        jkw = {k: jnp.asarray(v) for k, v in kwargs.items()}
        want = jax_decode.decode_with_prefix(model, tree, w_state,
                                             jnp.asarray(suffix), 10, **jkw)
        for _ in range(2):
            _same(decode.decode_with_prefix(port, g_state, suffix, 10,
                                            **kwargs), want)
    full = np.concatenate([np.repeat(prefix, 2, axis=0), suffix], axis=1)
    _same(decode.decode_with_prefix(port, g_state, suffix, 10),
          decode.decode(port, full, 10)[:, 6:])


@pytest.mark.parametrize("variant", VARIANTS)
def test_windowed_prefix_chunk_slack_matches_jax(variant):
    """W 8: without slack a 5-token suffix cannot prefill as one chunk
    (the ring holds 8 < 8 + 5) and steps, and asking for the chunk
    raises; with chunk_slack 5 it chunks. A 24-slot window over 20
    tokens never wraps and chunks without slack. Tokens equal JAX's
    either way; sampling on the JAX chain's uniforms too."""
    model, tree, port = _pair(variant, attention_window=8)
    prefix = torch_parity.tokens(11, (1, 6))
    suffix = torch_parity.tokens(12, (3, 5))
    for slack in (0, 5):
        w_state = jax_decode.prefill_prefix(
            model, tree, jnp.asarray(prefix), max_total_len=21,
            chunk_slack=slack)
        g_state = decode.prefill_prefix(port, prefix, max_total_len=21,
                                        chunk_slack=slack)
        assert decode._ring_capacity(g_state[0]) == 8 + slack
        _same(decode.decode_with_prefix(port, g_state, suffix, 10),
              jax_decode.decode_with_prefix(model, tree, w_state,
                                            jnp.asarray(suffix), 10))
        key = jax.random.PRNGKey(slack)
        _same(decode.decode_with_prefix(port, g_state, suffix, 10,
                                        temperature=0.9, top_k=8,
                                        uniforms=_JaxUniforms(key)),
              jax_decode.decode_with_prefix(
                  model, tree, w_state, jnp.asarray(suffix), 10,
                  temperature=0.9, top_k=8, rng=key))
        if not slack:
            for fn, state, args in (
                    (decode.decode_with_prefix, g_state, (port,)),
                    (jax_decode.decode_with_prefix, w_state,
                     (model, tree))):
                with pytest.raises(ValueError, match="chunk_slack"):
                    fn(*args, state, suffix, 10, fast_prefill=True)
    with pytest.raises(ValueError, match="sliding-window"):
        decode.prefill_prefix(_pair(variant)[2], prefix, max_total_len=21,
                              chunk_slack=2)
    model24, _, port24 = _pair(variant, "window24")
    w_state = jax_decode.prefill_prefix(model24, tree, jnp.asarray(prefix),
                                        max_total_len=20)
    g_state = decode.prefill_prefix(port24, prefix, max_total_len=20)
    assert decode._ring_capacity(g_state[0]) == 20
    _same(decode.decode_with_prefix(port24, g_state, suffix, 9,
                                    fast_prefill=True),
          jax_decode.decode_with_prefix(model24, tree, w_state,
                                        jnp.asarray(suffix), 9))


def test_prefix_state_resident_count_and_refusals():
    """``return_state`` counts the resident tokens (the last sampled
    one is not yet in the cache) and continues exactly; the penalty
    and logprobs are not arguments of this path, as in JAX; an
    oversized continuation raises."""
    model, tree, port = _pair("rope_gqa", "window6")
    prefix = torch_parity.tokens(13, (1, 5))
    suffix = torch_parity.tokens(14, (2, 3))
    state = decode.prefill_prefix(port, prefix, max_total_len=24)
    seq, state2 = decode.decode_with_prefix(port, state, suffix, 6,
                                            return_state=True)
    assert state2[1:] == (5 + 3 + 6 - 1, 24)
    more = decode.decode_with_prefix(port, state2, seq[:, -1:], 5)
    w_state = jax_decode.prefill_prefix(model, tree, jnp.asarray(prefix),
                                        max_total_len=24)
    w_seq, w_state2 = jax_decode.decode_with_prefix(
        model, tree, w_state, jnp.asarray(suffix), 6, return_state=True)
    assert w_state2[1:] == state2[1:]
    _same(more, jax_decode.decode_with_prefix(model, tree, w_state2,
                                              w_seq[:, -1:], 5))
    for bad in ({"repetition_penalty": 1.2}, {"return_logprobs": True}):
        for fn, args in ((decode.decode_with_prefix, (port, state)),
                         (jax_decode.decode_with_prefix,
                          (model, tree, jax_decode.prefill_prefix(
                              model, tree, jnp.asarray(prefix),
                              max_total_len=24)))):
            with pytest.raises(TypeError):
                fn(*args, suffix, 4, **bad)
    with pytest.raises(ValueError, match="overflows"):
        decode.decode_with_prefix(port, state, suffix, 17)
    with pytest.raises(ValueError, match="multiple"):
        decode.decode_with_prefix(port, decode.prefill_prefix(
            port, np.tile(prefix, (2, 1)), max_total_len=24),
            np.tile(suffix, (2, 1))[:3], 4)


@pytest.mark.parametrize("config", ["dense", "window6", "window8_int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_decode_blocks_match_jax(variant, config):
    """Blocks of 5 over 17 tokens: greedy equal to JAX's blocks (and to
    ``decode``), the EOS freeze across chunk boundaries and the early
    stop, a 1-token prompt, and sampling on the JAX chain's per-chunk
    keys."""
    model, tree, port = _pair(variant, config)
    prompt = torch_parity.tokens(15, (2, 7))
    whole = decode.decode(port, prompt, 17).numpy()
    eos = int(whole[0, 9])
    blocks = []
    for p, kwargs in ((prompt, {}), (prompt, {"eos_id": eos}),
                      (prompt[:, :1], {})):
        want = list(jax_decode.stream_decode(model, tree, jnp.asarray(p),
                                             17, chunk=5, **kwargs))
        got = list(decode.stream_decode(port, p, 17, chunk=5, **kwargs))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        blocks.append(got)
    assert len(blocks[0]) == 4
    _same(np.concatenate(blocks[0], axis=1), whole[:, 7:])
    key = jax.random.PRNGKey(2)
    want = list(jax_decode.stream_decode(model, tree, jnp.asarray(prompt),
                                         12, chunk=5, temperature=1.1,
                                         top_p=0.9, rng=key))
    got = list(decode.stream_decode(port, prompt, 12, chunk=5,
                                    temperature=1.1, top_p=0.9,
                                    uniforms=_JaxUniforms(key, 5)))
    _same(np.concatenate(got, axis=1), np.concatenate(want, axis=1))


@pytest.mark.parametrize("config", ["dense", "window6", "int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_beam_search_matches_jax(variant, config):
    """4 beams over 8 tokens (W 6 wraps the ring inside the scored
    span): plain, with EOS (a finished beam freezes), and with EOS and
    the GNMT length penalty. Sequences identical, scores at 1e-4."""
    model, tree, port = _pair(variant, config)
    prompt = torch_parity.tokens(16, (2, 5))
    for kwargs in ({}, {"eos_id": 5}, {"eos_id": 5,
                                       "length_penalty": 0.8}):
        w_seq, w_score = jax_decode.beam_search(
            model, tree, jnp.asarray(prompt), 8, num_beams=4, **kwargs)
        g_seq, g_score = decode.beam_search(port, prompt, 8, num_beams=4,
                                            **kwargs)
        assert tuple(g_seq.shape) == (2, 4, 13)
        _same(g_seq, w_seq)
        _close(g_score, w_score)


def test_beam_search_edges():
    """num_beams=1 is exactly greedy; beams beyond the distinct
    continuations (70 > 64 one-token continuations) come back at -inf
    with token 0, as in JAX; the argument checks raise."""
    model, tree, port = _pair("learned_mha", "window6")
    prompt = torch_parity.tokens(17, (2, 5))
    seq, _ = decode.beam_search(port, prompt, 9, num_beams=1)
    _same(seq[:, 0], decode.decode(port, prompt, 9))
    g_seq, g_score = decode.beam_search(port, prompt, 1, num_beams=70)
    w_seq, w_score = jax_decode.beam_search(model, tree,
                                            jnp.asarray(prompt), 1,
                                            num_beams=70)
    _same(g_seq, w_seq)
    assert np.isneginf(g_score[:, 64:].numpy()).all()
    assert (g_seq[:, 64:, -1] == 0).all()
    _close(g_score[:, :64], np.asarray(w_score)[:, :64])
    for kwargs in ({"num_beams": 0}, {"eos_id": [1, 2]}, {"eos_id": 64},
                   {"length_penalty": 0.5}):
        with pytest.raises(ValueError):
            decode.beam_search(port, prompt, 4, **kwargs)

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

"""Sliding-window attention in the port against the flax module, on
the CPU (the flax side through the Pallas kernels in interpret mode,
the port through their plain versions).

- The windowed full forward and its gradients: logits within 2e-4 in
  f32 and 2e-2 of the logits' largest magnitude in bf16 (the bf16
  reasoning of tests/test_torch_transformer.py); the next-token loss
  within 1e-5 relative and each gradient within 1e-5 absolute + 1e-4
  relative in f32 (two layers of f32 summation order).
- The ring cache: after a one-shot prefill longer than the ring and
  single-token steps that wrap it, the port's K/V slots and slot_pos
  equal flax's ``cached_key`` / ``slot_pos`` (f32 2e-5; int8 values
  exactly up to one rounding flip, scales 1e-6), and every step's
  logits agree at 2e-4.
- Per-row multi-token chunks, dense and paged, against the flax
  ``per_row_index`` module: logits at 2e-4, the rows' cache entries
  equal, positions past the row dropped.
- The windowed slot engine, dense and paged, against the JAX windowed
  engine: identical tokens, logprobs at 1e-4, and (paged) the same
  tables, stats, pool state and prefix index after every operation.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu.models import transformer as jax_tf
from container_engine_accelerators_tpu.ops import (
    mean_cross_entropy_loss as jax_mean_xent,
)
from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.models import convert, decode
from container_engine_accelerators_tpu_torch.models import transformer
from container_engine_accelerators_tpu_torch.ops import attention
from container_engine_accelerators_tpu_torch.ops.xent import (
    mean_cross_entropy_loss,
)
from tests import torch_parity

TOL = {"f32": 2e-4, "bf16": 2e-2}
LP_TOL = 1e-4
VARIANTS = sorted(torch_parity.VARIANTS)
WINDOWS = (6, 8, 24)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, dtype="f32"):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if dtype == "bf16" else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               rtol=TOL[dtype], atol=TOL[dtype] * scale)


def _windowed(variant, window, dtype="f32", **extra):
    """(flax model, params, the port's model): the same weights with
    ``attention_window`` (and ``extra`` options) on both sides."""
    model, tree, config = torch_parity.flax_lm(variant, dtype)
    options = dict(extra, attention_window=window)
    return (model.clone(**options), tree,
            torch_parity.port_lm(dict(config, **options), tree, dtype))


@functools.lru_cache(maxsize=None)
def _flax_forward(variant, window, dtype, seq):
    model, tree, _ = _windowed(variant, window, dtype)
    toks = torch_parity.tokens(20, (2, seq))
    return np.asarray(jax.jit(model.apply)({"params": tree},
                                           jnp.asarray(toks)), np.float32)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("variant", VARIANTS)
def test_windowed_forward_matches_flax(variant, dtype, window):
    """30 tokens: every window binds (24 < 30), and the windowed logits
    differ from the causal ones past position W."""
    _, _, port = _windowed(variant, window, dtype)
    toks = torch_parity.tokens(20, (2, 30))
    with torch.no_grad():
        got = port(torch.from_numpy(toks).long())
    want = _flax_forward(variant, window, dtype, 30)
    _close(got, want, dtype)
    # The band binds: past position W the windowed logits leave the
    # causal model's, before it they are the causal model's.
    causal = _flax_forward(variant, 0, dtype, 30)
    assert np.abs(want[:, window:] - causal[:, window:]).max() > 1e-3
    _close(got[:, :window], causal[:, :window], dtype)


@pytest.mark.parametrize("window", (6, 24))
@pytest.mark.parametrize("variant", VARIANTS)
def test_windowed_gradients_match_flax(variant, window):
    """The next-token loss and every parameter's gradient, f32, the
    fused loss on both sides (Pallas in interpret mode against the
    plain versions)."""
    model, tree, config = torch_parity.flax_lm(variant, "f32")
    model = model.clone(attention_window=window)
    toks = torch_parity.tokens(21, (2, 28))
    loss_fn = jax_tf.next_token_loss_fn(functools.partial(
        jax_mean_xent, label_smoothing=0.0))

    def jax_loss(params):
        return loss_fn(model.apply({"params": params}, jnp.asarray(toks)),
                       jnp.asarray(toks))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    port = convert.load_lm(dict(config, attention_window=window), tree,
                           device="cpu", dtype=torch.float32, trainable=True)
    port_loss = transformer.next_token_loss_fn(functools.partial(
        mean_cross_entropy_loss, label_smoothing=0.0))
    t = torch.from_numpy(toks).long()
    loss = port_loss(port(t), t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = convert.params_to_flax(
        {n: p.grad for n, p in port.named_parameters()},
        dict(config, attention_window=window))
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, want in jax.tree_util.tree_leaves_with_path(want_grads):
        np.testing.assert_allclose(got[path], np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))


def test_window_needs_an_attention_fn_that_takes_it():
    """As the flax module refuses a window on a schedule that takes
    none; the plain attention with a ``window`` keyword is accepted and
    gives the flash path's logits."""
    _, tree, config = torch_parity.flax_lm("rope_gqa")

    def no_window(q, k, v, causal):
        return attention.flash_attention_reference(q, k, v, causal)[0]

    def plain(q, k, v, causal, window=0):
        return attention.flash_attention_reference(q, k, v, causal,
                                                   window)[0]

    windowed = dict(config, attention_window=6)
    with pytest.raises(ValueError, match="window"):
        convert.load_lm(windowed, tree, device="cpu",
                        attention_fn=no_window)
    convert.load_lm(config, tree, device="cpu", attention_fn=no_window)
    toks = torch.from_numpy(torch_parity.tokens(22, (1, 20))).long()
    with torch.no_grad():
        got = convert.load_lm(windowed, tree, device="cpu",
                              attention_fn=plain)(toks)
        want = convert.load_lm(windowed, tree, device="cpu")(toks)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _flax_cache(cache, layer, name):
    return np.asarray(cache[f"block{layer}"]["attn"][name])


@pytest.mark.parametrize("kv", ["native", "int8"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_ring_prefill_wrap_and_slot_pos_match_flax(variant, kv):
    """W 6 with ring_slack 2: an 8-slot ring. An 11-token one-shot
    prefill keeps positions 3..10 (split at the wrap); 9 steps wrap the
    ring again. After each call the port's K slots, scales and
    slot_pos equal flax's ring; the logits agree."""
    extra = {"ring_slack": 2}
    if kv == "int8":
        extra["kv_cache_dtype"] = "int8"
    model, tree, port = _windowed(variant, 6, **extra)
    decode_model, cache = jax_decode.init_cache(model, 2, 24)
    port_cache = port.init_cache(2, 24)
    assert isinstance(port_cache, transformer.RingCache)
    assert port_cache[0][0].shape[1] == 8
    assert len(port_cache[0]) == (4 if kv == "int8" else 2)

    @jax.jit
    def apply(cache, toks):
        out, upd = decode_model.apply({"params": tree, "cache": cache},
                                      toks, mutable=["cache"])
        return out, upd["cache"]

    def check(cache):
        for layer in range(2):
            np.testing.assert_array_equal(
                port_cache.slot_pos.numpy(),
                _flax_cache(cache, layer, "slot_pos"))
            got_k = port_cache[layer][0].float().numpy()
            want_k = _flax_cache(cache, layer, "cached_key").astype(
                np.float32)
            if kv == "int8":
                # One-unit flips where a value sits at a .5 rounding
                # boundary (f32 projections differ in the last place).
                assert np.abs(got_k - want_k).max() <= 1
                assert (got_k != want_k).mean() < 0.01
                np.testing.assert_allclose(
                    port_cache[layer][2].numpy(),
                    _flax_cache(cache, layer, "key_scale"),
                    rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_allclose(got_k, want_k, rtol=0,
                                           atol=2e-5)

    prompt = torch_parity.tokens(23, (2, 11))
    with torch.no_grad():
        out, cache = apply(cache, jnp.asarray(prompt))
        _close(port(torch.from_numpy(prompt).long(), port_cache, 0), out)
        check(cache)
        assert sorted(port_cache.slot_pos[0].tolist()) == list(range(3, 11))
        for t, tok in enumerate(torch_parity.tokens(24, (9, 2, 1))):
            out, cache = apply(cache, jnp.asarray(tok))
            _close(port(torch.from_numpy(tok).long(), port_cache, 11 + t),
                   out)
            check(cache)


@pytest.mark.parametrize("variant", VARIANTS)
def test_ring_chunk_attending_the_cache_matches_flax(variant):
    """A 4-token chunk at offset 7 on a W 8 + slack 4 ring (the
    speculative verify and chunked-suffix write): scattered onto slots
    mod 12, masked by slot_pos and the band."""
    model, tree, port = _windowed(variant, 8, ring_slack=4)
    decode_model, cache = jax_decode.init_cache(model, 1, 30)
    chunk_model = decode_model.clone(chunk_attends_cache=True)
    port_cache = port.init_cache(1, 30)
    feeds = [(decode_model, torch_parity.tokens(25, (1, 7)), 0),
             (chunk_model, torch_parity.tokens(26, (1, 4)), 7),
             (chunk_model, torch_parity.tokens(27, (1, 4)), 11),
             (decode_model, torch_parity.tokens(28, (1, 1)), 15)]
    with torch.no_grad():
        for m, toks, index in feeds:
            out, upd = m.apply({"params": tree, "cache": cache},
                               jnp.asarray(toks), mutable=["cache"])
            cache = upd["cache"]
            got = port(torch.from_numpy(toks).long(), port_cache, index,
                       chunk_attends_cache=m is chunk_model)
            _close(got, out)
            np.testing.assert_array_equal(port_cache.slot_pos.numpy(),
                                          _flax_cache(cache, 0, "slot_pos"))


def _per_row_cache(model, batch, length, row_pos, **clone):
    per_row = model.clone(per_row_index=True, **clone)
    decode_model, cache = jax_decode.init_cache(per_row, batch, length)
    return decode_model, jax_decode._with_row_index(
        cache, jnp.asarray(row_pos, jnp.int32))


@pytest.mark.parametrize("window", (0, 6))
@pytest.mark.parametrize("variant", VARIANTS)
def test_per_row_multi_token_chunks_match_flax(variant, window):
    """Rows at positions 0, 5 and 14 take a 3-token chunk each into a
    16-position cache (row 2's position 16 drops), then rows at 3, 8
    and 15 another (row 2 keeps one of three); the logits agree and
    every kept entry equals flax's."""
    model, tree, config = torch_parity.flax_lm(variant)
    if window:
        model = model.clone(attention_window=window)
    port = torch_parity.port_lm(dict(config, attention_window=window), tree)
    decode_model, cache = _per_row_cache(model, 3, 16, np.zeros(3))
    port_cache = port.init_cache(3, 16, ring=False)
    with torch.no_grad():
        for seed, row_pos in ((29, np.array([0, 5, 14])),
                              (30, np.array([3, 8, 15]))):
            cache = jax_decode._with_row_index(
                cache, jnp.asarray(row_pos, jnp.int32))
            toks = torch_parity.tokens(seed, (3, 3))
            out, upd = decode_model.apply({"params": tree, "cache": cache},
                                          jnp.asarray(toks),
                                          mutable=["cache"])
            cache = upd["cache"]
            got = port(torch.from_numpy(toks).long(), port_cache,
                       torch.from_numpy(row_pos))
            _close(got, out)
            for layer in range(2):
                np.testing.assert_allclose(
                    port_cache[layer][0].numpy(),
                    _flax_cache(cache, layer, "cached_key"), rtol=0,
                    atol=2e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_paged_per_row_chunks_match_flax(variant):
    """The same chunks on the paged arena (block 4, the rows' tables
    interleaved, the trash block last) of a W 6 model: logits equal
    flax's paged per_row_index module, the arenas are equal, and
    positions past a row's table drop."""
    model, tree, config = torch_parity.flax_lm(variant)
    model = model.clone(attention_window=6)
    port = torch_parity.port_lm(dict(config, attention_window=6), tree)
    nb, bs = 13, 4
    tables = np.array([[0, 3, 6, 9], [1, 4, 7, 10], [2, 5, 8, 11]])
    decode_model, cache = _per_row_cache(model, 3, 16, np.zeros(3),
                                         kv_pages=(nb, bs))
    cache = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(tables, jnp.int32)
                         if path[-1].key == "block_table" else a), cache)
    arena = port.init_paged_cache(nb, bs)
    with torch.no_grad():
        for seed, row_pos in ((31, np.array([0, 6, 14])),
                              (32, np.array([3, 9, 15]))):
            cache = jax_decode._with_row_index(
                cache, jnp.asarray(row_pos, jnp.int32))
            toks = torch_parity.tokens(seed, (3, 3))
            out, upd = decode_model.apply({"params": tree, "cache": cache},
                                          jnp.asarray(toks),
                                          mutable=["cache"])
            cache = upd["cache"]
            got = port(torch.from_numpy(toks).long(), arena,
                       torch.from_numpy(row_pos),
                       block_table=torch.from_numpy(tables))
            _close(got, out)
            for layer in range(2):
                np.testing.assert_allclose(
                    arena[layer][1][:nb - 1].numpy(),
                    _flax_cache(cache, layer, "cached_value")[:nb - 1],
                    rtol=0, atol=2e-5)


class _EnginePair:
    """The JAX windowed engine and the port's, built alike and driven
    alike; every operation is followed by ``check``."""

    def __init__(self, variant, window, **kwargs):
        self.model, self.tree, self.port = _windowed(variant, window)
        self.want = jax_decode.SlotDecodeEngine(self.model, self.tree,
                                                **kwargs)
        self.got = decode.SlotDecodeEngine(self.port, **kwargs)
        self.check()

    def check(self):
        got, want = self.got, self.want
        assert got.free_slots() == want.free_slots()
        assert got.kv_block_stats() == want.kv_block_stats()
        assert got.block_pool_state() == want.block_pool_state()
        if got.paged:
            np.testing.assert_array_equal(got._tables, want._tables)
            assert got._pool._index == want._pool._index
            np.testing.assert_array_equal(got._pool.ref, want._pool.ref)
        assert got.pool_leak_report() == want.pool_leak_report()

    def admit(self, row, plen, **kwargs):
        w = self.want.admit(row, plen, **kwargs)
        g = self.got.admit(row, plen, **kwargs)
        assert g[0] == w[0] and g[1] == w[1]
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=LP_TOL)
        np.testing.assert_allclose(g[3][:plen], np.asarray(w[3])[:plen],
                                   rtol=0, atol=LP_TOL)
        self.check()
        return g[0]

    def step(self, slots, n):
        for _ in range(n):
            want_tok, want_lp = self.want.step()
            got_tok, got_lp = self.got.step()
            for slot in slots:
                assert got_tok[slot] == want_tok[slot]
                np.testing.assert_allclose(got_lp[slot], want_lp[slot],
                                           rtol=0, atol=LP_TOL)
            self.check()

    def release(self, slot):
        self.want.release(slot)
        self.got.release(slot)
        self.check()


@pytest.mark.parametrize("window", (6, 8))
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_windowed_engine_matches_jax_engine(variant, paged, window):
    """Rows longer than the window, a ragged row, a repetition penalty,
    a prompt sent again (paged: a prefix hit whose suffix chunk attends
    shared blocks with the band) and a release in between; no flash
    kernel runs (the admissions ride per-row positions)."""
    kwargs = dict(slots=3, slot_len=24, paged=paged, buckets=[8, 16])
    if paged:
        kwargs["kv_block_size"] = 4
    pair = _EnginePair(variant, window, **kwargs)
    rows = [torch_parity.tokens(40 + i, (16,)) for i in range(3)]
    before = attention.flash_fwd.launches
    a = pair.admit(rows[0], 13)
    pair.step([a], 3)
    b = pair.admit(rows[1], 5, repetition_penalty=1.3)
    pair.step([a, b], 6)
    pair.release(a)
    c = pair.admit(rows[0], 14)
    pair.step([b, c], 5)
    pair.release(b)
    pair.release(c)
    assert attention.flash_fwd.launches == before
    assert pair.got.pool_leak_report() is None


def test_windowed_engine_int8_and_ring_slack():
    """The int8 arena serves a windowed model as the JAX engine's
    does; a model with ring slack is refused by the engine, whose
    caches are never rings."""
    pair = _EnginePair("rope_gqa", 6, slots=2, slot_len=24, paged=True,
                       kv_block_size=4, kv_quant="int8")
    slot = pair.admit(torch_parity.tokens(43, (12,)), 12)
    pair.step([slot], 6)
    pair.release(slot)
    _, _, port = _windowed("rope_gqa", 6, ring_slack=2)
    with pytest.raises(ValueError, match="ring_slack"):
        decode.SlotDecodeEngine(port, 2, 16)
    with pytest.raises(ValueError, match="full-length cache"):
        port(torch.zeros((1, 1), dtype=torch.long), port.init_cache(1, 8),
             torch.zeros((1,), dtype=torch.long))


def test_train_py_trains_a_windowed_lm():
    """``train.py --attention-window`` trains through ``train.run``: the
    model carries the window, the loss is finite."""
    argv = ["--device", "cpu", "--model", "transformer", "--vocab-size",
            "32", "--embed-dim", "16", "--num-layers", "1", "--num-heads",
            "2", "--seq-len", "12", "--batch-size", "2", "--steps", "2",
            "--warmup-steps", "1", "--attention-window", "4"]
    result, _, state = port_train.run(port_train.parse_args(argv))
    assert np.isfinite(result["final_loss"])
    assert state.model.attention_window == 4
    assert state.model.blocks[0].attn.window == 4

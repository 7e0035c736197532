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

"""The port's quantized KV cache and weight-only int8 against the JAX
package, on the CPU.

- The row quantizers, the int4 unpack, ``quantize_kernel_int8`` and
  ``convert_params_int8`` are bitwise equal to JAX's (values, packed
  bytes, scales, dtypes), .5 ties included.
- ``Int8Linear`` and the int8-weight TransformerLM agree with flax at
  1e-5 in f32 and, in bf16, at 2e-2 of the largest reference value
  (the repo's bf16 limit, tests/test_torch_transformer.py).
- Decode steps on int8 and int4 caches agree with flax decode mode at
  the f32 logit tolerance of tests/test_torch_transformer.py (2e-4).
- The engine at int8 and int4, on both pools, runs the scripts of
  tests/test_torch_paging.py beside the JAX engine (equal tables,
  stats and arena bytes, exact tokens); greedy streams equal JAX
  decode() on the ``kv_cache_dtype`` clone: the one-shot prefill for
  the dense pool, ``fast_prefill=False`` for the paged pool, whose
  admission prefill attends the quantized cache as that stepwise
  prefill does.
- PERF_LEDGER.json's ``spill_check`` row replays exactly on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu.models import quantized as jax_quant
from container_engine_accelerators_tpu.models import transformer as jax_tf
from container_engine_accelerators_tpu_torch.models import convert, decode
from container_engine_accelerators_tpu_torch.models import quantized
from container_engine_accelerators_tpu_torch.models import transformer
from tests import torch_parity
from tests.test_torch_paging import Pair, _bench_args, _bench_model, _replay
from tests.test_torch_paging import occupancy

QUANTIZERS = ("_quantize_rows_int8", "_quantize_rows_int4")
MODES = ("int8", "int4")
VARIANTS = sorted(torch_parity.VARIANTS)
TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, dtype, tol=None):
    """f32: ``tol`` absolute and relative; bf16: 2e-2 of the largest
    reference magnitude."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    tol = TOL[dtype] if tol is None else tol
    scale = float(np.abs(want).max()) if dtype == "bf16" else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _rows_with_ties(seed, dtype):
    """Random rows [2, 5, 2, 16] plus rows whose scale is exactly 1
    (amax 127, or 7 for int4) holding values on .5 ties."""
    x = 3.0 * np.random.default_rng(seed).standard_normal((2, 5, 2, 16))
    x[0, 0, 0] = 0.0
    x[0, 0, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 126.5]
    x[0, 0, 1] = 0.0
    x[0, 0, 1, :6] = [7.0, 2.5, -1.5, 0.5, -6.5, 3.5]
    x[1, 4, 1] = 0.0                                  # an all-zero row
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), torch.tensor(
            x, dtype=torch.bfloat16)
    x = x.astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", QUANTIZERS)
def test_row_quantizers_bitwise_equal_to_jax(name, dtype):
    jx, tx = _rows_with_ties(0, dtype)
    want_q, want_s = getattr(jax_tf, name)(jx)
    got_q, got_s = getattr(transformer, name)(tx)
    assert got_q.numpy().dtype == np.asarray(want_q).dtype
    assert got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if name.endswith("int8"):
        # Half to even: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0, 126.5 -> 126.
        assert got_q[0, 0, 0, :6].tolist() == [127, 2, -4, 0, 0, 126]


def test_unpack_int4_round_trip():
    """unpack(pack(x)) is the clipped, rounded int4 row, as JAX's."""
    jx, tx = _rows_with_ties(1, "f32")
    packed, scale = transformer._quantize_rows_int4(tx)
    got = transformer._unpack_int4(packed)
    assert got.dtype == torch.int8 and got.shape == tx.shape
    want = torch.clamp(torch.round(tx / scale), -7, 7).to(torch.int8)
    assert torch.equal(got, want)
    assert got[0, 0, 1, :6].tolist() == [7, 2, -2, 0, -6, 4]
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jax_tf._unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("shape", [(32, 3, 4, 8), (64, 16)])
def test_quantize_kernel_int8_bitwise_equal_to_jax(shape):
    w = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    column = w.reshape(shape[0], -1)                # a view of w
    column[:, 0] = 0.0
    column[:3, 0] = [127.0, 2.5, -0.5]              # scale 1, two ties
    want_q, want_s = jax_quant.quantize_kernel_int8(w)
    got_q, got_s = quantized.quantize_kernel_int8(w)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, np.asarray(want_q))
    np.testing.assert_array_equal(got_s, np.asarray(want_s))
    assert got_q.reshape(shape[0], -1)[:3, 0].tolist() == [127, 2, 0]


def _jax_int8_lm(variant, dtype="f32"):
    """(int8 flax model, its JAX-converted tree as numpy, native tree,
    config)."""
    model, tree, config = torch_parity.flax_lm(variant, dtype)
    q_model = model.clone(weights="int8")
    template = jax.jit(q_model.init)(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 8), jnp.int32))["params"]
    q_tree = jax.tree_util.tree_map(
        np.asarray, jax_quant.convert_params_int8(template, tree))
    return q_model, q_tree, tree, config, template


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_convert_params_int8_tree_bitwise_equal_to_jax(variant, dtype):
    """On the flax template the port's conversion gives JAX's tree leaf
    for leaf (dtypes included); ``quantize_lm``'s own template differs
    only in holding the biases in f32, which round to JAX's bf16."""
    _, want, tree, config, template = _jax_int8_lm(variant, dtype)
    np_template = jax.tree_util.tree_map(np.asarray, template)
    got = quantized.convert_params_int8(np_template, tree)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        assert np.asarray(g).dtype == w.dtype, path
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))
    own = convert.quantize_lm(config, tree)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(own),
                                 flat_want):
        if w.dtype == np.float32 or w.dtype == np.int8:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            assert g.dtype == np.float32
            assert torch.equal(torch.from_numpy(g).to(torch.bfloat16),
                               torch.from_numpy(w.astype(np.float32)).to(
                                   torch.bfloat16)), path
    bad = dict(tree, lm_head={"kernel": np.zeros((3, 3), np.float32),
                              "bias": tree["lm_head"]["bias"]})
    with pytest.raises(ValueError, match="shape mismatch"):
        quantized.convert_params_int8(np_template, bad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int8_linear_matches_flax(dtype):
    jdt, tdt = torch_parity.DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    kernel = (rng.standard_normal((32, 3, 4, 8)) / 6).astype(np.float32)
    bias = (0.1 * rng.standard_normal((3, 4, 8))).astype(np.float32)
    q, scale = quantized.quantize_kernel_int8(kernel)
    flax_mod = jax_quant.Int8DenseGeneral(features=(3, 4, 8), dtype=jdt)
    params = {"kernel_q": jnp.asarray(q), "scale": jnp.asarray(scale),
              "bias": jnp.asarray(bias, jdt)}
    want = flax_mod.apply({"params": params}, jnp.asarray(x))
    layer = quantized.Int8Linear(32, 96, tdt)
    layer.load_state_dict({"weight": torch.from_numpy(q.reshape(32, -1).T),
                           "scale": torch.from_numpy(scale.reshape(-1)),
                           "bias": torch.from_numpy(bias.reshape(-1))})
    assert layer.bias.dtype == tdt and layer.weight.dtype == torch.int8
    got = layer(torch.from_numpy(x))
    assert got.dtype == tdt
    _close(got.float().reshape(2, 5, 3, 4, 8), np.asarray(want, np.float32),
           dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_int8_weight_lm_matches_flax(variant, dtype):
    """The weights="int8" LM on JAX's converted tree: every projection
    an Int8Linear, embeddings, norms and the f32 lm_head native; the
    tree round-trips through params_to_flax."""
    q_model, q_tree, _, config, _ = _jax_int8_lm(variant, dtype)
    toks = torch_parity.tokens(4, (2, 12))
    want = jax.jit(q_model.apply)({"params": q_tree}, jnp.asarray(toks))
    port = convert.load_lm(dict(config, weights="int8"), q_tree, device="cpu",
                           dtype=torch_parity.DTYPES[dtype][1])
    linears = [m for m in port.modules()
               if isinstance(m, quantized.Int8Linear)]
    assert len(linears) == config["num_layers"] * (
        4 if config["num_kv_heads"] is None else 5)
    assert port.lm_head.weight.dtype == torch.float32
    got = port(torch.from_numpy(toks).long())
    _close(got, want, dtype)
    if dtype == "f32":
        back = convert.params_to_flax(port, dict(config, weights="int8"))
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(back),
                jax.tree_util.tree_leaves_with_path(q_tree)):
            np.testing.assert_array_equal(g, w, err_msg=str(path))
    mixed = dict(q_tree)
    mixed["lm_head"] = dict(q_tree["lm_head"], scale=np.ones(1, np.float32))
    with pytest.raises(ValueError, match="leaves"):
        convert.params_from_flax(mixed)
    with pytest.raises(ValueError, match="serving"):
        convert.load_lm(dict(config, weights="int8"), q_tree, device="cpu",
                        trainable=True)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_quantized_cache_decode_matches_flax(variant, mode):
    """One-shot prefill of 7 tokens into an empty quantized cache (the
    flash path on the raw chunk, the cache written quantized), then
    three steps against it, beside flax decode mode with
    kv_cache_dtype; then the cache leaves: scales at 1e-5, values off
    by at most one step (a rounding tie that f32 reduction order moves)
    and almost all equal."""
    model, tree, config = torch_parity.flax_lm(variant)
    prompt = torch_parity.tokens(5, (2, 7))
    feed = torch_parity.tokens(6, (3, 2, 1))
    decode_model, cache = jax_decode.init_cache(
        model.clone(kv_cache_dtype=mode), 2, 12)

    @jax.jit
    def apply(cache, toks):
        out, upd = decode_model.apply({"params": tree, "cache": cache},
                                      toks, mutable=["cache"])
        return out, upd["cache"]

    port = torch_parity.port_lm(dict(config, kv_cache_dtype=mode), tree)
    port_cache = port.init_cache(2, 12)
    assert len(port_cache[0]) == 4
    with torch.inference_mode():
        out, cache = apply(cache, jnp.asarray(prompt))
        _close(port(torch.from_numpy(prompt).long(), port_cache, 0), out,
               "f32", 2e-4)
        for t, tok in enumerate(feed):
            out, cache = apply(cache, jnp.asarray(tok))
            got = port(torch.from_numpy(tok).long(), port_cache, 7 + t)
            _close(got, out, "f32", 2e-4)
    attn = cache["block1"]["attn"]
    for i, name in enumerate(("cached_key", "cached_value", "key_scale",
                              "value_scale")):
        got = port_cache[1][i][:, :10].numpy()
        want = np.asarray(attn[name])[:, :10]
        assert got.dtype == want.dtype, name
        if i >= 2:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
            continue
        if mode == "int4":
            got = transformer._unpack_int4(torch.from_numpy(got)).numpy()
            want = np.asarray(jax_tf._unpack_int4(jnp.asarray(want)))
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99, name


def test_cache_mode_errors_match_jax():
    with pytest.raises(ValueError, match="unsupported kv_cache_dtype 'fp8'"):
        transformer.TransformerLM(**torch_parity.TINY, device="cpu",
                                  kv_cache_dtype="fp8")
    odd = dict(torch_parity.TINY, embed_dim=36)         # head dim 9
    with pytest.raises(ValueError, match="needs it even, got 9"):
        transformer.TransformerLM(**odd, device="cpu", kv_cache_dtype="int4")
    port = transformer.TransformerLM(**odd, device="cpu")
    with pytest.raises(ValueError, match="needs it even"):
        port.init_cache(1, 4, quant="int4")
    with pytest.raises(ValueError, match="weights must be"):
        transformer.TransformerLM(**torch_parity.TINY, device="cpu",
                                  weights="int4")


# -- the engine, both pools, beside the JAX engine ----------------------


def _want_greedy(pair, mode, row, n, paged):
    """JAX decode() on the kv_cache_dtype clone: the dense pool's
    admission is the one-shot prefill, the paged pool's the stepwise
    one (its prompt attends the quantized cache)."""
    clone = pair.model.clone(kv_cache_dtype=mode)
    prompt = jnp.asarray(np.asarray(row, np.int32)[None])
    out = jax_decode.decode(clone, pair.tree, prompt, n,
                            fast_prefill=not paged)
    return np.asarray(out)[0, len(row):].tolist()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_quantized_dense_engine_matches_jax(variant, mode):
    """The dense pool at int8/int4 on a native model (the engine makes
    its cache in the mode, the weights shared): staggered rows, exact
    tokens beside the JAX engine, streams equal to JAX decode() on the
    clone and to the port's greedy_decode in the same mode."""
    pair = Pair(variant, slots=2, slot_len=16, paged=False, kv_quant=mode)
    assert pair.got.kv_quant == mode and pair.got._model is pair.port
    assert pair.got.kv_arena_bytes == sum(
        t.numel() * t.element_size() for layer in pair.got._cache
        for t in layer)
    a, b = torch_parity.tokens(40, (6,)), torch_parity.tokens(41, (4,))
    slot_a = pair.admit(a, 6)[0]
    pair.step(2)
    slot_b = pair.admit(b, 4)[0]
    pair.step(4)
    got_a, got_b = pair.release(slot_a), pair.release(slot_b)
    assert got_a == _want_greedy(pair, mode, a, 7, False)
    assert got_b == _want_greedy(pair, mode, b, 5, False)
    assert got_a == decode.greedy_decode(
        pair.port, torch.from_numpy(a.astype(np.int64))[None], 7,
        kv_quant=mode)[0, 6:].tolist()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_quantized_paged_engine_matches_jax(variant, mode):
    """The paged pool at int8/int4 at equal memory (the block count from
    the bytes of the bf16 arena): shared prefixes with a copy-on-write
    fork, then the spill tier's round trip of the mixed leaves (int8 or
    uint8 values beside f32 scales), its bytes equal to the JAX pool's;
    every stream equals JAX decode() on the clone."""
    pair = Pair(variant, slots=2, slot_len=16, paged=True, kv_block_size=4,
                kv_quant=mode)
    bf16 = decode.SlotDecodeEngine(pair.port, 2, 16, paged=True,
                                   kv_block_size=4)
    assert pair.got._pool.usable == int(
        bf16._pool.usable * decode.kv_token_bytes(pair.port)
        / decode.kv_token_bytes(pair.port, mode))
    assert pair.got.kv_block_stats()["kv_quant_mode"] == mode
    shared = [3, 1, 4, 1, 5, 9]
    sa, sb = np.array(shared + [11]), np.array(shared + [17])
    slot_a = pair.admit(sa, 7)[0]
    pair.step()
    slot_b = pair.admit(sb, 7)[0]           # 1 full block + a fork
    assert pair.got.kv_block_stats()["prefix_hits"] == 1
    pair.step(4)
    assert pair.release(slot_a) == _want_greedy(pair, mode, sa, 6, True)
    assert pair.release(slot_b) == _want_greedy(pair, mode, sb, 5, True)
    assert pair.got.pool_leak_report() is None

    spill = Pair(variant, slots=1, slot_len=12, paged=True, kv_block_size=4,
                 kv_blocks=4, kv_spill=True, kv_quant=mode)
    a = np.array([1, 2, 3, 4, 5, 6])
    first = spill.run_to(a, 6, 4, max_new=4)
    for filler in ([9, 8, 7, 6, 5, 4], [11, 12, 13, 14, 15, 16]):
        spill.run_to(np.array(filler), 6, 4, max_new=4)
    again = spill.run_to(a, 6, 4, max_new=4)
    assert first == again == _want_greedy(spill, mode, a, 4, True)
    stats = spill.got.kv_block_stats()
    assert stats["kv_spill_hits"] >= 1 and stats["kv_rehydrated_blocks"] >= 1
    pool, jax_pool = spill.got._pool, spill.want._pool
    assert pool.spill_bytes_used == jax_pool.spill_bytes_used > 0
    entry = next(iter(pool._spill_lru.values()))
    assert [t.dtype for t in entry["data"]] == (
        [torch.uint8] * 2 if mode == "int4" else [torch.int8] * 2) + [
            torch.float32] * 2
    assert spill.got.force_reclaim() is None


def test_spill_check_ledger_row():
    """PERF_LEDGER.json's spill_check row, replayed on the port's engine
    as tools/bench_serving_occupancy.py's run_spill replays it on the
    JAX engine: the long-tail trace (36 requests, 6 prefixes of 16,
    arrival 4.0) on a paged pool of 16 slots, block 4, slot_len 40 and
    22 bf16 blocks, with the spill tier on and off, and at int8 on
    int(22 * 256 / 96) = 58 blocks. kv_spill_hit_rate 0.9524,
    spill_goodput_ratio 1.189, int8_rows_ratio 3.244, prefix_hit_rate
    0.8333 and goodput_tokens_per_kwork 134.434 (the bf16 spill replay's
    numbers, as the bench records them); every greedy stream equals JAX
    decode() on the matching model."""
    args = _bench_args(spill_requests=36, spill_prefixes=6,
                       spill_prefix_len=16, spill_arrival_rate=4.0)
    bs = args.kv_block_size
    slot_len = -(-(args.spill_prefix_len + args.prompt_len
                   + args.max_new) // bs) * bs
    model, tree, port = _bench_model(args, slot_len)
    trace = occupancy.build_longtail_trace(
        args, np.random.default_rng(args.seed + 2))
    usable = 2 * (slot_len // bs) + 2
    tokens = sum(r["new"] for r in trace)
    results = {}
    for kind, quant, spill in (("paged_spill", "bf16", True),
                               ("paged_nospill", "bf16", False),
                               ("paged_int8", "int8", True)):
        blocks = (usable if quant == "bf16"
                  else int(usable * decode.kv_token_bytes(port)
                           / decode.kv_token_bytes(port, "int8")))
        eng = decode.SlotDecodeEngine(
            port, args.paged_slots, slot_len, paged=True, kv_block_size=bs,
            kv_blocks=blocks + 1, kv_quant=quant, kv_spill=spill)
        outputs, _, _ = _replay(eng, trace)
        kv = eng.kv_block_stats()
        work = eng.steps * eng.slots + sum(
            w * n for w, n in eng.prefill_widths.items())
        results[kind] = dict(
            blocks=blocks, kv=kv,
            rows_per_step=round(eng.row_steps / max(eng.steps, 1), 3),
            goodput=round(1000.0 * tokens / work, 3))
        ref = model.clone(kv_cache_dtype="int8") if quant == "int8" else model
        assert occupancy.verify_greedy(ref, tree, trace, outputs, args) == (
            True, None), kind
    assert (slot_len, usable, results["paged_int8"]["blocks"]) == (40, 22, 58)
    spill = results["paged_spill"]
    got = {
        "kv_spill_hit_rate": spill["kv"]["kv_spill_hit_rate"],
        "spill_goodput_ratio": round(
            spill["goodput"] / results["paged_nospill"]["goodput"], 3),
        "int8_rows_ratio": round(results["paged_int8"]["rows_per_step"]
                                 / spill["rows_per_step"], 3),
        "prefix_hit_rate": spill["kv"]["prefix_hit_rate"],
        "goodput_tokens_per_kwork": spill["goodput"],
    }
    assert got == {"kv_spill_hit_rate": 0.9524, "spill_goodput_ratio": 1.189,
                   "int8_rows_ratio": 3.244, "prefix_hit_rate": 0.8333,
                   "goodput_tokens_per_kwork": 134.434}
    assert results["paged_int8"]["kv"]["kv_quant_mode"] == "int8"

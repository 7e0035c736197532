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

"""The port's TransformerLM against the flax module it mirrors.

flax-initialised parameters go through models/convert.py into the
port; both run the same tokens on the CPU (the flax side through the
Pallas flash kernel in interpret mode, the port through its plain
version). Tolerances on the f32 logits: 2e-4 in f32 (reduction order
over two layers); in bf16, 2e-2 relative to the logits' largest
magnitude. The two frameworks round bf16 activations at different
points (XLA fuses elementwise chains, PyTorch rounds per operator),
and on these random models the JAX package's own bf16 logits sit
0.5-2% of that magnitude from its f32 logits (checked below), so an
absolute 2e-2 would sit inside that rounding noise rather than above
it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models.decode import init_cache
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import transformer
from tests import torch_parity

TOL = {"f32": 2e-4, "bf16": 2e-2}


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) if dtype == "bf16" else 1.0
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=TOL[dtype], atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_forward_matches_flax(variant, dtype):
    model, tree, config = torch_parity.flax_lm(variant, dtype)
    toks = torch_parity.tokens(0, (2, 12))
    want = jax.jit(model.apply)({"params": tree}, jnp.asarray(toks))
    port = torch_parity.port_lm(config, tree, dtype)
    got = port(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 64)
    _close(got, want, dtype)


@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_bf16_tolerance_sits_above_jax_own_rounding(variant):
    """The reason for the bf16 tolerance: the JAX package's own bf16
    logits differ from its f32 logits by 0.5-2% of the logits' largest
    magnitude on these models, so two bf16 implementations can differ
    by as much without either being wrong."""
    toks = jnp.asarray(torch_parity.tokens(0, (2, 12)))
    out = {}
    for dtype in ("f32", "bf16"):
        model, tree, _ = torch_parity.flax_lm(variant, dtype)
        out[dtype] = np.asarray(jax.jit(model.apply)({"params": tree}, toks),
                                np.float32)
    gap = np.abs(out["bf16"] - out["f32"]).max() / np.abs(out["f32"]).max()
    assert 0.005 < gap < TOL["bf16"]


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_prefill_then_steps_match_flax_decode(variant, dtype):
    """One-shot prefill of a 7-token prompt into an empty cache, then
    three single-token steps, against flax decode mode step for step."""
    model, tree, config = torch_parity.flax_lm(variant, dtype)
    prompt = torch_parity.tokens(1, (2, 7))
    feed = torch_parity.tokens(2, (3, 2, 1))
    length = 12
    decode_model, cache = init_cache(model, 2, length)

    @jax.jit
    def apply(cache, toks):
        out, upd = decode_model.apply({"params": tree, "cache": cache},
                                      toks, mutable=["cache"])
        return out, upd["cache"]

    port = torch_parity.port_lm(config, tree, dtype)
    port_cache = port.init_cache(2, length)
    with torch.inference_mode():
        out, cache = apply(cache, jnp.asarray(prompt))
        _close(port(torch.from_numpy(prompt).long(), port_cache, 0), out,
               dtype)
        for t, tok in enumerate(feed):
            out, cache = apply(cache, jnp.asarray(tok))
            got = port(torch.from_numpy(tok).long(), port_cache, 7 + t)
            _close(got, out, dtype)
    # The port's cache holds what flax's holds: K/V rows at [0, 10).
    want_k = np.asarray(cache["block1"]["attn"]["cached_key"], np.float32)
    _close(port_cache[1][0][:, :10], want_k[:, :10], dtype)


def test_per_row_positions_match_scalar_steps():
    """A [B] vector of per-row positions (the slot engine's step) gives
    each row what a scalar-index step at that row's position gives."""
    _, tree, config = torch_parity.flax_lm("rope_gqa")
    port = torch_parity.port_lm(config, tree)
    prompts = torch_parity.tokens(3, (2, 9))
    lens = [5, 9]
    per_row = port.init_cache(2, 16)
    with torch.inference_mode():
        want = []
        for r, n in enumerate(lens):
            row_cache = [(k[r:r + 1], v[r:r + 1]) for k, v in per_row]
            port(torch.from_numpy(prompts[r:r + 1, :n]).long(), row_cache, 0)
            solo = port.init_cache(1, 16)
            port(torch.from_numpy(prompts[r:r + 1, :n]).long(), solo, 0)
            want.append(port(torch.tensor([[r + 1]]), solo, n)[0, 0])
        got = port(torch.tensor([[1], [2]]), per_row,
                   torch.tensor(lens))[:, 0]
    torch.testing.assert_close(got, torch.stack(want), rtol=0, atol=1e-5)


def test_converter_layout_and_leaf_count():
    for variant in sorted(torch_parity.VARIANTS):
        _, tree, config = torch_parity.flax_lm(variant)
        state = convert.params_from_flax(tree)
        own = convert.init_flax_layout_params(config, 0)
        assert (jax.tree_util.tree_structure(own)
                == jax.tree_util.tree_structure(tree))
        assert all(a.shape == b.shape for a, b in zip(
            jax.tree_util.tree_leaves(own), jax.tree_util.tree_leaves(tree)))
        port = transformer.TransformerLM(**config, device="cpu")
        assert set(state) == set(port.state_dict())
        qkv = "qkv" if config["num_kv_heads"] is None else "q"
        kernel = tree["block0"]["attn"][qkv]["kernel"]
        np.testing.assert_array_equal(
            state[f"blocks.0.attn.{qkv}.weight"].numpy(),
            kernel.reshape(kernel.shape[0], -1).T)
    tree["block0"]["attn"]["proj"]["scale"] = np.ones(3, np.float32)
    with pytest.raises(ValueError, match="leaves"):
        convert.params_from_flax(tree)


@pytest.mark.parametrize("option,value", [
    ("kv_cache_dtype", "int8"), ("kv_cache_dtype", "int4"),
    ("attention_window", 64), ("kv_pages", (8, 16)), ("weights", "int8"),
    ("chunk_attends_cache", True), ("ring_slack", 2)])
def test_unported_options_raise(option, value):
    with pytest.raises(ValueError, match=f"{option}=.*not yet ported"):
        transformer.TransformerLM(**torch_parity.TINY, device="cpu",
                                  **{option: value})


def test_mid_cache_chunk_and_overrun_raise():
    _, tree, config = torch_parity.flax_lm("learned_mha")
    port = torch_parity.port_lm(config, tree)
    cache = port.init_cache(1, 8)
    with pytest.raises(ValueError, match="chunk_attends_cache"):
        port(torch.zeros((1, 3), dtype=torch.long), cache, 2)
    with pytest.raises(ValueError, match="overruns"):
        port(torch.zeros((1, 9), dtype=torch.long), cache, 0)
    with pytest.raises(ValueError, match="max_seq_len"):
        port(torch.zeros((1, 49), dtype=torch.long))

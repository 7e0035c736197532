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

"""Shared set-up of the parity tests between the JAX package and its
PyTorch port: one tiny flax TransformerLM, its parameters as numpy,
and the port's model loaded from them on the CPU. Data crosses between
the frameworks as numpy arrays only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from container_engine_accelerators_tpu.models import TransformerLM
from container_engine_accelerators_tpu_torch.models import convert

# Small enough for tier-1, wide enough for GQA (4 query heads over 2
# KV heads) and two layers.
TINY = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
            max_seq_len=48)
VARIANTS = {
    "learned_mha": dict(pos_embedding="learned", num_kv_heads=None),
    "rope_gqa": dict(pos_embedding="rope", num_kv_heads=2),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _flax_params(variant, seed):
    model = TransformerLM(**TINY, **VARIANTS[variant])
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def flax_lm(variant="learned_mha", dtype="f32", seed=1):
    """(flax model, a fresh copy of its params as a numpy tree, the
    port's config). The params are f32 in both dtypes, as flax keeps
    them; the model's dtype is its compute dtype."""
    config = dict(TINY, **VARIANTS[variant])
    model = TransformerLM(dtype=DTYPES[dtype][0], **config)
    tree = jax.tree_util.tree_map(np.copy, _flax_params(variant, seed))
    return model, tree, config


def port_lm(config, tree, dtype="f32"):
    """The port's TransformerLM on the CPU with the flax weights."""
    return convert.load_lm(config, tree, device="cpu",
                           dtype=DTYPES[dtype][1])


def tokens(seed, shape, vocab=TINY["vocab_size"]):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)

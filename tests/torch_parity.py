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
PyTorch port: one tiny flax TransformerLM (or MoETransformerLM), its
parameters as numpy, and the port's model loaded from them on the CPU.
Data crosses between the frameworks as numpy arrays only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from container_engine_accelerators_tpu.models import (
    MoETransformerLM,
    TransformerLM,
)
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
def _flax_params(variant, seed, vocab):
    model = TransformerLM(**dict(TINY, vocab_size=vocab), **VARIANTS[variant])
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def flax_lm(variant="learned_mha", dtype="f32", seed=1,
            vocab=TINY["vocab_size"]):
    """(flax model, a fresh copy of its params as a numpy tree, the
    port's config). The params are f32 in both dtypes, as flax keeps
    them; the model's dtype is its compute dtype. ``vocab`` 256 fits
    the byte tokenizer."""
    config = dict(TINY, vocab_size=vocab, **VARIANTS[variant])
    model = TransformerLM(dtype=DTYPES[dtype][0], **config)
    tree = jax.tree_util.tree_map(np.copy, _flax_params(variant, seed, vocab))
    return model, tree, config


@functools.lru_cache(maxsize=None)
def _flax_params_of(items, seed):
    model = TransformerLM(dtype=jnp.float32, **dict(items))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def flax_lm_of(seed=0, **config):
    """(flax model in f32, a fresh copy of its params as a numpy tree,
    the port's config) for any TransformerLM ``config``, initialised
    from PRNGKey(``seed``): the fixtures of the JAX package's own tests
    (``_make`` in tests/test_speculative.py), cached."""
    model = TransformerLM(dtype=jnp.float32, **config)
    tree = jax.tree_util.tree_map(
        np.copy, _flax_params_of(tuple(sorted(config.items())), seed))
    return model, tree, config


@functools.lru_cache(maxsize=None)
def _flax_moe_params(items, seed):
    model = MoETransformerLM(dtype=jnp.float32, **dict(items))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def flax_moe(variant="learned_mha", dtype="f32", seed=1, **options):
    """(flax MoETransformerLM, a fresh copy of its params as a numpy
    tree, the port's config) at TINY with 4 experts, top-2 routing and
    the default capacity factor 1.25 (a dropping router) unless
    ``options`` say otherwise."""
    config = dict(TINY, **VARIANTS[variant])
    config.update(dict(num_experts=4, top_k=2, capacity_factor=1.25),
                  **options)
    model = MoETransformerLM(dtype=DTYPES[dtype][0], **config)
    tree = jax.tree_util.tree_map(
        np.copy, _flax_moe_params(tuple(sorted(config.items())), seed))
    return model, tree, config


def port_lm(config, tree, dtype="f32"):
    """The port's TransformerLM (MoETransformerLM for a config with
    ``num_experts``) on the CPU with the flax weights."""
    return convert.load_lm(config, tree, device="cpu",
                           dtype=DTYPES[dtype][1])


def tokens(seed, shape, vocab=TINY["vocab_size"]):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


# -- image models ---------------------------------------------------------
# ResNet at width 8 (18: basic blocks, 50: bottlenecks), the MNIST MLP at
# hidden 32, Inception-v3 (fixed widths) at 10 classes.
IMAGE_TINY = {
    "resnet18": dict(depth=18, num_classes=10, width=8),
    "resnet50": dict(depth=50, num_classes=10, width=8),
    "mlp": dict(hidden=32, num_classes=10),
    "inception": dict(num_classes=10),
}
IMAGE_SHAPES = {"mlp": (28, 28, 1), "inception": (75, 75, 3)}


def flax_image_model(kind, dtype="f32", **overrides):
    """The JAX package's model of ``kind`` at its tiny config."""
    from container_engine_accelerators_tpu.models.inception import (
        InceptionV3,
    )
    from container_engine_accelerators_tpu.models.mlp import MnistMLP
    from container_engine_accelerators_tpu.models.resnet import resnet
    config = dict(IMAGE_TINY[kind], dtype=DTYPES[dtype][0], **overrides)
    if kind == "mlp":
        return MnistMLP(**config)
    if kind == "inception":
        return InceptionV3(**config)
    return resnet(**config)


def port_image_model(kind, dtype="f32", device="cpu", **overrides):
    """The port's model of ``kind`` at its tiny config, built on the
    meta device and given uninitialised memory on ``device``: load a
    flax tree into it (``convert.load_image_model``)."""
    from container_engine_accelerators_tpu_torch.models import inception
    from container_engine_accelerators_tpu_torch.models import mlp, resnet
    config = dict(IMAGE_TINY[kind], dtype=DTYPES[dtype][1], device="meta",
                  **overrides)
    if kind == "mlp":
        model = mlp.MnistMLP(**config)
    elif kind == "inception":
        model = inception.InceptionV3(**config)
    else:
        model = resnet.resnet(**config)
    return model if device == "meta" else model.to_empty(device=device)


@functools.lru_cache(maxsize=None)
def _image_variables(kind, seed):
    tree = convert.init_flax_layout_image(
        port_image_model(kind, device="meta"), seed)
    # flax's init leaves BN scales at 1 (0 on the last BN of a block),
    # biases and means at 0 and variances at 1: values a converter
    # could misplace unseen. Spread every non-kernel leaf.
    rng = np.random.default_rng(seed + 100)

    def spread(path, leaf):
        name = path[-1].key
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.2 * noise
        if name == "var":
            return (1.0 + 0.5 * rng.random(leaf.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return 0.1 * noise
        return leaf

    return jax.tree_util.tree_map_with_path(spread, tree)


def flax_image(kind, dtype="f32", seed=0):
    """(flax model, a fresh copy of the variables as a numpy tree, the
    port's model on the CPU loaded with them). The variables are the
    port's numpy init in the flax layout (its names and shapes are held
    to flax's own in test_torch_resnet.py) with every scale, bias and
    running statistic spread away from 0 and 1."""
    tree = jax.tree_util.tree_map(np.copy, _image_variables(kind, seed))
    port = convert.load_image_model(port_image_model(kind, dtype), tree)
    return flax_image_model(kind, dtype), tree, port


def images(seed, batch, shape):
    return np.random.default_rng(seed).standard_normal(
        (batch, *shape)).astype(np.float32)

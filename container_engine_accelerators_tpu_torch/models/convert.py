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

"""Carry TransformerLM weights from the flax layout to the port.

The flax tree (numpy leaves, f32) names each parameter by module path:
``tok_embed/embedding``, ``pos_embed/embedding`` (learned positions),
``block{i}/attn/LayerNorm_0``, ``block{i}/attn/qkv`` [E, 3, H, D] (MHA)
or ``attn/q`` [E, H, D] + ``attn/kv`` [E, 2, Hkv, D] (GQA),
``attn/proj`` [E, E], ``block{i}/LayerNorm_0``, ``Dense_0`` [E, 4E],
``Dense_1`` [4E, E], the top-level ``LayerNorm_0`` and ``lm_head``
[E, V]. A Dense kernel [in, out...] becomes a Linear weight
[out, in] with the out axes flattened in order, which is the feature
order the port's modules unflatten.
"""

import numpy as np
import torch

from .transformer import TransformerLM


def _dense(tree, path):
    """flax Dense/DenseGeneral leaf -> (Linear weight, bias)."""
    node = tree
    for key in path:
        node = node[key]
    kernel = np.asarray(node["kernel"])
    return kernel.reshape(kernel.shape[0], -1).T, node["bias"].reshape(-1)


def _norm(tree, path):
    node = tree
    for key in path:
        node = node[key]
    return node["scale"], node["bias"]


def _count_leaves(tree):
    if hasattr(tree, "keys"):
        return sum(_count_leaves(tree[k]) for k in tree.keys())
    return 1


def params_from_flax(tree):
    """flax TransformerLM params (a nested mapping of arrays) ->
    a state_dict for the port's TransformerLM (f32 CPU tensors)."""
    out = {}

    def tensor(value):
        # np.array copies: the tree's arrays may be read-only views.
        return torch.from_numpy(np.array(value, np.float32))

    def put(name, pair, suffixes=("weight", "bias")):
        for suffix, value in zip(suffixes, pair):
            out[f"{name}.{suffix}"] = tensor(value)

    out["tok_embed.weight"] = tensor(tree["tok_embed"]["embedding"])
    if "pos_embed" in tree:
        out["pos_embed.weight"] = tensor(tree["pos_embed"]["embedding"])
    layers = sorted(int(k[len("block"):]) for k in tree.keys()
                    if k.startswith("block"))
    if layers != list(range(len(layers))):
        raise ValueError(f"block indices are not 0..N-1: {layers}")
    for i in layers:
        blk, name = f"block{i}", f"blocks.{i}"
        put(f"{name}.attn.ln", _norm(tree, (blk, "attn", "LayerNorm_0")))
        if "qkv" in tree[blk]["attn"]:
            put(f"{name}.attn.qkv", _dense(tree, (blk, "attn", "qkv")))
        else:
            put(f"{name}.attn.q", _dense(tree, (blk, "attn", "q")))
            put(f"{name}.attn.kv", _dense(tree, (blk, "attn", "kv")))
        put(f"{name}.attn.proj", _dense(tree, (blk, "attn", "proj")))
        put(f"{name}.ln", _norm(tree, (blk, "LayerNorm_0")))
        put(f"{name}.mlp_in", _dense(tree, (blk, "Dense_0")))
        put(f"{name}.mlp_out", _dense(tree, (blk, "Dense_1")))
    put("ln_f", _norm(tree, ("LayerNorm_0",)))
    put("lm_head", _dense(tree, ("lm_head",)))
    if len(out) != _count_leaves(tree):
        # A leaf this converter does not know (int8 weights carry
        # scales, for one) must not be dropped silently.
        raise ValueError(
            f"flax tree has {_count_leaves(tree)} leaves, converted "
            f"{len(out)}: not a native-weights TransformerLM tree")
    return out


def init_flax_layout_params(config, seed):
    """A random numpy tree in the flax TransformerLM layout, made from
    ``seed`` with numpy alone (no JAX). Kernels are lecun-normal
    (std 1/sqrt(fan_in)), embeddings normal with std 1/sqrt(E);
    biases and norm affines get small random values so that a
    conversion that drops or misplaces them shows."""
    rng = np.random.default_rng(seed)
    e, v = config["embed_dim"], config["vocab_size"]
    heads = config["num_heads"]
    kv = config.get("num_kv_heads") or heads
    d = e // heads
    hidden = config.get("mlp_ratio", 4) * e

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def dense(in_dim, out_shape):
        return {"kernel": normal((in_dim,) + tuple(out_shape),
                                 in_dim ** -0.5),
                "bias": normal(tuple(out_shape), 0.02)}

    def norm():
        return {"scale": 1.0 + normal((e,), 0.02),
                "bias": normal((e,), 0.02)}

    tree = {"tok_embed": {"embedding": normal((v, e), e ** -0.5)}}
    if config.get("pos_embedding", "learned") == "learned":
        tree["pos_embed"] = {"embedding": normal(
            (config["max_seq_len"], e), e ** -0.5)}
    for i in range(config["num_layers"]):
        attn = {"LayerNorm_0": norm()}
        if kv == heads:
            attn["qkv"] = dense(e, (3, heads, d))
        else:
            attn["q"] = dense(e, (heads, d))
            attn["kv"] = dense(e, (2, kv, d))
        attn["proj"] = dense(e, (e,))
        tree[f"block{i}"] = {"attn": attn, "LayerNorm_0": norm(),
                             "Dense_0": dense(e, (hidden,)),
                             "Dense_1": dense(hidden, (e,))}
    tree["LayerNorm_0"] = norm()
    tree["lm_head"] = dense(e, (v,))
    return tree


def load_lm(config, tree, device="cuda", dtype=torch.bfloat16):
    """Build the port's TransformerLM from ``config`` (TransformerLM
    keyword arguments) on ``device`` and load a flax-layout tree into
    it. Runs on the card unless the caller asks for ``device="cpu"``."""
    model = TransformerLM(**config, dtype=dtype, device=device)
    model.load_state_dict(params_from_flax(tree))
    return model.eval().requires_grad_(False)

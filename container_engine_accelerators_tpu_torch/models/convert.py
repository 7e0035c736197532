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

"""Carry TransformerLM and image-model weights between the flax layout
and the port.

The flax tree (numpy leaves, f32) names each parameter by module path:
``tok_embed/embedding``, ``pos_embed/embedding`` (learned positions),
``block{i}/attn/LayerNorm_0``, ``block{i}/attn/qkv`` [E, 3, H, D] (MHA)
or ``attn/q`` [E, H, D] + ``attn/kv`` [E, 2, Hkv, D] (GQA),
``attn/proj`` [E, E], ``block{i}/LayerNorm_0``, ``Dense_0`` [E, 4E],
``Dense_1`` [4E, E], the top-level ``LayerNorm_0`` and ``lm_head``
[E, V]. A Dense kernel [in, out...] becomes a Linear weight
[out, in] with the out axes flattened in order, which is the feature
order the port's modules unflatten. ``params_to_flax`` is the
inverse, and ``flax_shapes`` the table of every leaf's flax path and
shape behind both; the weight-decay mask of the trainer reads the
flax ranks from it (the attention biases are rank 2-3 in flax and
rank 1 here).

The image models (ResNet, MnistMLP, InceptionV3) name their modules by
their flax paths, so ``image_layout`` reads the table from the model
itself: Conv HWIO <-> OIHW, Dense [in, out] <-> Linear [out, in], BN
``scale``/``bias`` <-> weight/bias in ``params``, and ``mean``/``var``
in ``batch_stats`` <-> the running-statistic buffers. Their flax ranks
are the torch ranks.
"""

import numpy as np
import torch

from .layers import _TRUNC_STD, BatchNorm, Conv
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


def flax_shapes(config):
    """{port state_dict name: (flax leaf path, flax shape)} for a
    TransformerLM ``config`` (its keyword arguments)."""
    e, v = config["embed_dim"], config["vocab_size"]
    heads = config["num_heads"]
    kv = config.get("num_kv_heads") or heads
    d = e // heads
    hidden = config.get("mlp_ratio", 4) * e
    out = {"tok_embed.weight": (("tok_embed", "embedding"), (v, e))}
    if config.get("pos_embedding", "learned") == "learned":
        out["pos_embed.weight"] = (("pos_embed", "embedding"),
                                   (config["max_seq_len"], e))

    def dense(name, path, in_dim, out_shape):
        out[f"{name}.weight"] = (path + ("kernel",), (in_dim, *out_shape))
        out[f"{name}.bias"] = (path + ("bias",), tuple(out_shape))

    def norm(name, path):
        out[f"{name}.weight"] = (path + ("scale",), (e,))
        out[f"{name}.bias"] = (path + ("bias",), (e,))

    for i in range(config["num_layers"]):
        blk, name = f"block{i}", f"blocks.{i}"
        norm(f"{name}.attn.ln", (blk, "attn", "LayerNorm_0"))
        if kv == heads:
            dense(f"{name}.attn.qkv", (blk, "attn", "qkv"), e, (3, heads, d))
        else:
            dense(f"{name}.attn.q", (blk, "attn", "q"), e, (heads, d))
            dense(f"{name}.attn.kv", (blk, "attn", "kv"), e, (2, kv, d))
        dense(f"{name}.attn.proj", (blk, "attn", "proj"), e, (e,))
        norm(f"{name}.ln", (blk, "LayerNorm_0"))
        dense(f"{name}.mlp_in", (blk, "Dense_0"), e, (hidden,))
        dense(f"{name}.mlp_out", (blk, "Dense_1"), hidden, (e,))
    norm("ln_f", ("LayerNorm_0",))
    dense("lm_head", ("lm_head",), e, (v,))
    return out


def params_to_flax(model_or_state_dict, config):
    """The inverse of ``params_from_flax``: the port's parameters (a
    TransformerLM or its state_dict) as a nested dict of f32 numpy
    arrays in the flax layout."""
    state = model_or_state_dict
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    shapes = flax_shapes(config)
    if set(state) != set(shapes):
        raise ValueError(
            f"state_dict names differ from the config's: "
            f"{sorted(set(state) ^ set(shapes))}")
    tree = {}
    for name, (path, shape) in shapes.items():
        value = state[name].detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            value = value.T  # Linear [out, in] -> Dense [in, out]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value.reshape(shape))
    return tree


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
    e = config["embed_dim"]
    tree = {}
    for path, shape in flax_shapes(config).values():
        leaf = path[-1]
        std = {"embedding": e ** -0.5,
               "kernel": shape[0] ** -0.5}.get(leaf, 0.02)
        value = (rng.standard_normal(shape) * std).astype(np.float32)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = 1.0 + value if leaf == "scale" else value
    return tree


def image_layout(model):
    """{state_dict name: (flax collection, flax path, flax shape)} for
    an image model of the port (ResNet, MnistMLP, InceptionV3), read
    from its modules, whose names are the flax module paths: a Conv's
    weight [O, I, kh, kw] is the ``params`` kernel [kh, kw, I, O]; a
    Linear's weight [out, in] the Dense kernel [in, out] and its bias
    the bias; a BatchNorm's weight and bias are ``params`` scale and
    bias, its running_mean and running_var ``batch_stats`` mean and
    var."""
    out = {}
    for prefix, module in model.named_modules():
        path = tuple(prefix.split(".")) if prefix else ()

        def put(suffix, collection, leaf, shape):
            out[f"{prefix}.{suffix}"] = (collection, path + (leaf,),
                                         tuple(shape))

        if isinstance(module, Conv):
            o, i, kh, kw = module.weight.shape
            put("weight", "params", "kernel", (kh, kw, i, o))
        elif isinstance(module, torch.nn.Linear):
            o, i = module.weight.shape
            put("weight", "params", "kernel", (i, o))
            put("bias", "params", "bias", (o,))
        elif isinstance(module, BatchNorm):
            shape = tuple(module.weight.shape)
            put("weight", "params", "scale", shape)
            put("bias", "params", "bias", shape)
            put("running_mean", "batch_stats", "mean", shape)
            put("running_var", "batch_stats", "var", shape)
    names = set(model.state_dict())
    if set(out) != names:
        raise ValueError(f"modules without a flax counterpart: "
                         f"{sorted(names ^ set(out))}")
    return out


def image_variables_from_flax(model, variables):
    """flax variables of an image model (``{"params": ...,
    "batch_stats": ...}``, nested mappings of arrays) -> a state_dict
    for the port's ``model`` (f32 CPU tensors). Raises if a leaf is
    missing, has another shape, or is one the model does not have."""
    out = {}
    for name, (collection, path, shape) in image_layout(model).items():
        node = variables
        try:
            for key in (collection,) + path:
                node = node[key]
        except KeyError:
            raise ValueError(f"flax variables lack {collection}/"
                             f"{'/'.join(path)}") from None
        value = np.array(node, np.float32)
        if value.shape != shape:
            raise ValueError(f"{collection}/{'/'.join(path)}: shape "
                             f"{value.shape}, want {shape}")
        if path[-1] == "kernel":
            # HWIO -> OIHW; Dense [in, out] -> Linear [out, in].
            value = (value.transpose(3, 2, 0, 1) if value.ndim == 4
                     else value.T)
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    if len(out) != _count_leaves(variables):
        raise ValueError(
            f"flax variables have {_count_leaves(variables)} leaves, "
            f"converted {len(out)}: not this model's tree")
    return out


def image_variables_to_flax(model):
    """The inverse of ``image_variables_from_flax``: the port's
    parameters and running statistics as ``{"params": ...,
    "batch_stats": ...}`` of f32 numpy arrays (no ``batch_stats`` for a
    model without BN)."""
    state = model.state_dict()
    tree = {}
    for name, (collection, path, _) in image_layout(model).items():
        value = state[name].detach().to("cpu", torch.float32).numpy()
        if path[-1] == "kernel":
            value = (value.transpose(2, 3, 1, 0) if value.ndim == 4
                     else value.T)
        node = tree.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return tree


def init_flax_layout_image(model, seed):
    """Random variables in the flax layout of the image ``model``
    (which may live on the meta device), made from ``seed`` with numpy
    alone and flax's initializers: lecun-normal kernels (a normal cut
    at two standard deviations, scaled to std 1/sqrt(fan_in)), zero
    biases, BN scale ones, or zeros where the module has flax's
    ``scale_init=zeros``, running mean 0 and var 1."""
    rng = np.random.default_rng(seed)
    modules = dict(model.named_modules())
    tree = {}
    for name, (collection, path, shape) in image_layout(model).items():
        leaf = path[-1]
        if leaf == "kernel":
            value = rng.standard_normal(shape)
            while True:
                out = np.abs(value) > 2.0
                if not out.any():
                    break
                value[out] = rng.standard_normal(int(out.sum()))
            value *= np.sqrt(1.0 / np.prod(shape[:-1])) / _TRUNC_STD
        elif leaf == "scale":
            zero = modules[name.rsplit(".", 1)[0]].zero_scale
            value = np.zeros(shape) if zero else np.ones(shape)
        elif leaf == "var":
            value = np.ones(shape)
        else:
            value = np.zeros(shape)
        node = tree.setdefault(collection, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = value.astype(np.float32)
    return tree


def load_image_model(model, variables):
    """Load flax-layout variables into the port's image ``model`` (in
    place, on the model's device and memory format); returns it."""
    model.load_state_dict(image_variables_from_flax(model, variables))
    return model


def load_lm(config, tree, device="cuda", dtype=torch.bfloat16,
            trainable=False, attention_fn=None):
    """Build the port's TransformerLM from ``config`` (TransformerLM
    keyword arguments) on ``device`` and load a flax-layout tree into
    it. Runs on the card unless the caller asks for ``device="cpu"``.

    For serving (the default) the parameters are held in the compute
    ``dtype`` and frozen, in eval mode. ``trainable=True`` holds them
    in f32 (flax's param_dtype), with ``requires_grad``, in train
    mode."""
    param_dtype = torch.float32 if trainable else dtype
    model = TransformerLM(**config, dtype=dtype, device=device,
                          param_dtype=param_dtype,
                          attention_fn=attention_fn)
    model.load_state_dict(params_from_flax(tree))
    if trainable:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)

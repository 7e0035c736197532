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

"""Carry TransformerLM, MoETransformerLM and image-model weights
between the flax layout and the port.

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

A MoETransformerLM tree (``num_experts`` in the config) has, at each
odd (routed) layer, ``block{i}/moe/gate`` [E_model, experts],
``moe/w_in`` [experts, E_model, 4E] and ``moe/w_out`` [experts, 4E,
E_model] in place of ``Dense_0``/``Dense_1``; the port keeps these
leaves in the same layout and rank (``blocks.{i}.moe.*``).

A ``weights="int8"`` tree (``models.quantized.convert_params_int8``,
or ``quantize_lm`` here) holds ``kernel_q`` int8 [in, *out], ``scale``
f32 [*out] and ``bias`` [*out] at the attention and MLP projections;
they become ``Int8Linear``'s int8 ``weight`` [out, in], ``scale`` [out]
and ``bias`` [out], which ``load_lm`` casts to the compute dtype.

The image models (ResNet, MnistMLP, InceptionV3) name their modules by
their flax paths, so ``image_layout`` reads the table from the model
itself: Conv HWIO <-> OIHW, Dense [in, out] <-> Linear [out, in], BN
``scale``/``bias`` <-> weight/bias in ``params``, and ``mean``/``var``
in ``batch_stats`` <-> the running-statistic buffers. Their flax ranks
are the torch ranks.

The JAX PipelinedLM's tree is {"tok_embed", "pos_embed", "blocks",
"ln", "lm_head"}, ``blocks`` being the block subtrees stacked on a
leading axis in placement order. ``pipeline_params_from_flax`` takes a
pipe rank's rows of it to the state_dict of the port's ``PipelinedLM``
(the TransformerLM names of its v blocks), and
``pipeline_params_to_flax`` takes that rank's parameters back.
"""

import numpy as np
import torch

from .layers import _TRUNC_STD, BatchNorm, Conv
from .moe import MoETransformerLM
from .quantized import convert_params_int8
from .transformer import TransformerLM


def _dense(tree, path):
    """flax Dense/DenseGeneral leaf -> {suffix: value}: (weight, bias)
    of a Linear, or (weight, scale, bias) of an Int8Linear for an
    Int8DenseGeneral node (``kernel_q`` int8)."""
    node = tree
    for key in path:
        node = node[key]
    if "kernel_q" in node:
        kernel = np.asarray(node["kernel_q"])
        return {"weight": kernel.reshape(kernel.shape[0], -1).T,
                "scale": np.asarray(node["scale"]).reshape(-1),
                "bias": np.asarray(node["bias"]).reshape(-1)}
    kernel = np.asarray(node["kernel"])
    return {"weight": kernel.reshape(kernel.shape[0], -1).T,
            "bias": np.asarray(node["bias"]).reshape(-1)}


def _norm(tree, path):
    node = tree
    for key in path:
        node = node[key]
    return {"weight": node["scale"], "bias": node["bias"]}


def _count_leaves(tree):
    if hasattr(tree, "keys"):
        return sum(_count_leaves(tree[k]) for k in tree.keys())
    return 1


def flax_shapes(config):
    """{port state_dict name: (flax leaf path, flax shape)} for a
    TransformerLM ``config`` (its keyword arguments; a MoETransformerLM's
    with ``num_experts``); with ``weights="int8"`` the projections'
    ``kernel_q``, ``scale`` and ``bias`` (the expert leaves stay
    native)."""
    e, v = config["embed_dim"], config["vocab_size"]
    experts = config.get("num_experts") or 0
    quant = config.get("weights", "native") == "int8"
    heads = config["num_heads"]
    kv = config.get("num_kv_heads") or heads
    d = e // heads
    hidden = config.get("mlp_ratio", 4) * e
    out = {"tok_embed.weight": (("tok_embed", "embedding"), (v, e))}
    if config.get("pos_embedding", "learned") == "learned":
        out["pos_embed.weight"] = (("pos_embed", "embedding"),
                                   (config["max_seq_len"], e))

    def dense(name, path, in_dim, out_shape, quantized=quant):
        kernel = "kernel_q" if quantized else "kernel"
        out[f"{name}.weight"] = (path + (kernel,), (in_dim, *out_shape))
        if quantized:
            out[f"{name}.scale"] = (path + ("scale",), tuple(out_shape))
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
        if experts and i % 2 == 1:
            for leaf, shape in (("gate", (e, experts)),
                                ("w_in", (experts, e, hidden)),
                                ("w_out", (experts, hidden, e))):
                out[f"{name}.moe.{leaf}"] = ((blk, "moe", leaf), shape)
            continue
        dense(f"{name}.mlp_in", (blk, "Dense_0"), e, (hidden,))
        dense(f"{name}.mlp_out", (blk, "Dense_1"), hidden, (e,))
    norm("ln_f", ("LayerNorm_0",))
    dense("lm_head", ("lm_head",), e, (v,), quantized=False)
    return out


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def params_to_flax(model_or_state_dict, config, tensors=False):
    """The inverse of ``params_from_flax``: the port's parameters (a
    TransformerLM or its state_dict) as a nested dict of f32 numpy
    arrays in the flax layout. ``tensors=True`` leaves each leaf a
    contiguous torch tensor on its own device (the transpose made
    there; a leaf that needs none may share the parameter's storage),
    for a checkpoint's snapshot to copy to the host."""
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
        value = state[name].detach()
        if path[-1] != "kernel_q":
            value = value.to(torch.float32)
        if path[-1] in ("kernel", "kernel_q"):
            value = value.T  # Linear [out, in] -> Dense [in, out]
        value = value.reshape(shape).contiguous()
        _put(tree, path, value if tensors else value.cpu().numpy())
    return tree


def params_from_flax(tree):
    """flax TransformerLM or MoETransformerLM params (a nested mapping
    of arrays, native or weights="int8") -> a state_dict for the port's
    model (CPU tensors: int8 quantized weights, f32 everything else; a
    routed layer's ``moe`` leaves keep their flax layout)."""
    out = {}

    def tensor(value):
        # np.array copies: the tree's arrays may be read-only views.
        if np.asarray(value).dtype == np.int8:
            return torch.from_numpy(np.array(value))
        return torch.from_numpy(np.array(value, np.float32))

    def put(name, leaves):
        for suffix, value in leaves.items():
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
        if "moe" in tree[blk]:
            put(f"{name}.moe", {leaf: tree[blk]["moe"][leaf]
                                for leaf in ("gate", "w_in", "w_out")})
            continue
        put(f"{name}.mlp_in", _dense(tree, (blk, "Dense_0")))
        put(f"{name}.mlp_out", _dense(tree, (blk, "Dense_1")))
    put("ln_f", _norm(tree, ("LayerNorm_0",)))
    put("lm_head", _dense(tree, ("lm_head",)))
    if len(out) != _count_leaves(tree):
        # A leaf this converter does not know must not be dropped
        # silently.
        raise ValueError(
            f"flax tree has {_count_leaves(tree)} leaves, converted "
            f"{len(out)}: not a TransformerLM or MoETransformerLM tree")
    return out


def init_flax_layout_params(config, seed):
    """A random numpy tree in the flax TransformerLM layout of the
    native weights (``quantize_lm`` makes the int8 tree from it), made
    from ``seed`` with numpy alone (no JAX). Kernels are lecun-normal
    (std 1/sqrt(fan_in)), embeddings normal with std 1/sqrt(E);
    biases and norm affines get small random values so that a
    conversion that drops or misplaces them shows. A routed layer's
    ``gate``, ``w_in`` and ``w_out`` take flax's lecun_normal itself (a
    normal cut at two standard deviations), whose fan-in counts the
    leading expert axis of a stacked kernel: std 1/sqrt(d) for the gate,
    1/sqrt(E * d) for w_in and 1/sqrt(E * f) for w_out."""
    rng = np.random.default_rng(seed)
    e = config["embed_dim"]
    tree = {}
    for path, shape in flax_shapes(dict(config, weights="native")).values():
        leaf = path[-1]
        if leaf in ("gate", "w_in", "w_out"):
            value = _lecun_normal(rng, shape)
        else:
            std = {"embedding": e ** -0.5,
                   "kernel": shape[0] ** -0.5}.get(leaf, 0.02)
            value = (rng.standard_normal(shape) * std).astype(np.float32)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = 1.0 + value if leaf == "scale" else value
    return tree


def _lecun_normal(rng, shape):
    """flax's lecun_normal on ``shape`` (numpy): a standard normal cut
    at +-2 (redrawn outside), scaled to std 1/sqrt(fan_in) with fan_in =
    shape[-2] times the receptive field, every axis before the last
    two."""
    value = rng.standard_normal(shape)
    flat = value.reshape(-1)
    # Redraw the cut entries in index order until none is left (only
    # the redrawn ones need a second look).
    out = np.flatnonzero(np.abs(flat) > 2.0)
    while out.size:
        flat[out] = rng.standard_normal(out.size)
        out = out[np.abs(flat[out]) > 2.0]
    value *= np.sqrt(1.0 / np.prod(shape[:-1])) / _TRUNC_STD
    return value.astype(np.float32)


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


def _image_from_flax(model, variables, collections, check_shapes=True):
    """{state_dict name: f32 CPU tensor} of the image ``model``'s
    entries in ``collections``, read from flax ``variables``; without
    ``check_shapes`` a leaf may differ from the model's own shape (a
    whole leaf for a model the mesh layout has sliced)."""
    out = {}
    for name, (collection, path, shape) in image_layout(model).items():
        if collection not in collections:
            continue
        node = variables
        try:
            for key in (collection,) + path:
                node = node[key]
        except KeyError:
            raise ValueError(f"flax variables lack {collection}/"
                             f"{'/'.join(path)}") from None
        value = np.array(node, np.float32)
        if check_shapes and value.shape != shape:
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


def image_variables_from_flax(model, variables, check_shapes=True):
    """flax variables of an image model (``{"params": ...,
    "batch_stats": ...}``, nested mappings of arrays) -> a state_dict
    for the port's ``model`` (f32 CPU tensors). Raises if a leaf is
    missing, has another shape (unless not ``check_shapes``), or is one
    the model does not have."""
    return _image_from_flax(model, variables, ("params", "batch_stats"),
                            check_shapes)


def _image_to_flax(model, state, tensors):
    """The flax tree of the image ``model``'s entries in ``state``
    ({state_dict name: tensor}): f32 numpy leaves, or contiguous f32
    tensors on their device with ``tensors=True``."""
    tree = {}
    for name, (collection, path, _) in image_layout(model).items():
        if name not in state:
            continue
        value = state[name].detach().to(torch.float32)
        if path[-1] == "kernel":
            value = (value.permute(2, 3, 1, 0) if value.dim() == 4
                     else value.T)
        value = value.contiguous()
        _put(tree.setdefault(collection, {}), path,
             value if tensors else value.cpu().numpy())
    return tree


def image_variables_to_flax(model, tensors=False):
    """The inverse of ``image_variables_from_flax``: the port's
    parameters and running statistics as ``{"params": ...,
    "batch_stats": ...}`` of f32 numpy arrays (no ``batch_stats`` for a
    model without BN); ``tensors`` as in ``params_to_flax``."""
    return _image_to_flax(model, model.state_dict(), tensors)


def named_params_to_flax(model, named, config=None, tensors=False):
    """{parameter name: tensor} of ``model`` (its parameters, an EMA
    shadow, momentum traces) -> the flax ``params`` tree: through
    ``params_to_flax`` for an LM of ``config``, through the image
    layout's ``params`` collection for an image model (``config``
    None). ``tensors`` as in ``params_to_flax``."""
    if config is not None:
        return params_to_flax(named, config, tensors=tensors)
    return _image_to_flax(model, named, tensors).get("params", {})


def named_params_from_flax(model, tree, config=None, check_shapes=True):
    """The inverse of ``named_params_to_flax``: {parameter name: f32
    CPU tensor} from a flax ``params`` tree (``check_shapes`` as in
    ``image_variables_from_flax``)."""
    if config is not None:
        return params_from_flax(tree)
    return _image_from_flax(model, {"params": tree}, ("params",),
                            check_shapes)


def opt_state_to_flax(optimizer, model, config=None, tensors=False):
    """The momentum traces of ``optimizer`` (the ``torch.optim.SGD`` of
    ``Sgd.init`` over ``model``) as optax's ``TraceState.trace``, in the
    flax layout of the params (``named_params_to_flax``). A parameter
    the optimizer has not stepped (or steps without momentum) has a
    zero trace, as ``optax.trace`` initialises it."""
    traces = {}
    for name, param in model.named_parameters():
        buf = optimizer.state.get(param, {}).get("momentum_buffer")
        traces[name] = torch.zeros_like(param) if buf is None else buf
    return named_params_to_flax(model, traces, config, tensors)


def opt_state_from_flax(optimizer, model, trace, config=None,
                        local=None):
    """The inverse of ``opt_state_to_flax``: set every parameter's
    ``momentum_buffer`` in ``optimizer`` from the flax-layout ``trace``
    (creating it on an optimizer that has not stepped, so that the next
    update is optax's ``trace = g + momentum * trace``), on the
    parameter's device, dtype and memory format. ``local(name, whole)``
    cuts a whole trace to the parameter's piece on a sharded model."""
    named = named_params_from_flax(model, trace, config,
                                   check_shapes=local is None)
    params = dict(model.named_parameters())
    if set(named) != set(params):
        raise ValueError(f"trace names differ from the model's: "
                         f"{sorted(set(named) ^ set(params))}")
    for name, value in named.items():
        param = params[name]
        if local is not None:
            value = local(name, value)
        optimizer.state[param]["momentum_buffer"] = (
            torch.empty_like(param).copy_(value))


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
            value = _lecun_normal(rng, shape)
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


def _stack_rows(rows, tensors):
    """Stack per-block subtrees (nested dicts) along a new leading
    axis."""
    first = rows[0]
    if isinstance(first, dict):
        return {k: _stack_rows([r[k] for r in rows], tensors)
                for k in first}
    return torch.stack(rows) if tensors else np.stack(rows)


def _row(tree, i):
    """Row ``i`` of a stacked subtree."""
    if hasattr(tree, "keys"):
        return {k: _row(tree[k], i) for k in tree.keys()}
    return tree[i]


def pipeline_tree(tree, order):
    """A flax TransformerLM tree (``block{i}`` subtrees) -> the JAX
    PipelinedLM's layout: {"tok_embed", "pos_embed", "blocks" (the
    block subtrees stacked, row k holding natural block ``order[k]``),
    "ln", "lm_head"} (numpy)."""
    return {"tok_embed": tree["tok_embed"], "pos_embed": tree["pos_embed"],
            "blocks": _stack_rows([tree[f"block{int(i)}"] for i in order],
                                  tensors=False),
            "ln": tree["LayerNorm_0"], "lm_head": tree["lm_head"]}


def pipeline_params_from_flax(tree, rows):
    """The JAX PipelinedLM tree (numpy or arrays; ``blocks`` stacked in
    placement order) -> the state_dict of a port ``PipelinedLM`` holding
    placement ``rows`` (its ``blocks.{r}`` is row ``rows[r]``): the
    TransformerLM names of a model of len(rows) layers, through
    ``params_from_flax``."""
    lm = {"tok_embed": tree["tok_embed"], "pos_embed": tree["pos_embed"],
          "LayerNorm_0": tree["ln"], "lm_head": tree["lm_head"]}
    for r, row in enumerate(rows):
        lm[f"block{r}"] = _row(tree["blocks"], row)
    return params_from_flax(lm)


def pipeline_params_to_flax(named, config, tensors=False):
    """The inverse of ``pipeline_params_from_flax`` for one rank: {port
    name: tensor} of a ``PipelinedLM`` (its parameters, or momentum
    traces by parameter name) with ``config`` its TransformerLM keywords
    (``PipelinedLM.config()``, v layers) -> the JAX layout with this
    rank's v rows stacked as ``blocks`` (f32 numpy; ``tensors`` leaves
    tensors on their device, as in ``params_to_flax``). A caller
    gathers ``blocks`` over the pipe axis for the whole stack."""
    lm = params_to_flax(named, dict(config, pos_embedding="learned"),
                        tensors=tensors)
    return {"tok_embed": lm["tok_embed"], "pos_embed": lm["pos_embed"],
            "blocks": _stack_rows([lm[f"block{r}"]
                                   for r in range(config["num_layers"])],
                                  tensors),
            "ln": lm["LayerNorm_0"], "lm_head": lm["lm_head"]}


def quantize_lm(config, tree):
    """A native flax-layout tree -> the ``weights="int8"`` tree of the
    same ``config``, through ``convert_params_int8`` (numpy alone), as
    the demo launcher's ``--quantize-weights=int8`` converts. The
    template's biases are f32 (numpy has no bfloat16): ``load_lm``
    rounds them to the compute dtype, where the flax conversion
    rounds them to bf16."""
    template = {}
    for path, shape in flax_shapes(dict(config, weights="int8")).values():
        node = template
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.zeros(
            shape, np.int8 if path[-1] == "kernel_q" else np.float32)
    return convert_params_int8(template, tree)


def load_lm(config, tree, device="cuda", dtype=torch.bfloat16,
            trainable=False, attention_fn=None):
    """Build the port's TransformerLM from ``config`` (TransformerLM
    keyword arguments; a MoETransformerLM when it has ``num_experts``)
    on ``device`` and load a flax-layout tree into it (native, or int8
    with ``weights="int8"`` in ``config``). Runs on the card unless the
    caller asks for ``device="cpu"``.

    For serving (the default) the parameters are held in the compute
    ``dtype`` and frozen, in eval mode. ``trainable=True`` holds them
    in f32 (flax's param_dtype), with ``requires_grad``, in train
    mode; int8 weights serve only."""
    if trainable and config.get("weights", "native") != "native":
        raise ValueError("int8 weights are for serving; "
                         "trainable=True needs native weights")
    param_dtype = torch.float32 if trainable else dtype
    cls = MoETransformerLM if config.get("num_experts") else TransformerLM
    model = cls(**config, dtype=dtype, device=device,
                param_dtype=param_dtype, attention_fn=attention_fn)
    model.load_state_dict(params_from_flax(tree))
    if trainable:
        return model.train().requires_grad_(True)
    return model.eval().requires_grad_(False)

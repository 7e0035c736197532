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

"""Sharding rules: batch over "data", wide parameters over "model"
(counterpart of container_engine_accelerators_tpu/parallel/sharding.py).

``_param_spec`` is the JAX module's rule, rule for rule, on a leaf's
flax path and flax shape: a spec is a tuple with one entry a flax dim,
an axis name or None, and ``()`` is replicated. The port's parameters
keep their flax names through ``models/convert.py`` (``flax_shapes``
for the LMs, ``image_layout`` for the image models), so
``param_shardings`` keys each rule on the same leaf the JAX layout
reads and maps the sharded flax dims onto the torch tensor's dims:

- a Dense kernel [in, *out] is a Linear weight [prod(out), in]: flax
  dim 0 is torch dim 1, the leading out dim is torch dim 0 (its
  contiguous blocks are contiguous blocks of the flattened dim);
- a Conv kernel [kh, kw, I, O] is a weight [O, I, kh, kw];
- embeddings, biases, norm scales and the MoE leaves keep flax's
  order.

A layout that shards a dim without a contiguous torch counterpart (a
trailing out dim of a DenseGeneral) raises; no MODEL leaf has one.
"""

import dataclasses
import logging

from .expert import EXPERT_AXIS
from .mesh import DATA_AXIS, MODEL_AXIS, axis_size

log = logging.getLogger(__name__)

# The expert-kernel naming contract: stacked per-expert kernels are
# parameters named exactly one of these, inside a module whose flax
# name is "moe" or auto-named "MoEMlp_N".
_EXPERT_PARAM_NAMES = frozenset({"w_in", "w_out"})


def _is_expert_module(name):
    name = str(name).lower()
    return name == "moe" or name.startswith("moemlp")


# Parameters whose trailing (output-feature) dim is at least this wide
# are sharded over the model axis; smaller ones stay replicated.
_MIN_SHARD_DIM = 512


def replicated(mesh):
    """The layout of a replicated value: no dim sharded."""
    return ()


def batch_sharding(mesh):
    """Leading-axis (batch) sharding over the data axis."""
    return (DATA_AXIS,)


def _param_spec(path, shape, model_parallel, expert_parallel, fsdp=0):
    """The JAX rule on one leaf: ``path`` its flax key path, ``shape``
    its flax shape; returns the spec tuple (``()`` when replicated)."""
    shape = tuple(shape)
    keys = [str(getattr(k, "key", k)) for k in path]
    in_expert_module = any(_is_expert_module(k) for k in keys[:-1])
    spec = [None] * len(shape)
    if expert_parallel and in_expert_module and len(shape) >= 3:
        if (keys[-1] in _EXPERT_PARAM_NAMES
                and shape[0] % expert_parallel == 0):
            # expert_parallel_moe's layout: per-expert kernels whole
            # within an expert shard; nothing else shards them.
            spec[0] = EXPERT_AXIS
            return tuple(spec)
        log.warning(
            "param %s (shape %s) sits in an expert module but does not "
            "match the expert-kernel contract (names %s, leading dim "
            "divisible by %d); leaving it replicated",
            "/".join(keys), shape, sorted(_EXPERT_PARAM_NAMES),
            expert_parallel)
    # The output-features dim (last axis of both conv HWIO and dense IO
    # kernels) when it is wide and divides.
    if (model_parallel and len(shape) >= 2 and spec[-1] is None
            and shape[-1] >= _MIN_SHARD_DIM
            and shape[-1] % model_parallel == 0):
        spec[-1] = MODEL_AXIS
    # FSDP: the largest dim still free goes over the data axis, for
    # kernels of 2-D or more only (a norm's scale is not worth a
    # gather a step).
    if fsdp and len(shape) >= 2:
        for i in sorted(range(len(shape)), key=lambda i: -int(shape[i])):
            if (spec[i] is None and shape[i] >= _MIN_SHARD_DIM
                    and shape[i] % fsdp == 0):
                spec[i] = DATA_AXIS
                break
    return tuple(spec) if any(s is not None for s in spec) else ()


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """One parameter's layout: its flax path and shape, the JAX spec,
    and the torch dims the data, model and expert axes shard (None:
    whole)."""

    name: str
    flax_path: tuple
    flax_shape: tuple
    spec: tuple
    data_dim: object = None
    model_dim: object = None
    expert_dim: object = None

    @property
    def sharded(self):
        return (self.data_dim is not None or self.model_dim is not None
                or self.expert_dim is not None)


def _dense_dims(flax_shape):
    """flax dim -> torch dim of a Dense kernel [in, *out] held as
    [prod(out), in] (None: no contiguous torch dim)."""
    dims = [1] + [None] * (len(flax_shape) - 1)
    if len(flax_shape) > 1:
        dims[1] = 0
    return dims


def _leading_dims(flax_shape):
    """flax dim -> torch dim of a leaf whose leading flax dim is the
    flattened torch dim 0 (a DenseGeneral's bias [*out])."""
    return [0] + [None] * (len(flax_shape) - 1)


def lm_config_of(model):
    """The TransformerLM (or MoETransformerLM) config of ``model``, the
    keyword arguments ``convert.flax_shapes`` reads; None for a model
    that is not one of the port's LMs."""
    from ..models.moe import MoETransformerLM
    from ..models.transformer import TransformerLM

    if not isinstance(model, (TransformerLM, MoETransformerLM)):
        return None
    config = dict(vocab_size=model.vocab_size, embed_dim=model.embed_dim,
                  num_layers=model.num_layers, num_heads=model.num_heads,
                  num_kv_heads=model.num_kv_heads,
                  pos_embedding=model.pos_embedding,
                  max_seq_len=model.max_seq_len,
                  mlp_ratio=getattr(model, "mlp_ratio", 4),
                  weights=getattr(model, "weights", "native"))
    if isinstance(model, MoETransformerLM):
        config["num_experts"] = model.num_experts
    return config


def flax_layout(model):
    """{parameter name: (flax path, flax shape, torch dim of each flax
    dim)} for the port's model: an LM through ``convert.flax_shapes``
    of its config (``lm_config_of``); an image model through
    ``convert.image_layout``; any other module through its own
    parameters (a Linear's weight as a Dense kernel, a Conv's as a Conv
    kernel, the rest in torch order)."""
    from ..models import convert
    from ..models.layers import Conv

    out = {}
    config = lm_config_of(model)
    if config is not None:
        for name, (path, shape) in convert.flax_shapes(config).items():
            if path[-1] in ("kernel", "kernel_q"):
                dims = _dense_dims(shape)
            elif path[-1] == "bias" or path[-1] == "scale":
                dims = _leading_dims(shape)
            else:
                dims = list(range(len(shape)))
            out[name] = (path, tuple(shape), dims)
        return out
    try:
        layout = convert.image_layout(model)
    except ValueError:
        layout = None
    if layout is not None:
        params = dict(model.named_parameters())
        for name, (collection, path, shape) in layout.items():
            if name not in params:
                continue
            if path[-1] == "kernel" and len(shape) == 4:
                dims = [2, 3, 1, 0]
            elif path[-1] == "kernel":
                dims = _dense_dims(shape)
            else:
                dims = list(range(len(shape)))
            out[name] = (tuple(path), tuple(shape), dims)
        return out
    import torch

    for prefix, module in model.named_modules():
        for leaf, param in module.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}" if prefix else leaf
            path = tuple(prefix.split(".")) if prefix else ()
            torch_shape = tuple(param.shape)
            if isinstance(module, torch.nn.Linear) and leaf == "weight":
                shape, dims = torch_shape[::-1], [1, 0]
                path += ("kernel",)
            elif isinstance(module, Conv) and leaf == "weight":
                o, i, kh, kw = torch_shape
                shape, dims = (kh, kw, i, o), [2, 3, 1, 0]
                path += ("kernel",)
            else:
                shape, dims = torch_shape, list(range(len(torch_shape)))
                path += (leaf,)
            out[name] = (path, shape, dims)
    return out


def param_shardings(mesh, model, fsdp=False):
    """{parameter name: ParamLayout} for ``model`` on ``mesh``.

    With a 1-wide model axis everything is replicated over it; with
    model parallelism wide kernels shard their out-features over
    MODEL_AXIS; with an expert axis stacked MoE kernels shard their
    expert dim; ``fsdp=True`` additionally shards each big kernel's
    largest free dim over DATA_AXIS."""
    mp = axis_size(mesh, MODEL_AXIS)
    ep = axis_size(mesh, EXPERT_AXIS)
    dp = axis_size(mesh, DATA_AXIS)
    mp = mp if mp > 1 else 0
    ep = ep if ep > 1 else 0
    dp = dp if (fsdp and dp > 1) else 0
    out = {}
    for name, (path, shape, dims) in flax_layout(model).items():
        spec = _param_spec(path, shape, mp, ep, dp)
        axes = {}
        for flax_dim, axis in enumerate(spec):
            if axis is None:
                continue
            if dims[flax_dim] is None:
                raise ValueError(
                    f"{name}: flax dim {flax_dim} of {shape} has no "
                    f"contiguous torch dim to shard over {axis!r}")
            axes[axis] = dims[flax_dim]
        out[name] = ParamLayout(name, tuple(path), tuple(shape), spec,
                                axes.get(DATA_AXIS), axes.get(MODEL_AXIS),
                                axes.get(EXPERT_AXIS))
    return out

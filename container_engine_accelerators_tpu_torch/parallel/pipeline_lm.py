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

"""Pipeline-parallel TransformerLM training (counterpart of
container_engine_accelerators_tpu/parallel/pipeline_lm.py).

The transformer blocks are the pipeline stages (a ``Block`` is [B, S,
E] in and out, the schedule's contract); the embeddings, the final
LayerNorm and the f32 lm_head run outside the pipe, replicated over
it, on this data rank's rows. The blocks are stored in placement order
(``circular_stage_order``) for the model's ``pipe`` size, and pipe rank
d holds placement rows [d·v, (d+1)·v), v = num_layers / pipe: the
circular schedule runs v stages a rank with the v-times-smaller
bubble.

The JAX model is a frozen dataclass over an explicit pytree whose
``blocks`` are stacked; here it is an ``nn.Module`` holding this
rank's v ``Block``s under the TransformerLM's parameter names
(``tok_embed``, ``pos_embed``, ``blocks.{r}``, ``ln_f``, ``lm_head``),
so a rank's state_dict is that of a TransformerLM of v layers and its
weights convert with the existing converter
(``convert.pipeline_params_from_flax``). ``stage=None`` holds every
row, the whole placement-ordered stack (``reference_apply``'s oracle,
and the model of a one-rank pipe). The blocks attend through
``flash_attention`` (the CUDA kernels on the card, their plain
versions on the CPU).
"""

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.utils.checkpoint

from ..models import convert
from ..models.transformer import Block, Embedding, LayerNorm
from .collectives import _gather_dim
from .mesh import DATA_AXIS, axis_group, axis_index, axis_size
from .pipeline import (
    PIPELINE_AXIS,
    _tree_map,
    circular_pipeline_apply,
    circular_stage_order,
    stage_sharding,
)


class PipelinedLM(nn.Module):
    """A causal LM whose blocks run as pipeline stages (module
    docstring). ``pipe`` is part of the model: the block stack is in
    placement order for exactly that pipe size, and ``apply`` refuses
    a mesh whose pipe axis differs. ``num_layers`` must be a multiple
    of ``pipe``. ``remat`` recomputes each stage in the backward
    (``torch.utils.checkpoint`` around the stage only; the hops stay
    outside it), saving only the stage input a tick."""

    def __init__(self, vocab_size, embed_dim, num_layers, num_heads,
                 max_seq_len, pipe, mlp_ratio=4, dtype=torch.bfloat16,
                 remat=False, stage=None, device="cuda",
                 param_dtype=torch.float32):
        super().__init__()
        if pipe < 1 or num_layers % pipe != 0:
            raise ValueError(
                f"{num_layers} layers do not fold onto pipe={pipe}")
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.num_layers, self.num_heads = num_layers, num_heads
        self.max_seq_len, self.pipe = max_seq_len, pipe
        self.mlp_ratio, self.dtype, self.remat = mlp_ratio, dtype, remat
        v = num_layers // pipe
        self.rows = (range(num_layers) if stage is None else
                     range(stage * v, (stage + 1) * v))
        dd = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.tok_embed = Embedding(vocab_size, embed_dim, **dd)
        self.pos_embed = Embedding(max_seq_len, embed_dim, **dd)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, dtype=dtype,
                  device=device, param_dtype=param_dtype)
            for _ in self.rows)
        self.ln_f = LayerNorm(embed_dim, dtype, device)
        self.lm_head = nn.Linear(embed_dim, vocab_size, device=device)

    def config(self):
        """The TransformerLM keywords of this rank's parameters (v
        layers): what the converter and the decay mask read."""
        return dict(vocab_size=self.vocab_size, embed_dim=self.embed_dim,
                    num_layers=len(self.rows), num_heads=self.num_heads,
                    max_seq_len=self.max_seq_len, mlp_ratio=self.mlp_ratio)

    def init(self, seed):
        """The whole parameter tree, numpy in the JAX PipelinedLM's
        layout ({"tok_embed", "pos_embed", "blocks" stacked in placement
        order, "ln", "lm_head"}), made from ``seed`` with numpy alone
        (``convert.init_flax_layout_params``' initializers, natural
        stage i from its ``block{i}``)."""
        config = dict(self.config(), num_layers=self.num_layers)
        tree = convert.init_flax_layout_params(config, seed)
        order = circular_stage_order(self.num_layers, self.pipe)
        return convert.pipeline_tree(tree, order)

    def load(self, tree):
        """Load this rank's rows of a whole tree in the JAX layout."""
        self.load_state_dict(convert.pipeline_params_from_flax(
            tree, self.rows))
        return self

    def shardings(self, mesh):
        """The placement rows this rank holds on ``mesh``: rank d holds
        [d·v, (d+1)·v)."""
        self._check_mesh(mesh)
        d = 0 if mesh is None else axis_index(mesh, PIPELINE_AXIS)
        return stage_sharding(mesh, self.num_layers)[d]

    def _check_mesh(self, mesh):
        p = 1 if mesh is None else dict(zip(
            mesh.mesh_dim_names, mesh.mesh.shape)).get(PIPELINE_AXIS, 1)
        if p != self.pipe:
            raise ValueError(
                f"mesh pipe axis {p} != model pipe {self.pipe}: the block "
                f"stack is in placement order for {self.pipe} devices")

    def _embed(self, tokens):
        s = tokens.shape[1]
        if s > self.max_seq_len:
            raise ValueError(f"sequence length {s} exceeds max_seq_len "
                             f"{self.max_seq_len}")
        pos = torch.arange(s, device=tokens.device)
        return self.tok_embed(tokens) + self.pos_embed(pos)[None]

    def _head(self, x):
        """The final norm and the f32 lm_head on an f32 copy."""
        return self.lm_head(self.ln_f(x).float())

    def apply(self, tokens, *, mesh, num_microbatches):
        """tokens [B_local, S] (this data rank's rows) -> logits [B_local,
        S, V] f32, through the circular schedule over ``mesh``'s pipe
        axis (None: a one-rank pipe). This rank must hold its mesh
        coordinate's rows."""
        self._check_mesh(mesh)
        rows = self.shardings(mesh)
        if list(rows) != list(self.rows):
            raise ValueError(
                f"this model holds placement rows {list(self.rows)}; "
                f"its pipe rank runs {list(rows)}")

        def stage_fn(block, h):
            if self.remat:
                return torch.utils.checkpoint.checkpoint(
                    block, h, use_reentrant=False)
            return block(h)

        x = circular_pipeline_apply(
            mesh, stage_fn, self.blocks, self._embed(tokens),
            num_microbatches=num_microbatches, pre_permuted=True)
        return self._head(x)

    def reference_apply(self, tokens):
        """The same computation with the blocks folded sequentially on
        one device, placement order inverted back to natural (needs
        every row: ``stage=None``)."""
        if len(self.rows) != self.num_layers:
            raise ValueError("reference_apply needs every block "
                             "(stage=None)")
        order = list(circular_stage_order(self.num_layers, self.pipe))
        x = self._embed(tokens)
        for stage in range(self.num_layers):
            x = self.blocks[order.index(stage)](x)
        return self._head(x)



# -- the step's collectives and the checkpoint payload ----------------


def _group(mesh, axis):
    """The axis' group, or None where it is one rank wide."""
    if mesh is None or axis_size(mesh, axis) == 1:
        return None
    return axis_group(mesh, axis)


def local_batch(mesh, x):
    """This data rank's rows of a global batch (the batch itself on a
    one-rank data axis)."""
    n = 1 if mesh is None else axis_size(mesh, DATA_AXIS)
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} does not divide over "
                         f"data={n} ranks")
    size = x.shape[0] // n
    i = 0 if n == 1 else axis_index(mesh, DATA_AXIS)
    return x[i * size:(i + 1) * size]


@torch.no_grad()
def reduce_grads(model, mesh):
    """Average every gradient over the data axis (one flat all-reduce a
    dtype): the global batch's mean. Block gradients stay on their pipe
    rank; the replicated leaves' are equal across the pipe axis (every
    pipe rank computes the same loss on the broadcast outputs)."""
    group = _group(mesh, DATA_AXIS)
    if group is None:
        return
    n = dist.get_world_size(group)
    by_dtype = {}
    for param in model.parameters():
        if param.grad is not None:
            by_dtype.setdefault(param.grad.dtype, []).append(param.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def mean_over_data(value, mesh):
    """The step's loss averaged over the data axis."""
    out = value.detach().float()
    group = _group(mesh, DATA_AXIS)
    if group is None:
        return out
    out = out.clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


@torch.no_grad()
def grad_norm(model, mesh):
    """The L2 norm of the whole gradient (every stage's), which the
    optimizer's clip reads: the blocks' squares summed over the pipe
    axis, the replicated leaves' counted once. None on a one-rank pipe
    axis, where the local gradients are the whole."""
    group = _group(mesh, PIPELINE_AXIS)
    if group is None:
        return None
    parts = torch.zeros(2, dtype=torch.float32,
                        device=next(model.parameters()).device)
    for name, param in model.named_parameters():
        if param.grad is not None:
            idx = 1 if name.startswith("blocks.") else 0
            parts[idx] += torch.linalg.vector_norm(param.grad.float()) ** 2
    dist.all_reduce(parts[1:], group=group)
    return parts.sum().sqrt()


def decay_mask(model):
    """The JAX pipeline driver's weight-decay mask: leaves of rank >= 2
    in its tree, where the blocks are stacked (so every block leaf
    decays, its biases and norms too)."""
    shapes = convert.flax_shapes(model.config())

    def mask(name, _param):
        return name.startswith("blocks.") or len(shapes[name][1]) >= 2

    return mask


def _flax_tree(model, named, mesh, whole):
    """{name: tensor} of ``model`` -> the JAX layout, its block rows
    gathered over the pipe axis when ``whole`` (collective)."""
    tree = convert.pipeline_params_to_flax(named, model.config(),
                                           tensors=True)
    group = _group(mesh, PIPELINE_AXIS)
    if whole and group is not None:
        tree["blocks"] = _tree_map(lambda w: _gather_dim(w, 0, group),
                                   tree["blocks"])
    return tree


def pipeline_payload(model, optimizer, step, mesh, schedule=False,
                     whole=True):
    """The JAX pipeline driver's checkpoint payload, {step, params,
    opt_state}: the parameters and the momentum traces in its layout
    (``opt_state`` as its optax chain holds them, the traces at
    ``[2][0].trace`` and, under a learning-rate schedule, the update
    count at ``[2][1].count``). With ``whole`` the block rows are
    gathered over the pipe axis (every pipe rank enters; rank 0
    writes); without it the tree has this rank's rows, which gives a
    restore its paths."""
    from .checkpoint import EmptyState, ScaleByScheduleState, TraceState

    named = dict(model.named_parameters())
    traces = {}
    for name, param in named.items():
        buf = optimizer.state.get(param, {}).get("momentum_buffer")
        traces[name] = buf if buf is not None else torch.zeros_like(param)
    step = np.asarray(step, np.int32)
    rate = ScaleByScheduleState(count=step) if schedule else EmptyState()
    return {"step": step,
            "params": _flax_tree(model, named, mesh, whole),
            "opt_state": (EmptyState(), EmptyState(),
                          (TraceState(trace=_flax_tree(model, traces, mesh,
                                                       whole)), rate))}


@torch.no_grad()
def load_payload(model, optimizer, restored):
    """Load a restored payload (whole leaves) into this rank's model
    and optimizer: its rows of the parameters and momentum traces.
    Returns the step."""
    model.load(restored["params"])
    traces = convert.pipeline_params_from_flax(
        restored["opt_state"][2][0].trace, model.rows)
    for name, param in model.named_parameters():
        optimizer.state[param]["momentum_buffer"] = (
            torch.empty_like(param).copy_(traces[name]))
    return int(restored["step"])

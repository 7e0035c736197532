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

"""The Trainer's step on a ("data", "model") mesh: the compute GSPMD
derives from the JAX layout, written out over ``torch.distributed``.

``Spmd(mesh, model, fsdp)`` lays ``model``'s parameters out by
``sharding.param_shardings`` and keeps their names (so the optimizer's
decay mask, the EMA shadow and the checkpoint layout read them as on
one device):

- **data axis.** Each data rank takes its slice of the global batch
  (``local_batch``). After the backward the gradients of parameters
  whole over the data axis are averaged over it (``reduce_grads``,
  one all-reduce a dtype), so the update is the one of the global
  batch. Every BatchNorm reduces its f32 batch mean and mean square
  over the axis (``BatchNorm.stats_reduce``), for the normalisation
  and for the running statistics, as the global-batch statistics of
  the JAX step. On a data axis one rank wide none of these runs, as
  GSPMD does no work on a 1-wide axis.
- **model axis.** A parameter whose out-features the rule shards over
  "model" holds this rank's columns; its module is column-parallel:
  the input enters through ``CopyToGroup`` (the backward sums the
  partial input gradients over the axis), the module computes its
  columns (a replicated bias enters as its slice), and the output is
  gathered along the features (the backward takes this rank's slice).
  Everything else runs replicated on the axis' ranks, attention
  included: under MODEL's layout the q/kv kernels' last flax dim is
  the head dim (64), under the 512 rule, so every rank runs the flash
  kernels on all heads, as GSPMD does with replicated q/kv.
- **FSDP.** A parameter the rule shards over "data" is stored as this
  rank's 1/N (and so is its momentum buffer, which the optimizer makes
  in the parameter's shape, and its EMA shadow). At use its module
  gathers it (``ShardGather``); the backward reduce-scatters the
  gradient back to the shard, averaged over the data ranks.

The per-module work is a pair of forward hooks on each module owning a
sharded parameter: the pre-hook swaps the stored shard for the tensor
the module computes with (and routes the input), the post-hook swaps it
back (and gathers the output). A module's forward reads its own
parameters, so any module type works; a forward recomputed under remat
re-runs the hooks, and ``torch.func.functional_call`` (the eval step on
an EMA shadow) swaps its tensors in before the pre-hook reads them.

``grad_norm`` is the norm of the whole gradient across the mesh, which
the optimizer's ``clip_by_global_norm`` reads; a rank's own gradients
are shards of it.

``full_state`` is the collective context in which every sharded leaf
(parameter, momentum buffer, EMA shadow) is whole, for a checkpoint's
save or restore; on exit they are sliced back.

Two more axes:

- **context** (``parallel/context.py``'s mesh). Each context rank
  runs the forward on its contiguous S/P slice of its data rank's rows
  (``local_sequence``); the model's attention_fn is the ring or
  Ulysses schedule over the axis, and the model reads its positions
  from the slice's global offset (``TransformerLM.seq_offset``). A
  rank's loss is its share of its data rank's mean (the Trainer
  weighs it by its share of the shifted positions), so the gradients
  of the (replicated) parameters are summed over the axis before the
  data-axis average, and so is the reported loss.
- **expert** (``parallel/expert.py``'s mesh). The stacked expert
  kernels a MoE layer bound to the mesh holds are this rank's E/P
  experts (``MoEMlp`` with ``mesh``, ``expert_parallel_moe``); the
  rest of the model runs replicated over the axis. A MoE layer not
  bound to the mesh gathers the expert-sharded kernels at use.

The three together (the multichip dryrun's ("data", "context",
"expert") mesh, ``parallel/dryrun.py``) compose as written: each
context rank runs its sequence slice, the bound MoE layers re-lay their
(data, context) block out to the JAX layer's routing groups
(``expert.residual_moe``), the gradients are summed over "context" and
then averaged over "data" (the expert-sharded kernels too, once each;
nothing is reduced over "expert"), and the clip's norm sums the
expert-sharded squares over "expert".

A MoE layer not bound to the mesh, on a mesh whose tokens are split
over "data" or "context", routes the global batch, as GSPMD runs
``dense_moe`` there (``expert.global_batch_moe``); on a model axis its
tokens are replicated and it routes them as one device does, on its
kernels gathered whole at use (the JAX rule shards their last dims
over "model", as it does any wide kernel's).
"""

import contextlib

import torch
import torch.distributed as dist

from ..models.layers import BatchNorm, Conv
from ..utils import not_ported
from .collectives import (
    AllReduceSum,
    CopyToGroup,
    GatherAlong,
    ShardGather,
    SliceAlong,
    _gather_dim,
    local_slice,
)
from .context import CONTEXT_AXIS
from .expert import EXPERT_AXIS
from .mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_index, axis_size
from .sharding import param_shardings

_AXES = (DATA_AXIS, MODEL_AXIS, CONTEXT_AXIS, EXPERT_AXIS)


def _stats_reducer(group):
    """A BatchNorm's batch-statistics reduction over ``group``: the mean
    of the ranks' [mean, mean square] (equal-size batch slices)."""
    n = dist.get_world_size(group)

    def reduce(stats):
        return AllReduceSum.apply(stats, group) / n

    return reduce


class Spmd:
    """The sharded layout and step plumbing of one model on ``mesh``
    (module docstring)."""

    def __init__(self, mesh, model, fsdp=False):
        if not set(mesh.mesh_dim_names) <= set(_AXES):
            raise not_ported(f"a mesh with axes {mesh.mesh_dim_names}")
        self.mesh = mesh
        self.dp = axis_size(mesh, DATA_AXIS)
        self.mp = axis_size(mesh, MODEL_AXIS)
        self.cp = axis_size(mesh, CONTEXT_AXIS)
        self.ep = axis_size(mesh, EXPERT_AXIS)
        self.data_index = axis_index(mesh, DATA_AXIS)
        self.context_index = axis_index(mesh, CONTEXT_AXIS)
        names = mesh.mesh_dim_names
        self.data_group = axis_group(mesh, DATA_AXIS)
        self.model_group, self.context_group, self.expert_group = (
            axis_group(mesh, axis) if axis in names else None
            for axis in (MODEL_AXIS, CONTEXT_AXIS, EXPERT_AXIS))
        self.layouts = param_shardings(mesh, model, fsdp=fsdp)
        self._shard(model)

    # -- layout ---------------------------------------------------------

    def _sliced_dims(self, layout):
        """(dim, group) of each axis wider than one rank that shards
        ``layout``'s leaf, in slicing order."""
        out = []
        for dim, size, group in (
                (layout.model_dim, self.mp, self.model_group),
                (layout.expert_dim, self.ep, self.expert_group),
                (layout.data_dim, self.dp, self.data_group)):
            if dim is not None and size > 1:
                out.append((dim, group))
        return out

    def _local(self, full, layout):
        """This rank's piece of a whole leaf."""
        t = full
        for dim, group in self._sliced_dims(layout):
            t = local_slice(t, dim, group)
        return t.clone()

    def _whole(self, local, layout):
        """The whole leaf from every rank's piece (collective)."""
        t = local
        for dim, group in reversed(self._sliced_dims(layout)):
            t = _gather_dim(t, dim, group)
        return t

    def _shard(self, model):
        from ..models.moe import MoEMlp

        owners = {}
        for prefix, module in model.named_modules():
            moe = isinstance(module, MoEMlp)
            for leaf, param in module.named_parameters(recurse=False):
                name = f"{prefix}.{leaf}" if prefix else leaf
                layout = self.layouts.get(name)
                if layout is None:
                    continue
                # A 1-wide axis leaves the leaf whole: no hook, no
                # collective.
                data_dim = layout.data_dim if self.dp > 1 else None
                model_dim = layout.model_dim if self.mp > 1 else None
                expert_dim = layout.expert_dim if self.ep > 1 else None
                if data_dim is None and model_dim is None and (
                        expert_dim is None):
                    continue
                with torch.no_grad():
                    param.data = self._local(param.data, layout)
                # Gathered whole at use: a MoE layer's model-sharded
                # kernels, and its expert-sharded ones unless the layer
                # is bound to the mesh (then it computes on its own
                # experts).
                gathers = []
                if moe and model_dim is not None:
                    gathers.append((model_dim, self.model_group))
                if expert_dim is not None and module.mesh is None:
                    gathers.append((expert_dim, self.expert_group))
                column = model_dim if not moe else None
                if data_dim is None and column is None and not gathers:
                    continue
                owners.setdefault(module, []).append((leaf, data_dim,
                                                      column, gathers))
        for module, entries in owners.items():
            column = any(col is not None for _, _, col, _ in entries)
            # The features of a Conv's NCHW output are dim 1; of a
            # Linear's or an Embedding's, the last.
            out_dim = 1 if isinstance(module, Conv) else -1
            slices = ([leaf for leaf, p in module.named_parameters(
                recurse=False) if p.dim() == 1] if column else [])
            module.register_forward_pre_hook(
                self._pre_hook(entries, column, slices))
            module.register_forward_hook(self._post_hook(column, out_dim),
                                         always_call=True)
        if self.dp > 1:
            reduce = _stats_reducer(self.data_group)
            for module in model.modules():
                if isinstance(module, BatchNorm):
                    module.stats_reduce = reduce
        if self.dp > 1 or self.cp > 1:
            for module in model.modules():
                if isinstance(module, MoEMlp) and module.mesh is None:
                    module.token_mesh = self.mesh

    def _pre_hook(self, entries, column, slices):
        def hook(module, args):
            saved = {}
            for leaf, data_dim, _, gathers in entries:
                cur = module._parameters[leaf]
                saved[leaf] = cur
                if data_dim is not None:
                    cur = ShardGather.apply(cur, data_dim, self.data_group)
                for dim, group in gathers:
                    cur = GatherAlong.apply(cur, dim, group)
                module._parameters[leaf] = cur
            if column:
                for leaf in slices:
                    cur = module._parameters[leaf]
                    if cur is None:
                        continue
                    saved[leaf] = cur
                    module._parameters[leaf] = SliceAlong.apply(
                        cur, 0, self.model_group)
                args = tuple(
                    CopyToGroup.apply(a, self.model_group)
                    if isinstance(a, torch.Tensor)
                    and a.is_floating_point() else a for a in args)
            module.__dict__.setdefault("_spmd_saved", []).append(saved)
            return args
        return hook

    def _post_hook(self, column, out_dim):
        def hook(module, args, output):
            saved = module.__dict__["_spmd_saved"].pop()
            for leaf, cur in saved.items():
                module._parameters[leaf] = cur
            if column and output is not None:
                return GatherAlong.apply(output, out_dim % output.dim(),
                                         self.model_group)
            return output
        return hook

    # -- the step -------------------------------------------------------

    def local_batch(self, x):
        """This data rank's slice of a global batch (leading dim)."""
        if x.shape[0] % self.dp:
            raise ValueError(
                f"global batch {x.shape[0]} does not divide over "
                f"data={self.dp} ranks")
        size = x.shape[0] // self.dp
        return x[self.data_index * size:(self.data_index + 1) * size]

    def local_sequence(self, x):
        """(this context rank's contiguous slice of a [B, S, ...] batch
        along the sequence, its global offset); the batch itself and 0
        on a context axis one rank wide."""
        if self.cp == 1:
            return x, 0
        if x.shape[1] % self.cp:
            raise ValueError(
                f"sequence length {x.shape[1]} does not divide over "
                f"context={self.cp} ranks")
        size = x.shape[1] // self.cp
        start = self.context_index * size
        return x[:, start:start + size], start

    @torch.no_grad()
    def _all_reduce_grads(self, model, group, scale, skip_data=False):
        """All-reduce the parameters' gradients over ``group``, one flat
        tensor a dtype, times ``scale``; ``skip_data`` leaves the
        data-sharded ones alone."""
        by_dtype = {}
        for name, param in model.named_parameters():
            if param.grad is None:
                continue
            layout = self.layouts.get(name)
            if (skip_data and layout is not None
                    and layout.data_dim is not None):
                continue
            by_dtype.setdefault(param.grad.dtype, []).append(param.grad)
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            if scale != 1:
                flat *= scale
            offset = 0
            for g in grads:
                n = g.numel()
                g.copy_(flat[offset:offset + n].view_as(g))
                offset += n

    @torch.no_grad()
    def reduce_grads(self, model):
        """Sum every gradient over the context axis (a context rank's
        loss is its share of the data rank's mean), then average the
        gradients of parameters whole over the data axis over it (a
        data-sharded gradient was averaged by its reduce-scatter); one
        flat all-reduce a dtype and axis. Nothing to do on axes one
        rank wide."""
        if self.cp > 1:
            self._all_reduce_grads(model, self.context_group, 1)
        if self.dp > 1:
            self._all_reduce_grads(model, self.data_group, 1.0 / self.dp,
                                   skip_data=True)

    @torch.no_grad()
    def mean_over_data(self, value):
        """The step's reported loss from a rank's share: summed over the
        context axis, averaged over the data axis (replicated over the
        model and expert axes)."""
        out = value.detach().float()
        if self.cp > 1:
            out = out.clone()
            dist.all_reduce(out, group=self.context_group)
        if self.dp == 1:
            return out
        out = out.clone()
        dist.all_reduce(out, group=self.data_group)
        return out / self.dp

    @torch.no_grad()
    def grad_norm(self, model):
        """The L2 norm of the whole gradient, as the JAX step's
        ``optax.clip_by_global_norm`` reads it (collective: every rank
        enters, after ``reduce_grads``). A sharded leaf's squares are
        summed over the axes it is sharded on; a replicated leaf's
        gradient is the same on every rank and counts once. Returns an
        f32 0-d tensor, equal on every rank; None on a mesh whose
        sharding axes are one rank wide, where the local gradients are
        the whole."""
        if self.dp == 1 and self.mp == 1 and self.ep == 1:
            return None
        # [replicated, data only, data and model, model only, expert]:
        # the data-sharded sums are parts[1:3], the model-sharded
        # parts[2:4], the expert-sharded parts[4].
        parts = torch.zeros(5, dtype=torch.float32,
                            device=next(model.parameters()).device)
        for name, param in model.named_parameters():
            if param.grad is None:
                continue
            layout = self.layouts.get(name)
            on_data = layout is not None and layout.data_dim is not None
            on_model = layout is not None and layout.model_dim is not None
            if layout is not None and layout.expert_dim is not None:
                idx = 4
            else:
                idx = (2 if on_model else 1) if on_data else (
                    3 if on_model else 0)
            parts[idx] += torch.linalg.vector_norm(param.grad.float()) ** 2
        if self.dp > 1:
            dist.all_reduce(parts[1:3], group=self.data_group)
        if self.mp > 1:
            dist.all_reduce(parts[2:4], group=self.model_group)
        if self.ep > 1:
            dist.all_reduce(parts[4:5], group=self.expert_group)
        return parts.sum().sqrt()

    def whole_numel(self, model):
        """The element count of ``model``'s whole parameters (a sharded
        leaf counts every rank's piece)."""
        n = 0
        for name, param in model.named_parameters():
            layout = self.layouts.get(name)
            k = param.numel()
            if layout is not None:
                for dim, size in ((layout.data_dim, self.dp),
                                  (layout.model_dim, self.mp),
                                  (layout.expert_dim, self.ep)):
                    if dim is not None:
                        k *= size
            n += k
        return n

    def sum_over_data(self, value, device):
        """A per-rank float summed over the data and context axes (the
        ranks that split the batch; collective, the sum travels on
        ``device``, the group's)."""
        if self.dp == 1 and self.cp == 1:
            return float(value)
        out = torch.tensor([float(value)], dtype=torch.float64,
                           device=device)
        for size, group in ((self.cp, self.context_group),
                            (self.dp, self.data_group)):
            if size > 1:
                dist.all_reduce(out, group=group)
        return float(out.item())

    @torch.no_grad()
    def gather_batch(self, x):
        """The ranks' slices of ``x`` concatenated: along the sequence
        over the context axis, then along the batch over the data axis
        (the eval step's logits)."""
        if self.cp > 1:
            x = _gather_dim(x, 1, self.context_group)
        if self.dp > 1:
            x = _gather_dim(x, 0, self.data_group)
        return x

    # -- checkpoints ------------------------------------------------------

    @contextlib.contextmanager
    def full_state(self, model, optimizer, ema=None):
        """Every sharded parameter, its optimizer state (the momentum
        buffer, Adam's moments) and EMA shadow made whole for the body
        (collective: every rank enters), then sliced back, keeping what
        the body wrote (a restore)."""
        sharded = [(name, param, self.layouts[name])
                   for name, param in model.named_parameters()
                   if name in self.layouts and self.layouts[name].sharded]

        def relayout(fn):
            for name, param, layout in sharded:
                st = optimizer.state.get(param, {})
                for key in _moments(st, param):
                    st[key] = fn(st[key], layout)
                param.data = fn(param.data, layout)
                if ema is not None and name in ema:
                    ema[name] = fn(ema[name], layout)

        with torch.no_grad():
            relayout(self._whole)
        try:
            yield
        finally:
            with torch.no_grad():
                relayout(self._local)


def _moments(state, param):
    """The keys of a parameter's optimizer state laid out as the
    parameter (SGD's momentum buffer, Adam's two moments; not Adam's
    0-d step count)."""
    return [key for key, value in state.items()
            if isinstance(value, torch.Tensor) and value.dim() > 0
            and value.shape == param.shape]

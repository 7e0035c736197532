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

"""Explicit collectives over one mesh axis (counterpart of
container_engine_accelerators_tpu/parallel/collectives.py).

The JAX functions take a global array sharded on its leading dim and
run under ``shard_map``; here every rank passes its own shard (or, for
``reduce_scatter``, its replicated copy) and gets its own result back,
over the process group of its peers along ``axis_name``:

- ``all_reduce_mean``: each shard becomes the mean of the axis' shards;
- ``all_gather``: the shards concatenated along dim 0, on every rank;
- ``reduce_scatter``: the sum of the replicated copies, this rank's
  1/N of it along dim 0;
- ``ring_all_reduce``: the sum, as an explicit ring of N - 1
  reduce-scatter hops and N - 1 all-gather hops, each a send to the
  next rank and a receive from the previous one, 1/N of the shard at a
  time (padded with zeros to a multiple of N).

The second half holds the autograd functions the Trainer's sharded
step is made of: a collective in the forward and its transpose in the
backward.
"""

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, axis_group


def _group_size(group):
    return dist.get_world_size(group)


def all_reduce_mean(mesh, x, axis_name=DATA_AXIS):
    """Mean of ``x`` over the axis' ranks (a new tensor)."""
    group = axis_group(mesh, axis_name)
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out / _group_size(group)


def all_gather(mesh, x, axis_name=DATA_AXIS):
    """The axis' shards concatenated along dim 0, on every rank."""
    return _gather_dim(x, 0, axis_group(mesh, axis_name))


def reduce_scatter(mesh, x, axis_name=DATA_AXIS):
    """Sum of the axis' copies of ``x``; this rank keeps its 1/N along
    dim 0 (the leading dim must divide by N)."""
    return _reduce_scatter_dim(x, 0, axis_group(mesh, axis_name))


def ring_all_reduce(mesh, x, axis_name=DATA_AXIS):
    """Sum of ``x`` over the axis, by a ring of point-to-point
    transfers (module docstring). Equal to an all-reduce's sum up to
    the order of the additions; any shard size works."""
    group = axis_group(mesh, axis_name)
    n = _group_size(group)
    if n == 1:
        return x.clone()
    idx = dist.get_group_rank(group, dist.get_rank())
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    blocks = torch.cat([flat, flat.new_zeros(pad)]).reshape(n, -1).clone()
    recv = torch.empty_like(blocks[0])

    def hop(send_ix):
        ops = [dist.P2POp(dist.isend, blocks[send_ix].contiguous(), nxt,
                          group),
               dist.P2POp(dist.irecv, recv, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    # Reduce-scatter: after n - 1 hops block (idx + 1) % n holds the
    # whole sum of that block.
    for k in range(n - 1):
        hop((idx - k) % n)
        blocks[(idx - k - 1) % n] += recv
    # All-gather: pass each finished block on around the ring.
    for k in range(n - 1):
        hop((idx + 1 - k) % n)
        blocks[(idx - k) % n] = recv
    out = blocks.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


# ---------------------------------------------------------------------
# Tensor helpers and the autograd functions of the sharded step
# ---------------------------------------------------------------------


def _gather_dim(x, dim, group):
    """Concatenate every rank's ``x`` along ``dim``."""
    n = _group_size(group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _reduce_scatter_dim(x, dim, group):
    """Sum over the group, keeping this rank's 1/N along ``dim``."""
    n = _group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"into {n} shards")
    moved = x.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def local_slice(x, dim, group):
    """This rank's 1/N of ``x`` along ``dim`` (a view)."""
    n = _group_size(group)
    idx = dist.get_group_rank(group, dist.get_rank())
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)


class AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward and in the backward (the sum's
    transpose): the batch-statistics reduction of a BatchNorm."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class CopyToGroup(torch.autograd.Function):
    """Identity on a replicated input; the backward sums the partial
    input gradients of the group's column shards."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class GatherAlong(torch.autograd.Function):
    """Concatenate the group's column shards along ``dim``; the
    backward takes this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return (local_slice(grad, ctx.dim, ctx.group).contiguous(),
                None, None)


class SliceAlong(torch.autograd.Function):
    """This rank's slice of a replicated tensor along ``dim``; the
    backward gathers the slices' gradients into the whole one."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return local_slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.dim, ctx.group), None, None


class ShardGather(torch.autograd.Function):
    """FSDP's use of a parameter: gather the data axis' shards along
    ``dim``; the backward reduce-scatters the gradient back to the
    shard and divides it by the axis size (the mean over the data
    ranks' batches)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        n = _group_size(ctx.group)
        return (_reduce_scatter_dim(grad, ctx.dim, ctx.group) / n,
                None, None)


class GatherSum(torch.autograd.Function):
    """Concatenate the group's pieces along ``dim`` into a value every
    rank's own loss term reads (the gate logits a global routing reads
    on each data rank); the backward sums the ranks' gradients of the
    whole and keeps this rank's slice (a reduce-scatter): the
    transpose of an all-gather over ranks whose losses are separate
    terms of one mean."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return (_reduce_scatter_dim(grad.contiguous(), ctx.dim, ctx.group),
                None, None)


class MeanOfReplicated(torch.autograd.Function):
    """The mean of the group's values, read by one loss every rank of
    the group computes alike (a replicated loss); the backward hands
    each rank its 1/N of the gradient without a collective."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n = _group_size(group)
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def _all_to_all(x, split_dim, concat_dim, group):
    """jax.lax.all_to_all(tiled=True) on one rank: ``x`` cut into N
    equal chunks along ``split_dim``, chunk j sent to member j, the
    chunks received concatenated along ``concat_dim`` in member
    order."""
    n = _group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                         f"split into {n} chunks")
    send = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    recv = [torch.empty_like(send[0]) for _ in range(n)]
    dist.all_to_all(recv, send, group=group)
    return torch.cat(recv, dim=concat_dim)


class AllToAll(torch.autograd.Function):
    """``_all_to_all`` with its transpose, the all-to-all that splits
    the concatenated dim and concatenates the split one (an all-to-all
    is its own transpose with the dims swapped)."""

    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(grad, concat_dim, split_dim, ctx.group),
                None, None, None)


def ring_peers(group):
    """(this rank's index in ``group``, the next member's global rank,
    the previous member's global rank)."""
    n = _group_size(group)
    idx = dist.get_group_rank(group, dist.get_rank())
    return (idx, dist.get_global_rank(group, (idx + 1) % n),
            dist.get_global_rank(group, (idx - 1) % n))


def ring_shift(tensors, group, reverse=False):
    """One ring hop of ``tensors``: each is sent to the next member and
    a buffer of its shape receives the previous member's (the other way
    round with ``reverse``). Returns the received buffers."""
    _, nxt, prv = ring_peers(group)
    if reverse:
        nxt, prv = prv, nxt
    ops, recv = [], []
    for t in tensors:
        buf = t.new_empty(t.shape)
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        recv.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class RingShift(torch.autograd.Function):
    """One ring hop of (K, V): each rank's pair goes to the next member
    of the group, the previous member's arrives; the backward sends the
    gradients the other way round the ring."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return tuple(ring_shift((k, v), group))

    @staticmethod
    def backward(ctx, g_k, g_v):
        g_k = torch.zeros_like(g_k) if g_k is None else g_k
        g_v = torch.zeros_like(g_v) if g_v is None else g_v
        return tuple(ring_shift((g_k, g_v), ctx.group, reverse=True)) + (
            None,)

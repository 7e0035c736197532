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

"""Pipeline parallelism: GPipe and circular (interleaved) schedules
(counterpart of container_engine_accelerators_tpu/parallel/pipeline.py).

Stages live on consecutive ranks of the "pipe" mesh axis and
activations advance one stage a tick. The JAX functions take the
stacked stage parameters and the global batch and run one ``lax.scan``
under ``shard_map``; here every rank passes its own part and runs the
ticks eagerly, over the process group of its pipe-axis peers:

- ``params``: this rank's stage rows, a stacked pytree (a dict of
  tensors with a leading stage axis) or a sequence of per-stage items
  (an ``nn.ModuleList`` of blocks); ``stage_fn(item, x)`` runs one.
  ``circular_pipeline_apply(pre_permuted=False)`` instead takes the
  whole stack in natural stage order, the same on every pipe rank, and
  picks this rank's round-robin stages from it (their gradients land
  on those rows; the other rows' are zero on this rank).
- ``x``: this data rank's batch [B_local, ...], the same on every pipe
  rank; the output is this data rank's, on every pipe rank
  (``batch_axis`` is accepted for the JAX signature).

What ``shard_map``'s transposes give JAX is written out:

- a hop is ``_Hop``: a send to the next pipe rank and a receive from
  the previous one, whose backward sends the gradient the other way.
  The GPipe hop does not wrap (stage 0 receives zeros, as JAX's pairs
  ``[(i, i+1)]`` leave it), the circular one is a full ring, and on a
  one-rank pipe axis the ring hop is the identity (no send to itself).
  Every rank runs every hop, and every hop's output is read through
  ``torch.where``, as the JAX body selects: a received activation a
  rank does not use still gets its (zero) gradient, so every rank runs
  every hop's backward (the input joins the graph even when the caller
  takes no gradient of it: a bubble tick hops its input on), in the
  same order (the chain of ticks orders
  them), and the point-to-point transfers of the backward pair up.
  The last tick's hop, whose output nothing reads, is left out on
  every rank.
- the trailing ``psum`` that broadcasts the last stage's outputs is
  ``_FromLast``: a sum over the pipe axis whose backward hands the
  (replicated) cotangent back unchanged, so the last stage gets it
  once (a summing backward would multiply it by P). The other ranks
  contribute zeros tied to their last tick's activation (``_Anchor``,
  a zero gradient): their backward starts there and walks back through
  every tick, as JAX's masked retire buffer carries zeros back;
- ``x`` enters through ``CopyToGroup`` over the pipe axis: only stage
  0 ingests it, and the backward sums its gradient over the axis, so
  every pipe rank holds the whole input gradient.

Stage gradients stay on their rank; a caller averages them over
"data" only (``pipeline_lm`` does).

Bubble ticks (a head tick before a rank's first microbatch, the tail
of a partial injection group) skip the stage: the rank passes its
input on unchanged, so the hop still runs. JAX computes the stage on
garbage there and masks the retire; no bubble tick's activation is
ever retired or read by a real tick (a real tick reads the previous
rank's output of the same schedule slot, or ingests), so outputs and
gradients are those of the JAX schedule and a rank launches its stage
``M·v`` times a call instead of once a tick.
"""

import torch
import torch.distributed as dist

from .collectives import CopyToGroup, ring_peers
from .mesh import DATA_AXIS, axis_group, axis_index, axis_size, grid_mesh

PIPELINE_AXIS = "pipe"


def build_pipeline_mesh(stages, data=None, devices=None):
    """A ("data", "pipe") mesh; pipe-axis neighbours are adjacent
    ranks (adjacent cards of one host under the usual launch order)."""
    return grid_mesh(devices, data, stages, PIPELINE_AXIS)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def stack_stage_params(stage_params):
    """Stack a list of per-stage param pytrees (dicts of tensors) along
    a new leading stage axis, the layout the schedules take."""
    return _tree_map(lambda *leaves: torch.stack(leaves), *stage_params)


def _pipe(mesh, axis_name):
    """(pipe size, this rank's pipe index, the axis' group or None)."""
    if mesh is None:
        return 1, 0, None
    size = axis_size(mesh, axis_name)
    group = axis_group(mesh, axis_name) if size > 1 else None
    return size, axis_index(mesh, axis_name), group


def stage_sharding(mesh, n_stages, axis_name=PIPELINE_AXIS):
    """{pipe index: range of stage rows it holds}: pipe rank d holds
    rows [d·v, (d+1)·v) of an ``n_stages`` stack, v = n_stages / P (the
    JAX layout's leading axis sharded over the pipe axis)."""
    p = 1 if mesh is None else axis_size(mesh, axis_name)
    if n_stages % p:
        raise ValueError(f"{n_stages} stacked stages do not fold onto "
                         f"{axis_name} axis size {p}")
    v = n_stages // p
    return {d: range(d * v, (d + 1) * v) for d in range(p)}


def _stages(params):
    """The per-stage items of ``params``: a sequence's items, or a
    stacked pytree's rows (views, so gradients reach the stack)."""
    if isinstance(params, dict):
        n = _first_leaf(params).shape[0]
        return [_tree_map(lambda w, i=i: w[i], params) for i in range(n)]
    return list(params)


def _shift(x, group, wrap, reverse=False):
    """One hop of ``x`` along the pipe axis: sent to the next member and
    the previous member's received (the other way round with
    ``reverse``). Without ``wrap`` the last member sends nothing and
    the first receives zeros."""
    n = dist.get_world_size(group)
    idx, nxt, prv = ring_peers(group)
    if reverse:
        nxt, prv = prv, nxt
        sends, recvs = wrap or idx > 0, wrap or idx < n - 1
    else:
        sends, recvs = wrap or idx < n - 1, wrap or idx > 0
    buf = torch.empty_like(x) if recvs else torch.zeros_like(x)
    ops = []
    if sends:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), nxt, group))
    if recvs:
        ops.append(dist.P2POp(dist.irecv, buf, prv, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return buf


class _Hop(torch.autograd.Function):
    """A tick's advance: this rank's activation goes to the next pipe
    rank, the previous one's arrives; the backward sends the gradient
    back the other way (module docstring)."""

    @staticmethod
    def forward(ctx, x, group, wrap):
        ctx.group, ctx.wrap = group, wrap
        return _shift(x, group, wrap)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, ctx.wrap, reverse=True), None, None


def _hop(x, group, wrap):
    if group is None:
        # A one-rank pipe axis: the ring returns each activation to its
        # sender; the GPipe pairs are empty, so stage 0 receives zeros.
        return x if wrap else torch.zeros_like(x)
    return _Hop.apply(x, group, wrap)


class _Anchor(torch.autograd.Function):
    """``x`` unchanged, tied to ``anchor`` in the graph: the backward
    hands ``anchor`` a zero gradient, so a rank whose output holds no
    retired activation still runs its ticks' backward (and with it
    every hop's) from its last tick."""

    @staticmethod
    def forward(ctx, x, anchor):
        ctx.anchor = (anchor.shape, anchor.dtype, anchor.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.anchor
        return grad, torch.zeros(shape, dtype=dtype, device=device)


class _FromLast(torch.autograd.Function):
    """The trailing psum: the sum over the pipe axis of the last
    stage's outputs and the others' zeros; the backward hands each rank
    the cotangent unchanged (only the last stage's outputs carry a
    graph)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _schedule(stage_fn, stages, x, m, p, d, group, wrap, ticks):
    """The tick loop shared by both schedules (``circular_pipeline_
    apply``'s docstring has the indexing; GPipe is v = 1 without the
    wrap). ``stages``: this rank's v stage items in lap order."""
    v = len(stages)
    b_local = x.shape[0]
    if b_local % m != 0:
        raise ValueError(f"local batch {b_local} not divisible into "
                         f"{m} microbatches")
    if group is not None:
        x = CopyToGroup.apply(x, group)
        if torch.is_grad_enabled() and not x.requires_grad:
            # A bubble tick passes its input on: an input outside the
            # graph would leave that hop without a backward on this
            # rank while its peer waits for the hop's gradient.
            x = x.detach().requires_grad_()
    x_mb = x.reshape((m, b_local // m) + tuple(x.shape[1:]))
    yes = torch.ones((), dtype=torch.bool, device=x.device)
    no = torch.zeros((), dtype=torch.bool, device=x.device)
    is_first, is_last = d == 0, d == p - 1
    state = torch.zeros_like(x_mb[0])
    outputs = [None] * m
    for t in range(ticks):
        u = t - d
        j, q = u % p, u // p
        r = q % v
        mb = (q // v) * p + j
        valid = u >= 0 and mb < m
        mb_c = min(max(mb, 0), m - 1)
        ingest = is_first and r == 0
        inp = torch.where(yes if ingest else no, x_mb[mb_c], state)
        out = stage_fn(stages[r], inp) if valid else inp
        if valid and is_last and r == v - 1:
            outputs[mb_c] = out
        if t < ticks - 1:
            state = _hop(out, group, wrap)
    if is_last:
        result = torch.stack(outputs)
    else:
        result = _Anchor.apply(torch.zeros_like(x_mb), out)
    if group is not None:
        result = _FromLast.apply(result, group)
    return result.reshape(x.shape)


def pipeline_apply(mesh, stage_fn, params, x, *, num_microbatches,
                   axis_name=PIPELINE_AXIS, batch_axis=DATA_AXIS):
    """Run ``stage_fn`` P times over the pipe axis, microbatched (GPipe).

    stage_fn(stage_params, x_mb) -> y_mb, the same activation shape in
    and out. ``params``: this rank's stage rows (one), as a stacked
    pytree or a one-item sequence (module docstring); x: this data
    rank's [B_local, ...] batch, B_local divisible into
    ``num_microbatches``. ``mesh`` None runs a one-rank pipe.

    Tick t: stage 0 ingests microbatch t (while t < M), every stage
    transforms its resident activation, the result hops to the next
    stage, and stage P-1 retires microbatch t-(P-1): M + P - 1 ticks.
    The output is this data rank's, on every pipe rank.
    """
    p, d, group = _pipe(mesh, axis_name)
    stages = _stages(params)
    n_stages = len(stages) * p
    if n_stages != p:
        # More rows than one a rank would run only the first of them.
        raise ValueError(f"{n_stages} stacked stages != {axis_name} axis "
                         f"size {p}")
    m = num_microbatches
    return _schedule(stage_fn, stages, x, m, p, d, group, False,
                     m + p - 1)


def circular_stage_order(n_stages, pipe):
    """Placement-order permutation for ``circular_pipeline_apply``: row
    d*v + r of the placement-ordered stack holds natural stage r*pipe +
    d, so pipe rank d's rows [d*v, (d+1)*v) are exactly its round-robin
    stages. Apply once at parameter-build time and pass
    ``pre_permuted=True``; gradients and optimizer state then live in
    placement order too."""
    import numpy as np

    if n_stages % pipe != 0:
        raise ValueError(
            f"{n_stages} stages do not fold onto pipe={pipe}")
    v = n_stages // pipe
    return np.asarray(
        [r * pipe + d for d in range(pipe) for r in range(v)])


def circular_pipeline_apply(mesh, stage_fn, params, x, *,
                            num_microbatches, axis_name=PIPELINE_AXIS,
                            batch_axis=DATA_AXIS, pre_permuted=False):
    """Circular (interleaved) pipeline: S = v * P stages on P ranks.

    Pipe rank d holds the v non-adjacent stages {r*P + d : r < v}
    (round-robin placement), activations advance one rank a tick over
    a full ring (the P-1 -> 0 wrap returns each microbatch for its next
    lap), and every microbatch makes v laps: a bubble of P - 1
    fine-stage ticks, v times smaller than folding the S stages into P
    GPipe stages. v == 1 is the GPipe schedule with a wrap nothing
    reads.

    ``params``: with ``pre_permuted`` this rank's v rows in placement
    order (rows [d*v, (d+1)*v) of the ``circular_stage_order`` stack),
    otherwise the whole [S, ...] stack in natural order, the same on
    every pipe rank, of which this rank runs its round-robin rows.
    Otherwise as ``pipeline_apply``.

    Schedule (rank d, tick t, u = t - d): j = u mod P, q = u // P, lap
    r = q mod v, group g = q // v, microbatch mb = g*P + j. Lap 0 on
    rank 0 ingests mb; every other (d, r) reads the ring's input; rank
    P-1 on lap v-1 retires mb. Groups of P microbatches chain without
    a gap, so a call takes M*v + P - 1 ticks when P divides M; a
    partial tail group idles its masked slots, for P*v*ceil(M/P) +
    (M-1) mod P ticks.
    """
    p, d, group = _pipe(mesh, axis_name)
    stages = _stages(params)
    if pre_permuted:
        n_stages = len(stages) * p
    else:
        n_stages = len(stages)
        if n_stages % p != 0:
            raise ValueError(
                f"{n_stages} stacked stages do not fold onto {axis_name} "
                f"axis size {p} (need a multiple)")
        # Round-robin placement: rank d runs natural stages r*P + d.
        stages = [stages[r * p + d] for r in range(n_stages // p)]
    v = n_stages // p
    m = num_microbatches
    ticks = p * v * ((m - 1) // p + 1) + (m - 1) % p
    return _schedule(stage_fn, stages, x, m, p, d, group, True, ticks)

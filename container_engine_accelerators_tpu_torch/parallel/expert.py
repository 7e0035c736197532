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

"""Mixture-of-Experts routing, on one device and over a mesh
(counterpart of container_engine_accelerators_tpu/parallel/expert.py).

The routing is GShard's top-k capacity scheme: a group of T tokens
(every token of one forward call) reserves ``expert_capacity`` slots
per expert; round r of ``top_k`` sends each token to its r-th most
probable expert, at the next free slot of that expert's queue (slots
fill in token order, after the earlier rounds' kept tokens); a token
past the capacity is dropped for that round. Gate weights are the
softmax probabilities of the kept and dropped choices alike,
renormalised over the token's choices when top_k > 1, and ``aux`` is
the Switch load-balancing loss, E * sum_e(frac_e * mean prob_e), 1 at
uniform routing (frac counts dropped choices too).

Two forms compute the same layer:

- ``dense_moe`` (the model's path, on the CPU and on the card) carries
  each token's choices as indices, [T, top_k] each: expert, slot, kept,
  weight. It copies the tokens into [E, C, d] slots, runs the two
  batched expert products and adds the weighted outputs back per token.
- ``dense_moe_reference`` is the JAX function written out: one-hot
  ``dispatch``/``combine`` [T, E, C] tensors and three einsums. The
  tests hold the index form to it; nothing on the card's main path
  calls it.

Both give the same slot assignment exactly, and outputs that agree to
the order of the f32 sums. The gate product and the routing are f32
(the gate product must stay full f32, no TF32, or near-tie routes
flip); the expert weights arrive in the compute dtype, the slots are
tokens in the compute dtype, and the products accumulate in f32 (the
JAX einsums' ``preferred_element_type``): the first product's f32
result goes through the tanh GELU and back to the compute dtype, the
second's f32 result is combined in f32 and cast once. No Pallas kernel
lies on this path: the JAX package computes all three steps in XLA.

On a mesh (each rank passes its own shard, as everywhere in the
port's distributed code):

- ``expert_parallel_moe`` is the JAX function over an "expert" axis:
  each rank routes its own group, dispatches it into [E, C, d] slots,
  an all-to-all gives each expert owner its E/P experts' slots from
  every group member, the batched FFN runs on them, the reverse
  all-to-all brings them back and the combine adds them per token.
  Under a token spec without the expert axis (the residual stream's
  layout) the expert-axis peers hold the same tokens: each routes its
  contiguous T/P subgroup and an all-gather re-assembles the block.
  ``residual_moe`` feeds it a rank's block of the residual stream in
  the JAX layer's groups, re-laid out over "context" where the
  sequence is split.
- ``global_batch_moe`` is what GSPMD makes of ``dense_moe`` when the
  tokens are split over "data" (and "context"): the gate logits are
  gathered in the global token order, every rank routes the global
  batch alike, and runs only its own tokens through their experts.

The gradients follow one rule: over "data" and "context" the ranks'
losses are separate terms of one mean (the Trainer sums or averages
their gradients), over "expert" (and "model") the loss is one value
every peer computes alike.
"""

import math

import torch
import torch.nn.functional as F

from . import collectives
from .context import CONTEXT_AXIS
from .mesh import DATA_AXIS, axis_group, axis_index, grid_mesh, mesh_shape

EXPERT_AXIS = "expert"


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def build_expert_mesh(expert, data=None, devices=None):
    """A ("data", "expert") mesh over the world's ranks (or ``devices``,
    a rank list); expert-axis peers are adjacent ranks."""
    return grid_mesh(devices, data, expert, EXPERT_AXIS)


def expert_capacity(num_tokens, num_experts, capacity_factor, top_k):
    """Slots each expert reserves for a group of ``num_tokens``."""
    return max(1, math.ceil(
        top_k * num_tokens * capacity_factor / num_experts))


def _route(gate_logits, capacity, top_k):
    """The routing rounds shared by both forms: (probs [T, E] f32, per
    round (idx [T], pos [T], w [T]), assign_frac [E], chosen_mass [T]).
    Round r picks the first maximum of the probabilities with the
    earlier rounds' experts zeroed (``torch.argmax`` takes the first, as
    ``jnp.argmax``); ``pos`` is the token's place in that expert's queue:
    its rank among this round's tokens of the expert, after the slots
    the earlier rounds kept."""
    probs = torch.softmax(gate_logits.float(), dim=-1)
    t, e = probs.shape
    masked = probs.detach()
    counts = torch.zeros((e,), dtype=torch.long, device=probs.device)
    assign_frac = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    chosen_mass = torch.zeros((t,), dtype=torch.float32, device=probs.device)
    rounds = []
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=-1)
        onehot = F.one_hot(idx, e)                              # [T, E]
        assign_frac = assign_frac + onehot.float().mean(dim=0) / top_k
        pos = _rank_in_expert(onehot, idx) + counts[idx]
        keep = pos < capacity
        w = probs.gather(1, idx[:, None])[:, 0]
        chosen_mass = chosen_mass + w
        counts = counts + (onehot * keep[:, None]).sum(dim=0)
        masked = masked * (1.0 - onehot.float())
        rounds.append((idx, pos, w))
    return probs, rounds, assign_frac, chosen_mass


def _rank_in_expert(onehot, idx):
    """Each token's rank among the earlier tokens of its expert: the
    exclusive cumsum of ``onehot`` [T, E] down the tokens, read at
    ``idx`` [T]. Scanned along the last axis of a contiguous [E, T]
    copy: a scan down the T rows of [T, E] runs only E lanes at a time
    on the card."""
    ranks = torch.cumsum(onehot.t().contiguous(), dim=1).t() - onehot
    return ranks.gather(1, idx[:, None])[:, 0]


def _aux(probs, assign_frac):
    return probs.shape[1] * torch.sum(assign_frac * probs.mean(dim=0))


def top_k_routing(gate_logits, capacity, top_k=2, normalize=True):
    """The JAX function's dense form: gate_logits [T, E] -> (dispatch
    [T, E, C], combine [T, E, C], aux). ``dispatch`` is the 0/1 slot
    assignment, ``combine`` the gate weights on the same slots (divided
    by the token's chosen mass when ``normalize`` and top_k > 1). The
    tests' reference; [T, E, C] is quadratic in T."""
    probs, rounds, assign_frac, chosen_mass = _route(gate_logits, capacity,
                                                     top_k)
    t, e = probs.shape
    slots = torch.arange(capacity, device=probs.device)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.float32,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for idx, pos, w in rounds:
        onehot = F.one_hot(idx, e).float()
        # jax.nn.one_hot: a position past the capacity is an all-zero
        # row (F.one_hot would raise).
        slot = (pos[:, None] == slots).float()
        keep = (pos < capacity).float()
        contrib = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]
        dispatch = dispatch + contrib
        combine = combine + contrib * w[:, None, None]
    if normalize and top_k > 1:
        combine = combine / torch.clamp(chosen_mass, min=1e-9)[:, None, None]
    return dispatch, combine, _aux(probs, assign_frac)


def top_k_routing_indices(gate_logits, capacity, top_k=2, normalize=True):
    """The same routing as indices: gate_logits [T, E] -> (expert [T,
    k] int64, slot [T, k] int64, keep [T, k] bool, weight [T, k] f32,
    aux). Choice j of token t is ``dispatch[t, expert[t, j], slot[t,
    j]]`` when ``keep[t, j]``; ``weight`` is its ``combine`` value
    (meaningful where kept; a dropped choice still counts in the
    normalising mass, as in the dense form)."""
    probs, rounds, assign_frac, chosen_mass = _route(gate_logits, capacity,
                                                     top_k)
    expert = torch.stack([idx for idx, _, _ in rounds], dim=1)
    slot = torch.stack([pos for _, pos, _ in rounds], dim=1)
    weight = torch.stack([w for _, _, w in rounds], dim=1)
    if normalize and top_k > 1:
        weight = weight / torch.clamp(chosen_mass, min=1e-9)[:, None]
    return expert, slot, slot < capacity, weight, _aux(probs, assign_frac)


def _expert_ffn(slots, w_in, w_out, activation):
    """Batched per-expert MLP on slots [E, C, d]: both products take
    compute-dtype operands and accumulate in f32 (f32 operands here;
    the operands' values are the compute dtype's), the first result
    passes the activation in f32 and returns to the compute dtype.
    Returns [E, C, d] f32."""
    h = torch.bmm(slots.float(), w_in.float())
    h = activation(h).to(slots.dtype)
    return torch.bmm(h.float(), w_out.float())


def _dispatch_ffn_combine(tokens, expert, slot, keep, weight, e, cap,
                          w_in, w_out, activation, exchange=None):
    """The layer after the routing, on the index form: tokens [T, d]
    copied into [E, C, d] slots (a dropped choice points at one extra
    row past the E * C slots, which the products never read), the
    batched expert FFN, and the weighted outputs added back per token
    in f32, cast once. ``exchange`` (slots -> slots, outputs ->
    outputs) moves the slots to their experts' owners and back (the
    expert-parallel all-to-all pair); None runs every expert here."""
    t, d = tokens.shape
    # Indexed, not one-hot: at the LM training shape (T 16384, E 8,
    # capacity 5120) one f32 [T, E, C] tensor is 2.68 GB, and autograd
    # would keep several a routed layer.
    dump = e * cap
    dest = torch.where(keep, expert * cap + slot,
                       torch.full_like(slot, dump))             # [T, k]
    k = dest.shape[1]
    buf = tokens.new_zeros((dump + 1, d)).index_copy(
        0, dest.reshape(-1), tokens[:, None].expand(t, k, d).reshape(-1, d))
    slots = buf[:dump].view(e, cap, d)
    if exchange is None:
        out = _expert_ffn(slots, w_in, w_out, activation)
    else:
        send, back = exchange
        out = back(_expert_ffn(send(slots), w_in, w_out, activation))
    out = torch.cat([out.reshape(dump, d), out.new_zeros((1, d))])
    # index_select, whose backward adds the kept rows' gradients back
    # with index_add_ (an advanced-indexing read sorts them instead).
    picked = out.index_select(0, dest.reshape(-1)).view(t, k, d)
    combined = picked[:, 0] * weight[:, :1]
    for j in range(1, k):
        combined = combined + picked[:, j] * weight[:, j:j + 1]
    return combined.to(tokens.dtype)


def dense_moe(tokens, gate_w, w_in, w_out, *, capacity_factor=1.25,
              top_k=2, activation=gelu):
    """Single-group MoE, the model's path: tokens [T, d], gate_w [d, E]
    (f32), w_in [E, d, f], w_out [E, f, d] (the compute dtype). Returns
    (out [T, d] in the tokens' dtype, aux scalar f32)."""
    t = tokens.shape[0]
    e = w_in.shape[0]
    cap = expert_capacity(t, e, capacity_factor, top_k)
    logits = tokens.float() @ gate_w.float()
    expert, slot, keep, weight, aux = top_k_routing_indices(
        logits, cap, top_k=top_k)
    return _dispatch_ffn_combine(tokens, expert, slot, keep, weight, e,
                                 cap, w_in, w_out, activation), aux


def dense_moe_reference(tokens, gate_w, w_in, w_out, *,
                        capacity_factor=1.25, top_k=2, activation=gelu):
    """``dense_moe`` as the JAX function computes it: the one-hot
    ``dispatch``/``combine`` tensors of ``top_k_routing`` and three
    einsums. The tests' reference for the index form; nothing on the
    card's main path calls it. Same signature and result."""
    e = w_in.shape[0]
    cap = expert_capacity(tokens.shape[0], e, capacity_factor, top_k)
    logits = tokens.float() @ gate_w.float()
    dispatch, combine, aux = top_k_routing(logits, cap, top_k=top_k)
    slots = torch.einsum("td,tec->ecd", tokens, dispatch.to(tokens.dtype))
    out = _expert_ffn(slots, w_in, w_out, activation)
    out = torch.einsum("ecd,tec->td", out, combine)
    return out.to(tokens.dtype), aux


def _axis_mean(mesh, value, partial_axes):
    """``value`` averaged over every mesh axis wider than one rank: an
    axis of ``partial_axes`` by an all-reduce whose backward sums (the
    ranks' losses are separate terms there), any other by the mean of
    a replicated loss (``collectives.MeanOfReplicated``)."""
    for axis, size in mesh_shape(mesh).items():
        if size == 1:
            continue
        group = axis_group(mesh, axis)
        if axis in partial_axes:
            value = collectives.AllReduceSum.apply(value, group) / size
        else:
            value = collectives.MeanOfReplicated.apply(value, group)
    return value


def expert_parallel_moe(mesh, tokens, gate_w, w_in, w_out, *,
                        capacity_factor=1.25, top_k=2,
                        axis_name=EXPERT_AXIS, activation=gelu,
                        token_spec=None):
    """MoE layer with the experts sharded over ``axis_name``.

    ``tokens`` [T, d] is this rank's token block; ``gate_w`` [d, E] is
    whole; ``w_in`` [E/P, d, f] and ``w_out`` [E/P, f, d] are this
    rank's experts (member g owns experts [g E/P, (g + 1) E/P)), or the
    whole [E, ...] stacks, of which each rank then takes its slice.
    ``token_spec`` says how the tokens are laid out, as the JAX
    argument does:

    - None: sharded over every mesh axis jointly, so each rank routes
      a group of its own;
    - a tuple of axis names without ``axis_name`` (the residual
      stream's (data, context) layout): the expert-axis peers hold the
      same block, each routes its contiguous T/P subgroup (the groups
      the fully sharded layout forms, in the same order) and the
      outputs are re-assembled by an all-gather (its backward takes
      the rank's slice; the subgroup's slice gathers the gradients).

    Per shard: top-k routing with ``expert_capacity`` slots an expert,
    the [E, C, d] dispatch, an all-to-all (expert dim split, slot dim
    concatenated: [E/P, P C, d]), the FFN on the rank's experts, the
    reverse all-to-all and the combine. The expert count must divide
    by the axis size. Returns (out [T, d], aux), aux the mean over the
    mesh."""
    p_size = mesh_shape(mesh)[axis_name]
    local = p_size > 1 and w_in.shape[0] * p_size == gate_w.shape[1]
    e = gate_w.shape[1] if local else w_in.shape[0]
    if e % p_size != 0:
        raise ValueError(
            f"{e} experts not divisible by {axis_name} axis size "
            f"{p_size}")
    spec_axes = (tuple(mesh.mesh_dim_names) if token_spec is None
                 else tuple(token_spec))
    subdivide = axis_name not in spec_axes
    if subdivide and tokens.shape[0] % p_size != 0:
        raise ValueError(
            f"token count {tokens.shape[0]} not divisible by {p_size}x "
            f"the token_spec shards")
    group = axis_group(mesh, axis_name) if p_size > 1 else None
    exchange = None
    toks, gate = tokens, gate_w
    if group is not None:
        if not local:
            w_in = collectives.SliceAlong.apply(w_in, 0, group)
            w_out = collectives.SliceAlong.apply(w_out, 0, group)
        if subdivide:
            toks = collectives.SliceAlong.apply(tokens, 0, group)
            # The peers' loss is one replicated value: the gate's
            # gradient is the sum of their subgroups'.
            gate = collectives.CopyToGroup.apply(gate_w, group)
        exchange = (
            lambda x: collectives.AllToAll.apply(x, 0, 1, group),
            lambda x: collectives.AllToAll.apply(x, 1, 0, group))
    cap = expert_capacity(toks.shape[0], e, capacity_factor, top_k)
    logits = toks.float() @ gate.float()
    expert, slot, keep, weight, aux = top_k_routing_indices(
        logits, cap, top_k=top_k)
    out = _dispatch_ffn_combine(toks, expert, slot, keep, weight, e, cap,
                                w_in, w_out, activation, exchange)
    if group is not None and subdivide:
        out = collectives.GatherAlong.apply(out, 0, group)
    partial = set(spec_axes) if token_spec is not None else set(
        mesh.mesh_dim_names)
    return out, _axis_mean(mesh, aux, partial)


def residual_token_spec(mesh, num_tokens):
    """The token layout of the flat [T, d] batch as the residual stream
    shards it (the JAX model's ``_residual_token_spec``): the "data"
    and "context" axes wider than one rank over which ``num_tokens``,
    the GLOBAL token count B·S (the JAX function reads the global
    array's), still tiles together with the expert axis's subdivision;
    the expert axis unused."""
    sizes = mesh_shape(mesh)
    group, tile = [], sizes.get(EXPERT_AXIS, 1)
    for a in (DATA_AXIS, CONTEXT_AXIS):
        size = sizes.get(a, 1)
        if size > 1 and num_tokens % (tile * size) == 0:
            group.append(a)
            tile *= size
    return tuple(group)


def residual_moe(mesh, x, gate_w, w_in, w_out, **kwargs):
    """``expert_parallel_moe`` on this rank's block of the residual
    stream, as the flax MoEMlp bound to ``mesh`` runs it: ``x`` [B/dp,
    S/cp, d], the rows over "data" and the positions over "context"
    (the Trainer's split). The JAX layer flattens the global [B, S]
    grid in row-major order and shards the flat tokens over
    ``residual_token_spec``'s axes, so a routing group is a contiguous
    run of b·S/cp tokens of its data rank's rows, all positions of
    those rows, not a rank's own positions. On a context axis wider
    than one the block is re-laid out to those groups: the data rank's
    [B/dp, S, d] grid gathered over "context", this rank's contiguous
    1/cp of its flat tokens routed, the outputs gathered back and this
    rank's positions kept. Both gathers are ``GatherSum`` (their
    backward sums the context ranks' gradients: each rank's loss is a
    separate term). Returns (out [B/dp, S/cp, d], aux)."""
    sizes = mesh_shape(mesh)
    cp = sizes.get(CONTEXT_AXIS, 1)
    b, s, d = x.shape
    spec = residual_token_spec(mesh,
                               b * s * sizes.get(DATA_AXIS, 1) * cp)
    if cp == 1:
        out, aux = expert_parallel_moe(mesh, x.reshape(-1, d), gate_w,
                                       w_in, w_out, token_spec=spec,
                                       **kwargs)
        return out.view(b, s, d), aux
    if CONTEXT_AXIS not in spec:
        raise ValueError(
            f"{b * s * cp} tokens of a data rank do not tile over "
            f"{CONTEXT_AXIS}={cp} and the expert axis")
    group = axis_group(mesh, CONTEXT_AXIS)
    grid = collectives.GatherSum.apply(x, 1, group)          # [b, S, d]
    tokens = collectives.local_slice(grid.reshape(-1, d), 0, group)
    out, aux = expert_parallel_moe(mesh, tokens, gate_w, w_in, w_out,
                                   token_spec=spec, **kwargs)
    out = collectives.GatherSum.apply(out, 0, group).view(b, s * cp, d)
    return collectives.local_slice(out, 1, group), aux


def global_batch_moe(mesh, x, gate_w, w_in, w_out, *,
                     capacity_factor=1.25, top_k=2, activation=gelu):
    """``dense_moe`` over the global batch when the tokens are split
    over the mesh's "data" and "context" axes: what GSPMD runs for the
    JAX module without an expert axis.

    ``x`` [B/dp, S/cp, d] is this rank's block of the [B, S] token grid
    (rows over "data", positions over "context"). The f32 gate logits
    are gathered into the grid in the global token order (b * S + s);
    every rank routes the whole grid alike (capacity and aux over the
    global batch) and runs only its own tokens, in slots compacted per
    expert, through their experts. The gathers' backward sums the
    ranks' gradients (their losses are separate terms of one mean).
    Returns (out [B/dp * S/cp, d], aux f32), aux the global batch's on
    every rank."""
    b, s, d = x.shape
    e = w_in.shape[0]
    tokens = x.reshape(-1, d)
    grid = (tokens.float() @ gate_w.float()).view(b, s, e)
    sizes = mesh_shape(mesh)
    for axis, dim in ((CONTEXT_AXIS, 1), (DATA_AXIS, 0)):
        if sizes.get(axis, 1) > 1:
            grid = collectives.GatherSum.apply(grid, dim,
                                               axis_group(mesh, axis))
    rows, cols = grid.shape[0], grid.shape[1]
    cap = expert_capacity(rows * cols, e, capacity_factor, top_k)
    expert, slot, keep, weight, aux = top_k_routing_indices(
        grid.reshape(rows * cols, e), cap, top_k=top_k)
    r0 = axis_index(mesh, DATA_AXIS) * b
    c0 = axis_index(mesh, CONTEXT_AXIS) * s
    dev = x.device
    own = ((r0 + torch.arange(b, device=dev))[:, None] * cols
           + (c0 + torch.arange(s, device=dev))[None, :]).reshape(-1)
    expert, slot, keep, weight = (t.index_select(0, own) for t in
                                  (expert, slot, keep, weight))
    # This rank's kept choices, in the global slot order, renumbered
    # from 0 within each expert: the FFN sees its own tokens only.
    flat_e, flat_k = expert.reshape(-1), keep.reshape(-1)
    key = torch.where(flat_k, flat_e * cap + slot.reshape(-1),
                      torch.full_like(flat_e, e * cap))
    order = torch.argsort(key)
    counts = torch.bincount(flat_e[flat_k], minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    local = torch.empty_like(flat_e)
    local[order] = (torch.arange(order.numel(), device=dev)
                    - starts[flat_e[order]])
    cap_local = max(int(counts.max()), 1)
    out = _dispatch_ffn_combine(tokens, expert, local.view_as(slot), keep,
                                weight, e, cap_local, w_in, w_out,
                                activation)
    return out, aux

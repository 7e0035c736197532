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

"""Mixture-of-Experts routing on one device (counterpart of the
single-device half of container_engine_accelerators_tpu/parallel/
expert.py).

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

The expert-parallel form (``expert_parallel_moe`` over an "expert"
mesh axis) waits for the distributed port and raises "not yet ported".
"""

import math

import torch
import torch.nn.functional as F

from ..utils import not_ported

EXPERT_AXIS = "expert"


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def build_expert_mesh(expert, data=None, devices=None):
    """The ("data", "expert") mesh of the JAX package: not ported."""
    raise not_ported("build_expert_mesh (expert parallelism)")


def expert_parallel_moe(mesh, tokens, gate_w, w_in, w_out, **kwargs):
    """MoE with experts sharded over a mesh axis: not ported."""
    raise not_ported("expert_parallel_moe (expert parallelism)")


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


def dense_moe(tokens, gate_w, w_in, w_out, *, capacity_factor=1.25,
              top_k=2, activation=gelu):
    """Single-group MoE, the model's path: tokens [T, d], gate_w [d, E]
    (f32), w_in [E, d, f], w_out [E, f, d] (the compute dtype). Returns
    (out [T, d] in the tokens' dtype, aux scalar f32)."""
    t, d = tokens.shape
    e = w_in.shape[0]
    cap = expert_capacity(t, e, capacity_factor, top_k)
    logits = tokens.float() @ gate_w.float()
    expert, slot, keep, weight, aux = top_k_routing_indices(
        logits, cap, top_k=top_k)
    # Indexed, not one-hot: at the LM training shape (T 16384, E 8,
    # capacity 5120) one f32 [T, E, C] tensor is 2.68 GB, and autograd
    # would keep several a routed layer. Dropped choices point at one
    # extra row past the E * C slots, which the products never read.
    dump = e * cap
    dest = torch.where(keep, expert * cap + slot,
                       torch.full_like(slot, dump))             # [T, k]
    k = dest.shape[1]
    buf = tokens.new_zeros((dump + 1, d)).index_copy(
        0, dest.reshape(-1), tokens[:, None].expand(t, k, d).reshape(-1, d))
    out = _expert_ffn(buf[:dump].view(e, cap, d), w_in, w_out, activation)
    out = torch.cat([out.reshape(dump, d), out.new_zeros((1, d))])
    # index_select, whose backward adds the kept rows' gradients back
    # with index_add_ (an advanced-indexing read sorts them instead).
    picked = out.index_select(0, dest.reshape(-1)).view(t, k, d)
    combined = picked[:, 0] * weight[:, :1]
    for j in range(1, k):
        combined = combined + picked[:, j] * weight[:, j:j + 1]
    return combined.to(tokens.dtype), aux


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

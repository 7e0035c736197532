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

"""Sequence/context parallelism: ring attention and Ulysses
(counterpart of container_engine_accelerators_tpu/parallel/context.py).

The JAX functions take [B, S, H, D] arrays sequence-sharded over the
"context" axis and run under ``shard_map``; here every rank passes its
own shard, [B_local, S/P, H, D] (the contiguous S/P slice of its data
rank's rows), and gets its own shard of the output back, over the
process group of its context-axis peers (``batch_axis`` is accepted
for the JAX signature: a rank's batch is already its data slice, and
its ring runs within its data rank).

- ``ring_attention``: K/V circulate around the context axis, one
  neighbour hop a step (``collectives.RingShift``: a batched send to
  the next rank and receive from the previous one, whose backward is
  the reverse ring); the local queries fold each block in. With
  ``use_flash`` a hop is ``flash_attention_lse`` (the CUDA kernels on
  the card, their plain versions on the CPU) and hops merge by
  logsumexp weighting (``_lse_merge``); without it the plain
  online-softmax schedule (``_block_accumulate``) runs, in sub-blocks
  of ``_KV_BLOCK`` keys. Under ``causal`` a hop's block is the
  diagonal one (causal within itself), an earlier one (fully visible)
  or a later one, which contributes nothing: the flash form skips its
  launch and hands the merge an lse of -inf (``_flash_hop``).
- ``ulysses_attention``: one all-to-all turns the sequence sharding
  into a head sharding (the whole sequence, H/P heads a rank), local
  attention runs, a second all-to-all restores the sequence sharding
  (``collectives.AllToAll``, its own transpose).

``use_flash`` None follows the tensors' device, as every kernel
wrapper does: CUDA tensors take the flash form (the kernels), CPU
tensors the plain schedule; ``use_flash=True`` on the CPU runs the
flash form through the kernels' plain versions. Both forms are exact
and differentiable.
"""

import math

import torch

from . import collectives
from .mesh import axis_group, grid_mesh, mesh_shape

CONTEXT_AXIS = "context"

_NEG = -1e9

# Keys a sub-block of the plain schedule's within-hop loop (peak score
# memory [B, H, s_local, _KV_BLOCK] instead of [B, H, s_local,
# s_local]).
_KV_BLOCK = 512


def build_context_mesh(context, data=None, devices=None):
    """A ("data", "context") mesh over the world's ranks (or
    ``devices``, a rank list); context-axis neighbours are adjacent
    ranks."""
    return grid_mesh(devices, data, context, CONTEXT_AXIS)


def _default_use_flash(*xs):
    """The flash form on CUDA tensors, the plain schedule otherwise."""
    return xs[0].device.type == "cuda"


def _mask_causal(scores, q_offset, k_offset):
    """The causal mask on [.., s_q, s_k] scores whose rows and columns
    start at global positions q_offset and k_offset."""
    s_q, s_k = scores.shape[-2], scores.shape[-1]
    q_pos = q_offset + torch.arange(s_q, device=scores.device)[:, None]
    k_pos = k_offset + torch.arange(s_k, device=scores.device)[None, :]
    return torch.where(q_pos >= k_pos, scores,
                       torch.full_like(scores, _NEG))


def dot_product_attention(q, k, v, causal=False):
    """Dense single-device attention, the reference of the parallel
    schedules: [B, S, H, D], f32 scores and softmax, the probabilities
    cast to v's dtype for the product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        scores = _mask_causal(scores, 0, 0)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype),
                        v).to(q.dtype)


def chunked_reference_attention(q, k, v, causal=False, chunk=512):
    """Exact f32 attention that never holds [S, S]: online softmax over
    key chunks, one query chunk at a time (peak score memory one [B, H,
    chunk, chunk] tile). Shares no code with the kernels or with
    ``_block_accumulate``."""
    b, s, h, d = q.shape
    if s % chunk:
        raise ValueError(f"seq len {s} not divisible by chunk {chunk}")
    n_chunks = s // chunk
    scale = 1.0 / math.sqrt(d)
    kt = k.float().transpose(1, 2)                     # [B, H, S, D]
    vt = v.float().transpose(1, 2)
    qt = q.float().transpose(1, 2)
    outs = []
    for qi in range(n_chunks):
        qc = qt[:, :, qi * chunk:(qi + 1) * chunk]
        m = torch.full((b, h, chunk), _NEG, dtype=torch.float32,
                       device=q.device)
        num = torch.zeros((b, h, chunk, d), dtype=torch.float32,
                          device=q.device)
        den = torch.zeros((b, h, chunk), dtype=torch.float32,
                          device=q.device)
        for j in range(n_chunks):
            kc = kt[:, :, j * chunk:(j + 1) * chunk]
            vc = vt[:, :, j * chunk:(j + 1) * chunk]
            scores = torch.einsum("bhqd,bhkd->bhqk", qc, kc) * scale
            if causal:
                scores = _mask_causal(scores, qi * chunk, j * chunk)
            new_m = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - new_m)
            p = torch.exp(scores - new_m[..., None])
            num = num * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vc)
            den = den * alpha + p.sum(dim=-1)
            m = new_m
        outs.append(num / den[..., None])
    return torch.cat(outs, dim=2).transpose(1, 2)


def _block_accumulate(q, k, v, q_offset, k_offset, m, num, den, causal):
    """Online-softmax accumulation of one K/V block into (m, num, den).

    q: [B, s, H, D] local queries; k/v: [B, s_k, H, D] the block
    resident on this rank; the offsets are the global positions of q[0]
    and k[0], for the causal mask across blocks. m and den are [B, H,
    s, 1], num [B, s, H, D], all f32. The block is consumed in
    ``_KV_BLOCK`` sub-blocks (one sub-block when the block does not
    divide)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s_k = k.shape[1]
    blk = min(_KV_BLOCK, s_k)
    n_blocks, rem = divmod(s_k, blk)
    if rem:
        n_blocks, blk = 1, s_k
    qf = q.float()
    for i in range(n_blocks):
        k_blk = k[:, i * blk:(i + 1) * blk]
        v_blk = v[:, i * blk:(i + 1) * blk]
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        if causal:
            scores = _mask_causal(scores, q_offset, k_offset + i * blk)
        new_m = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
        correction = torch.exp(m - new_m)
        p = torch.exp(scores - new_m)
        num = num * correction.transpose(1, 2) + torch.einsum(
            "bhqk,bkhd->bqhd", p, v_blk.float())
        den = den * correction + p.sum(dim=-1, keepdim=True)
        m = new_m
    return m, num, den


def _flash_hop(q, k_blk, v_blk, q_offset, k_offset, causal):
    """One ring hop through the flash kernels: the local queries'
    partial attention over one K/V block, as (o [B, s, H, D] f32, lse
    [B, s, H] f32). The blocks are uniform s-row tiles, so under
    ``causal`` the diagonal block is causal within itself, an earlier
    block is fully visible, and a later block contributes nothing: its
    launch is skipped and its lse is -inf, which ``_lse_merge`` weighs
    to exactly zero (no gradient reaches K/V from it)."""
    from ..ops.attention import flash_attention_lse

    if causal and k_offset > q_offset:
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(q.shape[:3], -math.inf, dtype=torch.float32,
                           device=q.device))
    o, lse = flash_attention_lse(q, k_blk, v_blk,
                                 causal=causal and k_offset == q_offset)
    return o.float(), lse


def _lse_merge(acc, m, den, o_t, lse_t):
    """Fold one hop's partial (o_t, lse_t) into the running (acc, m,
    den): numerators weighted by exp(lse) against a running maximum.
    Where the maximum is still -inf (no unmasked key seen yet in a
    row) both differences would be -inf - -inf; they are routed to
    exp(-inf) = 0 instead, which also keeps their cotangent at zero."""
    new_m = torch.maximum(m, lse_t)
    empty = torch.isneginf(new_m)
    neg = torch.full_like(new_m, -math.inf)
    corr = torch.exp(torch.where(empty, neg, m - new_m))
    w_t = torch.exp(torch.where(empty, neg, lse_t - new_m))
    acc = acc * corr[..., None] + o_t * w_t[..., None]
    den = den * corr + w_t
    return acc, new_m, den


class _Anchor(torch.autograd.Function):
    """``out`` unchanged, with ``k`` and ``v`` tied into its graph at a
    zero gradient: a rank that skipped its last hops still runs the
    backward of every ring hop, which passes the other ranks' gradients
    on (its peers wait for them)."""

    @staticmethod
    def forward(ctx, out, k, v):
        ctx.like = (k.shape, k.dtype, k.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.like
        zero = torch.zeros(shape, dtype=dtype, device=device)
        return grad, zero, zero


def _context_peers(mesh, axis_name):
    """(group, this rank's index on the axis, the axis size)."""
    size = mesh_shape(mesh)[axis_name]
    group = axis_group(mesh, axis_name)
    idx = 0 if size == 1 else collectives.ring_peers(group)[0]
    return group, idx, size


def ring_attention(mesh, q, k, v, *, axis_name=CONTEXT_AXIS,
                   causal=False, batch_axis=None, use_flash=None):
    """Exact attention with K/V circulating the context-axis ring.

    q/k/v: this rank's [B, S/P, H, D] shards. P hops: hop t folds in
    the block that originated on ring rank (idx - t) mod P, then (but
    after the last) passes the resident block on to the next rank.
    ``use_flash`` (None: on CUDA tensors) computes each hop with
    ``flash_attention_lse`` and merges by logsumexp; otherwise the
    plain online-softmax schedule runs. Differentiable either way.
    ``batch_axis`` is accepted for the JAX signature (module
    docstring)."""
    del batch_axis
    if use_flash is None:
        use_flash = _default_use_flash(q, k, v)
    group, idx, p_size = _context_peers(mesh, axis_name)
    b, s_local, h, d = q.shape
    q_offset = idx * s_local
    if use_flash:
        acc = torch.zeros((b, s_local, h, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, s_local, h), -math.inf, dtype=torch.float32,
                       device=q.device)
        den = torch.zeros((b, s_local, h), dtype=torch.float32,
                          device=q.device)
    else:
        m = torch.full((b, h, s_local, 1), _NEG, dtype=torch.float32,
                       device=q.device)
        num = torch.zeros((b, s_local, h, d), dtype=torch.float32,
                          device=q.device)
        den = torch.zeros((b, h, s_local, 1), dtype=torch.float32,
                          device=q.device)
    for t in range(p_size):
        k_offset = ((idx - t) % p_size) * s_local
        if use_flash:
            o_t, lse_t = _flash_hop(q, k, v, q_offset, k_offset, causal)
            acc, m, den = _lse_merge(acc, m, den, o_t, lse_t)
        else:
            m, num, den = _block_accumulate(q, k, v, q_offset, k_offset,
                                            m, num, den, causal)
        if t < p_size - 1:
            # No P-th hop: nobody would read its result.
            k, v = collectives.RingShift.apply(k, v, group)
    if not use_flash:
        return (num / den.transpose(1, 2)).to(q.dtype)
    out = (acc / den[..., None]).to(q.dtype)
    if causal and p_size > 1 and idx < p_size - 1:
        # The last block was a later one, skipped (see _Anchor).
        out = _Anchor.apply(out, k, v)
    return out


def _blockwise_attention(q, k, v, causal):
    """Single-device attention through the online-softmax K-block loop:
    dot_product_attention's result with peak score memory [B, H, S,
    _KV_BLOCK]."""
    b, s, h, d = q.shape
    m = torch.full((b, h, s, 1), _NEG, dtype=torch.float32,
                   device=q.device)
    num = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((b, h, s, 1), dtype=torch.float32, device=q.device)
    m, num, den = _block_accumulate(q, k, v, 0, 0, m, num, den, causal)
    return (num / den.transpose(1, 2)).to(q.dtype)


def ulysses_attention(mesh, q, k, v, *, axis_name=CONTEXT_AXIS,
                      causal=False, batch_axis=None, use_flash=None):
    """Exact attention by all-to-all head re-sharding (Ulysses).

    q/k/v: this rank's [B, S/P, H, D] shards; H must divide by the axis
    size. The first all-to-all gives each rank the whole sequence for
    H/P heads, local attention runs over it (``flash_attention`` with
    ``use_flash``, None: on CUDA tensors; else the plain blockwise
    schedule), and the second all-to-all restores the sequence
    sharding. ``batch_axis`` as in ``ring_attention``."""
    del batch_axis
    if use_flash is None:
        use_flash = _default_use_flash(q, k, v)
    p_size = mesh_shape(mesh)[axis_name]
    if q.shape[2] % p_size != 0:
        raise ValueError(
            f"{q.shape[2]} heads not divisible by {axis_name} axis "
            f"size {p_size}")
    group = axis_group(mesh, axis_name) if p_size > 1 else None

    def seq_to_heads(x):
        if group is None:
            return x
        return collectives.AllToAll.apply(x, 2, 1, group)

    def heads_to_seq(x):
        if group is None:
            return x
        return collectives.AllToAll.apply(x, 1, 2, group)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if use_flash:
        from ..ops.attention import flash_attention

        out = flash_attention(qh, kh, vh, causal=causal)
    else:
        out = _blockwise_attention(qh, kh, vh, causal=causal)
    return heads_to_seq(out)

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

"""Decoder-only transformer LM (counterpart of the flax TransformerLM).

Same architecture and numerics as the JAX package's module: pre-norm
residual blocks, bf16 compute, LayerNorm statistics and affine in f32
with epsilon 1e-6, tanh-approximated GELU, and an f32 lm_head on an
f32 copy of the final hidden state. Weights come over from a flax tree
through ``models/convert.py``.

Parameters are held in ``param_dtype`` and cast to the compute dtype
at every call, as flax's ``param_dtype``/``dtype`` pair does. Training
holds them in f32 (the default, as in flax), so gradients and SGD
updates land in f32: an update of lr * g ~ 1e-5 on a bf16 weight of
magnitude 0.05 would round away. Serving loads them in the compute
dtype (``convert.load_lm``), where the cast is a no-op.

Training mode: ``attention_fn`` replaces the causal flash attention
(the JAX module's argument of that name), and ``next_token_loss_fn``
is the shift-by-one objective. ``attention_window`` W > 0 is sliding-
window attention: query p sees keys in (p - W, p], passed to the
attention function as ``window=W`` (one that takes no ``window``
raises, as the flax module refuses a window on a non-flash schedule).

Decode mode keeps a dense KV cache per layer, passed explicitly
(``init_cache``) instead of living in a flax variable collection:

- a scalar ``index`` with a multi-token chunk is the one-shot prefill
  into an empty cache: K/V land at [0, P) and attention runs the flash
  kernel on the raw chunk;
- the same chunk with ``chunk_attends_cache=True`` (at any offset, 0
  included) writes at [index, index + P) and attends the cache, as
  the paged pool's admission prefill does after its shared prefix;
- otherwise (single-token steps, or a [B] vector of per-row positions
  for the slot engine, one token or a chunk a row) each row writes its
  K/V at its own positions (per-row positions past the cache drop) and
  attends the cache through the grouped product with the mask
  k_pos <= q_pos (and k_pos > q_pos - W with a window), f32 scores and
  softmax, probabilities cast to the compute dtype before the product
  with V.

A sliding-window model's ``init_cache`` makes a ``RingCache``, the
flax module's ring: min(length, W + ring_slack) slots a layer,
position p in slot p % c_len, and a per-row ``slot_pos`` [B, c_len]
(-1: never written) that the mask reads in place of the slot index
(k_pos >= 0, k_pos <= q_pos, k_pos > q_pos - W). The one-shot prefill
writes only the chunk's last c_len entries and still runs the flash
kernel with the window on the raw chunk. Per-row positions (the slot
engine) take full-length caches only, where the window is the band
alone, as the flax module's ``per_row_index`` caches are never rings.

The paged cache (``init_paged_cache``, the flax module's ``kv_pages``)
is one [num_blocks, block_size, Hkv, D] arena per layer; a step's
``block_table`` [B, n_blk] maps row b's position p to (table[b, p //
block_size], p % block_size), and the read gathers each row's blocks
back into position order before the same grouped product. No Pallas
kernel lies on these cached paths: the JAX package runs them in XLA.

A quantized cache (``kv_cache_dtype`` "int8" or "int4", or the mode a
cache is made in, ``init_cache(..., quant=)``) holds four buffers a
layer: K and V as symmetric int8 rows (int4: two values a byte, uint8
[..., D/2]) and one f32 scale per (position, head) for each, [..., Hkv,
1]. A step quantizes its K/V before the write; the grouped product
converts the integers to the compute dtype at the product and folds
the K scales into the scores and the V scales into the probabilities,
as the flax module does. The mode travels with the cache, so the
engine serves a mode other than the model's own with the same weights.

``weights="int8"`` replaces the attention and MLP projections with
``models.quantized.Int8Linear`` (embeddings, norms and the f32 lm_head
stay native), as the flax module's ``weights="int8"`` does.
"""

import inspect
import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import obs
from ..ops.attention import flash_attention
from ..utils import not_ported
from .quantized import Int8Linear

_LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


def _quantize_rows_int8(x):
    """Symmetric int8 quantization per trailing-dim row: (int8 values,
    f32 scale with a keepdim trailing axis); x ~= values * scale. The
    flax module's arithmetic: divide (never multiply by a reciprocal),
    round half to even, clip to [-127, 127]. The divisors are tensors:
    on CUDA torch turns a division by a Python number into a product
    with its reciprocal, which rounds differently."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize_rows_int4(x):
    """Symmetric int4 quantization per trailing-dim row, packed two
    values a byte along the (even) head dim: (uint8 [..., D/2], f32
    scale [..., 1]). Pair (x[2i], x[2i+1]) sits in the low and high
    nibbles of byte i, biased by +8 so [-7, 7] stores as [1, 15]. The
    divisions are ``_quantize_rows_int8``'s."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 7.0)
    q = torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int32) + 8
    lo, hi = q[..., 0::2], q[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8), scale


def _unpack_int4(packed):
    """Inverse of the ``_quantize_rows_int4`` pack: uint8 [..., D/2] ->
    int8 [..., D] in [-7, 7], integer arithmetic only."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],))


def check_kv_cache_dtype(kv_cache_dtype, head_dim):
    """The flax module's checks of a cache mode: None, "int8" or
    "int4", and int4 only with an even head dim."""
    if kv_cache_dtype not in (None, "int8", "int4"):
        raise ValueError(
            f"unsupported kv_cache_dtype {kv_cache_dtype!r}; "
            f"use None, \"int8\", or \"int4\"")
    if kv_cache_dtype == "int4" and head_dim % 2:
        raise ValueError(
            f"kv_cache_dtype=\"int4\" packs value pairs along the "
            f"head dim and needs it even, got {head_dim}")


def apply_rope(x, positions, base=10000.0):
    """Rotary position embedding. x: [B, S, H, D]; positions: [S]
    (global positions of the S axis), or [B, S] when every batch row
    sits at its own position. Pairs dimension i with i + D/2 (the
    split layout, not interleaved). Computed in f32, returned in x's
    dtype."""
    if x.shape[-1] % 2:
        raise ValueError(
            f"rope needs an even head dim, got {x.shape[-1]} "
            f"(embed_dim must be divisible by 2*num_heads)")
    d2 = x.shape[-1] // 2
    freqs = base ** (-torch.arange(d2, dtype=torch.float32,
                                   device=x.device) / d2)
    angles = positions.to(torch.float32)[..., None] * freqs
    if angles.ndim == 2:
        cos = torch.cos(angles)[None, :, None, :]
        sin = torch.sin(angles)[None, :, None, :]
    else:
        cos = torch.cos(angles)[:, :, None, :]
        sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                        dim=-1)
    return rotated.to(x.dtype)


class Linear(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: input, weight and bias cast to the
    compute dtype at the call (no-ops when they are held in it)."""

    def __init__(self, in_features, out_features, dtype, param_dtype,
                 device=None):
        super().__init__(in_features, out_features, device=device,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _linear(quantized, in_features, out_features, dtype, param_dtype,
            device):
    """``Linear``, or its weight-only int8 counterpart (the flax
    module's ``_linear``)."""
    if quantized:
        return Int8Linear(in_features, out_features, dtype, device)
    return Linear(in_features, out_features, dtype, param_dtype, device)


class Embedding(nn.Embedding):
    """flax ``nn.Embed(dtype=...)``: the looked-up rows in the compute
    dtype. Gathering first and casting the rows is the same lookup as
    casting the table first, and leaves the table's gradient in f32."""

    def __init__(self, num, dim, dtype, param_dtype, device=None):
        super().__init__(num, dim, device=device, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, tokens):
        return super().forward(tokens).to(self.compute_dtype)


def _expand_kv(x, heads):
    """[B, S, Hkv, D] -> [B, S, H, D] by repeating each KV head over
    its query group (no-op for MHA)."""
    kv_heads = x.shape[2]
    if kv_heads == heads:
        return x
    return torch.repeat_interleave(x, heads // kv_heads, dim=2)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: statistics and affine in f32,
    result cast to the compute dtype."""

    def __init__(self, dim, dtype, device=None):
        super().__init__(dim, eps=_LN_EPS, device=device,
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        return super().forward(x.float()).to(self.compute_dtype)


def _takes_window(fn):
    """Whether ``fn`` accepts a ``window`` keyword."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "window" or p.kind == p.VAR_KEYWORD
               for p in params)


class RingCache(list):
    """A sliding-window model's scalar-index cache: the per-layer
    buffers ``init_cache`` makes, of ``c_len`` ring slots each, and
    ``slot_pos`` [B, c_len] int64, the global position each slot holds
    (-1: never written). Every layer writes the same positions, so one
    ``slot_pos`` serves them all (the flax module keeps an equal copy a
    layer). Its leaves are batch-major, slot_pos included, so a beam
    gather or a prefix fan-out maps over ``leaves``."""

    def __init__(self, layers, slot_pos):
        super().__init__(layers)
        self.slot_pos = slot_pos


def map_cache(fn, cache):
    """``fn`` applied to every batch-major leaf of a dense or ring
    cache (the flax cache tree's ``_map_batch_leaves``)."""
    layers = [tuple(fn(a) for a in layer) for layer in cache]
    if isinstance(cache, RingCache):
        return RingCache(layers, fn(cache.slot_pos))
    return layers


def _ring_write(buf, index, val):
    """Write ``val`` [B, P, ...] at global positions index..index+P-1
    into the ring ``buf`` [B, c_len, ...]: only the last min(P, c_len)
    entries land (earlier ones would be overwritten within the chunk),
    in consecutive slots mod c_len, split in two at the wrap."""
    c_len, p = buf.shape[1], val.shape[1]
    n = min(p, c_len)
    tail = val[:, p - n:]
    start = (index + p - n) % c_len
    first = min(n, c_len - start)
    buf[:, start:start + first] = tail[:, :first]
    if n > first:
        buf[:, :n - first] = tail[:, first:]


def _write_slot_pos(cache, index, q_len):
    """Record positions index..index+q_len-1 in a ring's ``slot_pos``."""
    pos = torch.arange(index, index + q_len,
                       device=cache.slot_pos.device)
    _ring_write(cache.slot_pos, index,
                pos.expand(cache.slot_pos.shape[0], q_len))


def _row_write(buf, pos, val):
    """Per-row chunk write: row b's entries at positions ``pos`` [B, Q]
    of ``buf`` [B, L, ...]; positions past the row drop (the optimistic
    tail of a chunk the row cannot hold)."""
    r, c = (pos < buf.shape[1]).nonzero(as_tuple=True)
    buf[r, pos[r, c]] = val[r, c].to(buf.dtype)


class CausalSelfAttention(nn.Module):
    """Pre-norm causal attention residual, [B, S, E] in/out."""

    def __init__(self, embed_dim, num_heads, num_kv_heads=None,
                 rope=False, dtype=torch.bfloat16, device=None,
                 param_dtype=torch.float32, attention_fn=None,
                 weights="native", window=0):
        super().__init__()
        kv = num_kv_heads or num_heads
        if num_heads % kv:
            raise ValueError(
                f"num_kv_heads {kv} must divide num_heads {num_heads}")
        if window and attention_fn is not None and not _takes_window(
                attention_fn):
            raise ValueError(
                "window (sliding-window attention) needs an attention_fn "
                "that takes window=; this one does not")
        self.num_heads, self.num_kv_heads = num_heads, kv
        self.head_dim = embed_dim // num_heads
        self.rope = rope
        self.window = int(window)
        self.attention_fn = attention_fn or flash_attention
        d = self.head_dim
        dd = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        quant = weights == "int8"
        self.ln = LayerNorm(embed_dim, dtype, device)
        if kv == num_heads:
            self.qkv = _linear(quant, embed_dim, 3 * num_heads * d, **dd)
        else:
            self.q = _linear(quant, embed_dim, num_heads * d, **dd)
            self.kv = _linear(quant, embed_dim, 2 * kv * d, **dd)
        self.proj = _linear(quant, embed_dim, embed_dim, **dd)

    def _project(self, h):
        b, s, _ = h.shape
        heads, kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        if kv == heads:
            qkv = self.qkv(h).view(b, s, 3, heads, d)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = self.q(h).view(b, s, heads, d)
        kv_out = self.kv(h).view(b, s, 2, kv, d)
        return q, kv_out[:, :, 0], kv_out[:, :, 1]

    def forward(self, x, cache=None, index=None, block_table=None,
                chunk_attends_cache=False, slot_pos=None):
        """``cache``: None (full causal forward) or this layer's
        (K, V) buffers, updated in place: dense [B, L, Hkv, D] (a
        ring's c_len slots with ``slot_pos``), or with ``block_table``
        the paged arenas [num_blocks, block_size, Hkv, D]; a quantized
        cache adds the K and V scales, (K, V, K scale, V scale);
        ``index``: the write offset, an int or a [B] tensor of per-row
        positions (the only form the paged cache takes); without a
        cache, the int global position of ``x``'s first token (a
        sequence shard's offset, ``TransformerLM.seq_offset``).
        ``chunk_attends_cache``: a multi-token chunk at an int offset
        attends the cache (the paged admission prefill) instead of
        running the flash kernel on itself alone. ``slot_pos``: the
        ring's [B, c_len] slot positions, already holding this call's
        (``TransformerLM.forward`` writes them once for every layer)."""
        q, k, v = self._project(self.ln(x))
        heads = self.num_heads
        if cache is None:
            if self.rope:
                # ``index``: the chunk's global offset (a sequence
                # shard's; 0 for the whole sequence).
                pos = torch.arange(q.shape[1], device=q.device) + (
                    index or 0)
                q, k = apply_rope(q, pos), apply_rope(k, pos)
            kwargs = {"window": self.window} if self.window else {}
            attn = self.attention_fn(q, _expand_kv(k, heads),
                                     _expand_kv(v, heads), causal=True,
                                     **kwargs)
        else:
            attn = self._cached_attention(q, k, v, cache, index,
                                          block_table, chunk_attends_cache,
                                          slot_pos)
        return x + self.proj(attn.reshape(x.shape))

    def _cached_attention(self, q, k, v, cache, index, block_table,
                          chunk_attends_cache, slot_pos):
        """The cache write and the attention over it, in a
        ``model.attention`` span timed on the device."""
        with obs.span("model.attention", timed_on=q.device):
            return self._attend_cache(q, k, v, cache, index, block_table,
                                      chunk_attends_cache, slot_pos)

    def _attend_cache(self, q, k, v, cache, index, block_table,
                      chunk_attends_cache, slot_pos):
        cache_k = cache[0]
        b, q_len, heads, d = q.shape
        steps = torch.arange(q_len, device=q.device)
        ring = slot_pos is not None
        if isinstance(index, int):
            if block_table is not None:
                raise ValueError("the paged cache takes [B] per-row "
                                 "positions, not an int offset")
            if q_len > 1 and index != 0 and not chunk_attends_cache:
                raise ValueError(
                    f"a {q_len}-token chunk at offset {index} must "
                    f"attend the cache (chunk_attends_cache=True)")
            length = cache_k.shape[1]
            if not ring and index + q_len > length:
                raise ValueError(
                    f"chunk at {index}..{index + q_len} overruns the "
                    f"{length}-position cache")
            pos = (index + steps).expand(b, q_len)
        else:
            pos = index[:, None] + steps                      # [B, Q]
        if self.rope:
            q, k = apply_rope(q, pos), apply_rope(k, pos)
        if len(cache) == 4:
            quantize = (_quantize_rows_int4 if cache_k.dtype == torch.uint8
                        else _quantize_rows_int8)
            kq, ks = quantize(k)
            vq, vs = quantize(v)
            writes = (kq, vq, ks, vs)
        else:
            writes = (k, v)
        # In-place cache writes. Single-token per-row positions must
        # lie inside the buffer: the slot engine clamps free rows into
        # the row.
        if block_table is not None:
            for buf, val in zip(cache, writes):
                _paged_write(buf, block_table, pos, val)
            reads = [_paged_read(buf, block_table) for buf in cache]
        else:
            for buf, val in zip(cache, writes):
                if ring:
                    _ring_write(buf, index, val.to(buf.dtype))
                elif isinstance(index, int):
                    buf[:, index:index + q_len] = val
                elif q_len == 1:
                    rows = torch.arange(b, device=q.device)
                    buf[rows, index] = val[:, 0]
                else:
                    _row_write(buf, pos, val)
            reads = list(cache)
        if isinstance(index, int) and q_len > 1 and not chunk_attends_cache:
            # One-shot prefill into an empty cache: causal (windowed)
            # attention among the chunk's own tokens, on the flash
            # kernel (no int8 round trip for the chunk's own scores),
            # whatever part of the chunk the ring kept.
            return flash_attention(q, _expand_kv(k, heads),
                                   _expand_kv(v, heads), causal=True,
                                   window=self.window or None)
        if cache_k.dtype == torch.uint8:
            reads[:2] = [_unpack_int4(r) for r in reads[:2]]
        return _grouped_attention(q, pos, *reads, window=self.window,
                                  slot_pos=slot_pos)


def _paged_write(arena, table, pos, val):
    """Write ``val`` [B, Q, Hkv, D] at each row's positions ``pos``
    [B, Q]: row b's position p lands at (table[b, p // bs], p % bs). A
    position past the table's span is dropped: a single token writes
    back what its clamped cell already holds (clamping alone would
    overwrite the row's own live tail), a chunk skips it. Active rows
    own the blocks they write (the engine's refcount and copy-on-write
    invariant), so only free rows, all on the trash block, share a
    cell."""
    bs, n_blk = arena.shape[1], table.shape[1]
    blk = torch.div(pos, bs, rounding_mode="floor")
    in_span = blk < n_blk
    phys = torch.gather(table, 1, blk.clamp(max=n_blk - 1))
    off = pos % bs
    if pos.shape[1] == 1:
        phys, off, in_span = phys[:, 0], off[:, 0], in_span[:, 0]
        arena[phys, off] = torch.where(in_span[:, None, None],
                                       val[:, 0].to(arena.dtype),
                                       arena[phys, off])
        return
    r, c = in_span.nonzero(as_tuple=True)
    arena[phys[r, c], off[r, c]] = val[r, c].to(arena.dtype)


def _paged_read(arena, table):
    """Each row's blocks gathered back through its table: [B, n_blk *
    bs, Hkv, D], logical position p at index p. The copy is the paged
    gather's cost; entries on the trash block are junk the per-row
    mask never admits."""
    return arena[table].flatten(1, 2)


def _grouped_attention(q, pos, keys, values, k_scale=None, v_scale=None,
                       window=0, slot_pos=None):
    """Queries [B, Q, H, D] at positions ``pos`` [B, Q] against the
    cache [B, L, Hkv, D] with the mask k_pos <= q_pos, where k_pos is
    the index (or a ring's ``slot_pos`` [B, L], which also needs
    k_pos >= 0), and k_pos > q_pos - window with a window. Grouped
    form: queries [B, Hkv, G*Q, D] attend their KV head directly, with
    no repeated copy of the cache; f32 scores and softmax,
    probabilities cast to the compute dtype before the product with V.
    A quantized cache's integer K/V convert to the compute dtype at the
    products (exact up to 127 in bf16); its scales [B, L, Hkv, 1]
    multiply the scaled scores (K) and the f32 probabilities (V)."""
    b, q_len, heads, d = q.shape
    kv_heads = keys.shape[2]
    g = heads // kv_heads
    dt = q.dtype
    qg = q.reshape(b, q_len, kv_heads, g, d).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(b, kv_heads, g * q_len, d)
    kt = keys.to(dt).permute(0, 2, 3, 1)                       # [B,Hkv,D,L]
    scores = torch.matmul(qg.float(), kt.float()) / math.sqrt(d)
    scores = scores.view(b, kv_heads, g, q_len, -1)
    if k_scale is not None:
        # [B, L, Hkv, 1] -> [B, Hkv, 1, 1, L] over (group, query).
        scores = scores * k_scale[..., 0].permute(0, 2, 1)[:, :, None, None]
    q_pos = pos[:, :, None]                                     # [B,Q,1]
    if slot_pos is None:
        k_pos = torch.arange(keys.shape[1], device=q.device)[None, None]
        keep = k_pos <= q_pos                                   # [B,Q,L]
    else:
        k_pos = slot_pos[:, None, :]
        keep = (k_pos >= 0) & (k_pos <= q_pos)
    if window:
        keep = keep & (k_pos > q_pos - window)
    scores = torch.where(keep[:, None, None], scores,
                         torch.full_like(scores, -1e9))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[..., 0].permute(0, 2, 1)[:, :, None, None]
    probs = probs.to(dt).view(b, kv_heads, g * q_len, -1)
    out = torch.matmul(probs, values.to(dt).transpose(1, 2))
    out = out.view(b, kv_heads, g, q_len, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, q_len, heads, d)


class Block(nn.Module):
    """Pre-norm attention + MLP residual block, [B, S, E] in/out."""

    def __init__(self, embed_dim, num_heads, mlp_ratio=4,
                 num_kv_heads=None, rope=False, dtype=torch.bfloat16,
                 device=None, param_dtype=torch.float32,
                 attention_fn=None, weights="native", window=0):
        super().__init__()
        self.attn = CausalSelfAttention(embed_dim, num_heads,
                                        num_kv_heads, rope, dtype, device,
                                        param_dtype, attention_fn, weights,
                                        window)
        self.ln = LayerNorm(embed_dim, dtype, device)
        dd = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        quant = weights == "int8"
        self.mlp_in = _linear(quant, embed_dim, mlp_ratio * embed_dim, **dd)
        self.mlp_out = _linear(quant, mlp_ratio * embed_dim, embed_dim, **dd)

    def forward(self, x, cache=None, index=None, block_table=None,
                chunk_attends_cache=False, slot_pos=None):
        x = self.attn(x, cache, index, block_table, chunk_attends_cache,
                      slot_pos)
        h = F.gelu(self.mlp_in(self.ln(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """Causal LM. Input [B, S] int tokens -> [B, S, V] f32 logits.

    ``attention_fn(q, k, v, causal=True)`` replaces the flash attention
    of the full causal forward (None: ``flash_attention``), as the flax
    module's argument does; with ``attention_window`` W > 0 it is also
    passed ``window=W``. ``param_dtype`` is the type the parameters
    are held in (module docstring). ``kv_cache_dtype`` (None, "int8",
    "int4") is the mode of the caches ``init_cache`` and
    ``init_paged_cache`` make by default; ``weights="int8"`` holds the
    projections as ``Int8Linear``. ``ring_slack`` adds ring slots
    beyond the window to the caches ``init_cache`` makes (the flax
    module's: it changes the cache shape only; the slot engine refuses
    it). The flax module's ``kv_pages`` and ``chunk_attends_cache``
    clone flags are arguments of ``forward`` here (``block_table``,
    ``chunk_attends_cache``), so the constructor refuses them."""

    def __init__(self, vocab_size=32000, embed_dim=512, num_layers=8,
                 num_heads=8, max_seq_len=2048, mlp_ratio=4,
                 dtype=torch.bfloat16, num_kv_heads=None,
                 pos_embedding="learned", kv_cache_dtype=None,
                 attention_window=0, weights="native",
                 chunk_attends_cache=False, ring_slack=0, kv_pages=None,
                 device="cuda", param_dtype=torch.float32,
                 attention_fn=None):
        super().__init__()
        if pos_embedding not in ("learned", "rope"):
            raise ValueError(
                f"pos_embedding must be 'learned' or 'rope': "
                f"{pos_embedding!r}")
        if weights not in ("native", "int8"):
            raise ValueError(
                f"weights must be 'native' or 'int8': {weights!r}")
        check_kv_cache_dtype(kv_cache_dtype, embed_dim // num_heads)
        for option, value, default in (
                ("chunk_attends_cache", chunk_attends_cache, False),
                ("kv_pages", kv_pages, None)):
            if value != default:
                raise not_ported(f"{option}={value!r} as a module option "
                                 f"(pass it to forward)")
        if attention_window < 0 or ring_slack < 0:
            raise ValueError(
                f"attention_window and ring_slack must be >= 0: "
                f"{attention_window}, {ring_slack}")
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads = num_kv_heads
        self.max_seq_len, self.mlp_ratio = max_seq_len, mlp_ratio
        self.pos_embedding, self.dtype = pos_embedding, dtype
        self.kv_cache_dtype, self.weights = kv_cache_dtype, weights
        self.attention_window = int(attention_window)
        self.ring_slack = int(ring_slack)
        dd = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.tok_embed = Embedding(vocab_size, embed_dim, **dd)
        if pos_embedding == "learned":
            self.pos_embed = Embedding(max_seq_len, embed_dim, **dd)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, num_kv_heads,
                  pos_embedding == "rope", dtype, device, param_dtype,
                  attention_fn, weights, self.attention_window)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(embed_dim, dtype, device)
        self.lm_head = nn.Linear(embed_dim, vocab_size, device=device)
        # The global position of the first token of a full forward's
        # input: nonzero on a context rank, whose input is its slice of
        # the sequence (the Trainer on a context mesh sets it).
        self.seq_offset = 0

    @property
    def device(self):
        return self.tok_embed.weight.device

    def _cache_buffers(self, lead, quant):
        """Every layer's zero-filled cache buffers of leading shape
        ``lead``: (K, V) [*lead, Hkv, D] in the compute dtype, or in the
        quantized modes (K, V, K scale, V scale) with int8 [*lead, Hkv,
        D] (int4: uint8 [*lead, Hkv, D/2]) values and f32 [*lead, Hkv,
        1] scales. ``quant``: None for the model's own kv_cache_dtype,
        or the engine's mode name ("bf16" is the compute dtype)."""
        kv = self.num_kv_heads or self.num_heads
        d = self.embed_dim // self.num_heads
        mode = (self.kv_cache_dtype if quant is None
                else None if quant == "bf16" else quant)
        check_kv_cache_dtype(mode, d)
        if mode is None:
            specs = [(d, self.dtype)] * 2
        else:
            width = d // 2 if mode == "int4" else d
            values = torch.uint8 if mode == "int4" else torch.int8
            specs = [(width, values)] * 2 + [(1, torch.float32)] * 2
        return [tuple(torch.zeros(tuple(lead) + (kv, w), dtype=dt,
                                  device=self.device) for w, dt in specs)
                for _ in range(self.num_layers)]

    def init_cache(self, batch, length, quant=None, ring=None,
                   ring_slack=None):
        """Per-layer dense cache buffers [batch, length, ...], zero-
        filled, in the model's kv_cache_dtype or the mode ``quant``
        ("bf16", "int8", "int4"; see ``_cache_buffers``). A sliding-
        window model makes a ``RingCache`` of min(length, window +
        ring_slack) slots (``ring_slack``: the model's unless given)
        unless ``ring=False`` asks for the full-length cache the slot
        engine's per-row positions take."""
        if ring is None:
            ring = bool(self.attention_window)
        if not ring:
            return self._cache_buffers((batch, length), quant)
        if not self.attention_window:
            raise ValueError("a ring cache needs attention_window > 0")
        slack = self.ring_slack if ring_slack is None else int(ring_slack)
        if slack < 0:
            raise ValueError(f"ring_slack must be >= 0: {slack}")
        c_len = min(length, self.attention_window + slack)
        return RingCache(self._cache_buffers((batch, c_len), quant),
                         torch.full((batch, c_len), -1, dtype=torch.long,
                                    device=self.device))

    def init_paged_cache(self, num_blocks, block_size, quant=None):
        """Per-layer paged arenas [num_blocks, block_size, ...], zero-
        filled, in the model's kv_cache_dtype or the mode ``quant``: one
        arena per layer shared by every row, addressed through a block
        table."""
        return self._cache_buffers((num_blocks, block_size), quant)

    def forward(self, tokens, cache=None, index=None, block_table=None,
                chunk_attends_cache=False):
        """``cache``/``index``/``block_table``/``chunk_attends_cache``
        as in CausalSelfAttention.forward: None for a full causal
        forward, or the decode-mode cache (a list of layer buffers, or
        a ``RingCache``) and the write offset (int, or [B] per-row
        positions); ``block_table`` [B, n_blk] maps each row's logical
        blocks to arena blocks of a paged cache."""
        if cache is None:
            index = self.seq_offset
        x, layers, slot_pos = self._embed(tokens, cache, index)
        for block, layer_cache in zip(self.blocks, layers):
            x = block(x, layer_cache, index, block_table,
                      chunk_attends_cache, slot_pos)
        return self._head(x)

    def _head(self, x):
        """The final norm and the f32 lm_head on an f32 copy."""
        return self.lm_head(self.ln_f(x).float())

    def _embed(self, tokens, cache, index):
        """The embedded input, each layer's cache (None without one)
        and a ring's slot positions (written for this call), as
        ``forward`` reads them."""
        s = tokens.shape[1]
        end = s + (index if cache is None else 0)
        if end > self.max_seq_len:
            raise ValueError(
                f"sequence length {end} exceeds max_seq_len "
                f"{self.max_seq_len}")
        x = self.tok_embed(tokens)
        if self.pos_embedding == "learned":
            steps = torch.arange(s, device=tokens.device)
            if cache is None:
                pos = index + steps
            elif isinstance(index, int):
                pos = index + steps
            else:
                pos = index[:, None] + steps[None, :]
            x = x + self.pos_embed(pos)
        layers = cache if cache is not None else [None] * self.num_layers
        slot_pos = None
        if isinstance(cache, RingCache):
            if not isinstance(index, int):
                raise ValueError(
                    "per-row positions take a full-length cache, not a "
                    "ring (the slot engine's windowed caches are "
                    "band-masked, as the flax module's per_row_index)")
            _write_slot_pos(cache, index, s)
            slot_pos = cache.slot_pos
        return x, layers, slot_pos


def next_token_loss_fn(loss):
    """Shift-by-one LM objective over a fused per-example loss:
    logits [B, S, V] + tokens [B, S] -> scalar. ``logits[:, :-1]``
    cannot merge into [B*(S-1), V] as a view, so the reshape copies it,
    as the JAX function's reshape does before XLA fuses it.

    A context rank's logits cover its slice of the sequence, and its
    ``tokens`` are that slice plus the next rank's first token (the
    label of the slice's last position), so every logit has a label;
    the last rank's slice has none past its end and drops its last
    logit, as the whole sequence does. The loss is then the mean over
    the slice's positions (the Trainer weighs it by their share)."""

    def loss_fn(logits, tokens):
        v = logits.shape[-1]
        n = min(logits.shape[1], tokens.shape[1] - 1)
        return loss(logits[:, :n].reshape(-1, v),
                    tokens[:, 1:n + 1].reshape(-1))

    return loss_fn

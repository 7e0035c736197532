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
is the shift-by-one objective.

Decode mode keeps a dense KV cache per layer, passed explicitly
(``init_cache``) instead of living in a flax variable collection:

- a scalar ``index`` with a multi-token chunk is the one-shot prefill
  into an empty cache: K/V land at [0, P) and attention runs the flash
  kernel on the raw chunk;
- otherwise (single-token steps, or a [B] vector of per-row positions
  for the slot engine) each row writes its K/V at its own position and
  attends the cache through the grouped product with the mask
  k_pos <= q_pos, f32 scores and softmax, probabilities cast to the
  compute dtype before the product with V.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from ..utils import not_ported

_LN_EPS = 1e-6  # flax nn.LayerNorm's default (torch's is 1e-5)


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


class CausalSelfAttention(nn.Module):
    """Pre-norm causal attention residual, [B, S, E] in/out."""

    def __init__(self, embed_dim, num_heads, num_kv_heads=None,
                 rope=False, dtype=torch.bfloat16, device=None,
                 param_dtype=torch.float32, attention_fn=None):
        super().__init__()
        kv = num_kv_heads or num_heads
        if num_heads % kv:
            raise ValueError(
                f"num_kv_heads {kv} must divide num_heads {num_heads}")
        self.num_heads, self.num_kv_heads = num_heads, kv
        self.head_dim = embed_dim // num_heads
        self.rope = rope
        self.attention_fn = attention_fn or flash_attention
        d = self.head_dim
        dd = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.ln = LayerNorm(embed_dim, dtype, device)
        if kv == num_heads:
            self.qkv = Linear(embed_dim, 3 * num_heads * d, **dd)
        else:
            self.q = Linear(embed_dim, num_heads * d, **dd)
            self.kv = Linear(embed_dim, 2 * kv * d, **dd)
        self.proj = Linear(embed_dim, embed_dim, **dd)

    def _project(self, h):
        b, s, _ = h.shape
        heads, kv, d = self.num_heads, self.num_kv_heads, self.head_dim
        if kv == heads:
            qkv = self.qkv(h).view(b, s, 3, heads, d)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = self.q(h).view(b, s, heads, d)
        kv_out = self.kv(h).view(b, s, 2, kv, d)
        return q, kv_out[:, :, 0], kv_out[:, :, 1]

    def forward(self, x, cache=None, index=None):
        """``cache``: None (full causal forward) or this layer's
        (K, V) buffers [B, L, Hkv, D], updated in place; ``index``:
        the write offset, an int or a [B] tensor of per-row
        positions."""
        q, k, v = self._project(self.ln(x))
        heads = self.num_heads
        if cache is None:
            if self.rope:
                pos = torch.arange(q.shape[1], device=q.device)
                q, k = apply_rope(q, pos), apply_rope(k, pos)
            attn = self.attention_fn(q, _expand_kv(k, heads),
                                     _expand_kv(v, heads), causal=True)
        else:
            attn = self._cached_attention(q, k, v, cache, index)
        return x + self.proj(attn.reshape(x.shape))

    def _cached_attention(self, q, k, v, cache, index):
        cache_k, cache_v = cache
        b, q_len, heads, d = q.shape
        length = cache_k.shape[1]
        steps = torch.arange(q_len, device=q.device)
        if isinstance(index, int):
            if q_len > 1 and index != 0:
                raise not_ported("chunk_attends_cache=True")
            if index + q_len > length:
                raise ValueError(
                    f"chunk at {index}..{index + q_len} overruns the "
                    f"{length}-position cache")
            pos = (index + steps).expand(b, q_len)
        else:
            if q_len != 1:
                raise not_ported(
                    f"per-row multi-token chunks ({q_len} tokens)")
            pos = index[:, None]                               # [B, 1]
        if self.rope:
            q, k = apply_rope(q, pos), apply_rope(k, pos)
        # In-place cache writes. Per-row positions must lie inside the
        # buffer: the slot engine clamps free rows to slot_len - 1.
        if isinstance(index, int):
            cache_k[:, index:index + q_len] = k
            cache_v[:, index:index + q_len] = v
        else:
            rows = torch.arange(b, device=q.device)
            cache_k[rows, index] = k[:, 0]
            cache_v[rows, index] = v[:, 0]
        if isinstance(index, int) and q_len > 1:
            # One-shot prefill into an empty cache: causal attention
            # among the chunk's own tokens, on the flash kernel.
            return flash_attention(q, _expand_kv(k, heads),
                                   _expand_kv(v, heads), causal=True)
        # Grouped form: queries [B, Hkv, G*Q, D] attend their KV head
        # directly, with no repeated copy of the cache.
        kv_heads = cache_k.shape[2]
        g = heads // kv_heads
        dt = q.dtype
        qg = q.reshape(b, q_len, kv_heads, g, d).permute(0, 2, 3, 1, 4)
        qg = qg.reshape(b, kv_heads, g * q_len, d)
        keys = cache_k.to(dt).permute(0, 2, 3, 1)              # [B,Hkv,D,L]
        scores = torch.matmul(qg.float(), keys.float()) / math.sqrt(d)
        scores = scores.view(b, kv_heads, g, q_len, -1)
        k_pos = torch.arange(cache_k.shape[1], device=q.device)
        keep = k_pos[None, None, :] <= pos[:, :, None]          # [B,Q,L]
        scores = torch.where(keep[:, None, None], scores,
                             torch.full_like(scores, -1e9))
        probs = torch.softmax(scores, dim=-1).to(dt)
        probs = probs.view(b, kv_heads, g * q_len, -1)
        out = torch.matmul(probs, cache_v.to(dt).transpose(1, 2))
        out = out.view(b, kv_heads, g, q_len, d).permute(0, 3, 1, 2, 4)
        return out.reshape(b, q_len, heads, d)


class Block(nn.Module):
    """Pre-norm attention + MLP residual block, [B, S, E] in/out."""

    def __init__(self, embed_dim, num_heads, mlp_ratio=4,
                 num_kv_heads=None, rope=False, dtype=torch.bfloat16,
                 device=None, param_dtype=torch.float32,
                 attention_fn=None):
        super().__init__()
        self.attn = CausalSelfAttention(embed_dim, num_heads,
                                        num_kv_heads, rope, dtype, device,
                                        param_dtype, attention_fn)
        self.ln = LayerNorm(embed_dim, dtype, device)
        dd = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.mlp_in = Linear(embed_dim, mlp_ratio * embed_dim, **dd)
        self.mlp_out = Linear(mlp_ratio * embed_dim, embed_dim, **dd)

    def forward(self, x, cache=None, index=None):
        x = self.attn(x, cache, index)
        h = F.gelu(self.mlp_in(self.ln(x)), approximate="tanh")
        return x + self.mlp_out(h)


class TransformerLM(nn.Module):
    """Causal LM. Input [B, S] int tokens -> [B, S, V] f32 logits.

    ``attention_fn(q, k, v, causal=True)`` replaces the flash attention
    of the full causal forward (None: ``flash_attention``), as the flax
    module's argument does. ``param_dtype`` is the type the parameters
    are held in (module docstring). Options of the flax module that
    this port does not carry yet (int8/int4 KV cache, sliding window,
    paged KV, int8 weights, speculative-verify chunks, ring slack)
    raise ValueError."""

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
        for option, value, default in (
                ("kv_cache_dtype", kv_cache_dtype, None),
                ("attention_window", attention_window, 0),
                ("weights", weights, "native"),
                ("chunk_attends_cache", chunk_attends_cache, False),
                ("ring_slack", ring_slack, 0),
                ("kv_pages", kv_pages, None)):
            if value != default:
                raise not_ported(f"{option}={value!r}")
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.num_layers, self.num_heads = num_layers, num_heads
        self.num_kv_heads = num_kv_heads
        self.max_seq_len, self.mlp_ratio = max_seq_len, mlp_ratio
        self.pos_embedding, self.dtype = pos_embedding, dtype
        dd = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.tok_embed = Embedding(vocab_size, embed_dim, **dd)
        if pos_embedding == "learned":
            self.pos_embed = Embedding(max_seq_len, embed_dim, **dd)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, num_kv_heads,
                  pos_embedding == "rope", dtype, device, param_dtype,
                  attention_fn)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(embed_dim, dtype, device)
        self.lm_head = nn.Linear(embed_dim, vocab_size, device=device)

    @property
    def device(self):
        return self.tok_embed.weight.device

    def init_cache(self, batch, length):
        """Per-layer dense (K, V) buffers [batch, length, Hkv, D] in
        the compute dtype, zero-filled."""
        kv = self.num_kv_heads or self.num_heads
        shape = (batch, length, kv, self.embed_dim // self.num_heads)
        return [tuple(torch.zeros(shape, dtype=self.dtype,
                                  device=self.device) for _ in range(2))
                for _ in range(self.num_layers)]

    def forward(self, tokens, cache=None, index=None):
        """``cache``/``index`` as in CausalSelfAttention.forward: None
        for a full causal forward, or the decode-mode cache and the
        write offset (int, or [B] per-row positions)."""
        s = tokens.shape[1]
        if s > self.max_seq_len:
            raise ValueError(
                f"sequence length {s} exceeds max_seq_len "
                f"{self.max_seq_len}")
        x = self.tok_embed(tokens)
        if self.pos_embedding == "learned":
            steps = torch.arange(s, device=tokens.device)
            if cache is None:
                pos = steps
            elif isinstance(index, int):
                pos = index + steps
            else:
                pos = index[:, None] + steps[None, :]
            x = x + self.pos_embed(pos)
        layers = cache if cache is not None else [None] * self.num_layers
        for block, layer_cache in zip(self.blocks, layers):
            x = block(x, layer_cache, index)
        return self.lm_head(self.ln_f(x).float())


def next_token_loss_fn(loss):
    """Shift-by-one LM objective over a fused per-example loss:
    logits [B, S, V] + tokens [B, S] -> scalar. ``logits[:, :-1]``
    cannot merge into [B*(S-1), V] as a view, so the reshape copies it,
    as the JAX function's reshape does before XLA fuses it."""

    def loss_fn(logits, tokens):
        v = logits.shape[-1]
        return loss(logits[:, :-1].reshape(-1, v),
                    tokens[:, 1:].reshape(-1))

    return loss_fn

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

"""Mixture-of-Experts transformer LM (counterpart of the flax
MoETransformerLM).

The dense LM of ``transformer.py`` with GShard's top-k routed expert
MLP on the odd layers (``MoEBlock``); the even layers are the dense
``Block``. The forward returns ``(logits, aux)``: aux is the mean
router load-balance loss over the routed layers (0 without one), and
``with_router_loss`` folds it into an LM loss. The decode paths read
the logits through ``decode.logits_of``, as the JAX package's
``_logits_of``.

Routing (``parallel/expert.py``) groups every token of one forward
call, padding included: with a dropping capacity (capacity_factor *
top_k < num_experts) a token's output depends on the other tokens of
its call, so the callers (the slot engine, decode(), speculation) feed
exactly the calls the JAX package makes. Speculation refuses a
dropping model.

Everything else is the dense LM's: constructor options, caches
(``init_cache``/``init_paged_cache``), ``forward``'s arguments,
``weights="int8"`` (attention and the dense MLPs; the expert kernels
stay native, as in the flax module). The expert parameters keep the
flax layout: ``moe.gate`` [d, E] (always f32, as the flax param is and
the gate product needs), ``moe.w_in`` [E, d, f] and ``moe.w_out`` [E,
f, d] in ``param_dtype``, cast to the compute dtype at the call.
"""

import torch
from torch import nn

from ..parallel import expert
from .transformer import (
    Block,
    CausalSelfAttention,
    LayerNorm,
    TransformerLM,
)


class MoEMlp(nn.Module):
    """Top-k routed expert MLP, [B, S, d] in/out, plus the aux loss.
    ``moe_fn`` is ``expert.dense_moe``; a check may set an instance's
    to ``expert.dense_moe_reference`` (the same signature).

    ``mesh`` (a mesh with an "expert" axis, as the flax module's) runs
    the layer through ``expert.residual_moe`` on this rank's block of
    the residual stream (rows over "data", positions over "context"):
    the layer's ``w_in``/``w_out`` are then this rank's E/P experts
    once the Trainer's layout has sliced them (or whole, each rank
    taking its slice at use). ``token_mesh`` (set by
    the Trainer's layout on a mesh whose tokens are split over "data"
    or "context") routes the global batch
    (``expert.global_batch_moe``)."""

    moe_fn = staticmethod(expert.dense_moe)

    def __init__(self, embed_dim, num_experts, mlp_ratio=4, top_k=2,
                 capacity_factor=1.25, dtype=torch.bfloat16, device=None,
                 param_dtype=torch.float32, mesh=None):
        super().__init__()
        f = mlp_ratio * embed_dim
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.compute_dtype = dtype
        self.mesh = mesh
        self.token_mesh = None
        self.gate = nn.Parameter(torch.zeros(
            (embed_dim, num_experts), dtype=torch.float32, device=device))
        self.w_in = nn.Parameter(torch.zeros(
            (num_experts, embed_dim, f), dtype=param_dtype, device=device))
        self.w_out = nn.Parameter(torch.zeros(
            (num_experts, f, embed_dim), dtype=param_dtype, device=device))

    def forward(self, x):
        dt = self.compute_dtype
        kwargs = dict(capacity_factor=self.capacity_factor,
                      top_k=self.top_k)
        tokens = x.reshape(-1, x.shape[-1]).to(dt)
        w_in, w_out = self.w_in.to(dt), self.w_out.to(dt)
        if self.mesh is not None:
            out, aux = expert.residual_moe(self.mesh, x.to(dt), self.gate,
                                           w_in, w_out, **kwargs)
        elif self.token_mesh is not None:
            out, aux = expert.global_batch_moe(
                self.token_mesh, x.to(dt), self.gate, w_in, w_out,
                **kwargs)
        else:
            out, aux = self.moe_fn(tokens, self.gate, w_in, w_out,
                                   **kwargs)
        return out.reshape(x.shape), aux


class MoEBlock(nn.Module):
    """Pre-norm attention + routed-MLP residual block: [B, S, d] ->
    ([B, S, d], aux)."""

    def __init__(self, embed_dim, num_heads, num_experts, mlp_ratio=4,
                 top_k=2, capacity_factor=1.25, num_kv_heads=None,
                 rope=False, dtype=torch.bfloat16, device=None,
                 param_dtype=torch.float32, attention_fn=None,
                 weights="native", window=0, mesh=None):
        super().__init__()
        self.attn = CausalSelfAttention(embed_dim, num_heads,
                                        num_kv_heads, rope, dtype, device,
                                        param_dtype, attention_fn, weights,
                                        window)
        self.ln = LayerNorm(embed_dim, dtype, device)
        self.moe = MoEMlp(embed_dim, num_experts, mlp_ratio, top_k,
                          capacity_factor, dtype, device, param_dtype, mesh)

    def forward(self, x, cache=None, index=None, block_table=None,
                chunk_attends_cache=False, slot_pos=None):
        x = self.attn(x, cache, index, block_table, chunk_attends_cache,
                      slot_pos)
        h, aux = self.moe(self.ln(x))
        return x + h, aux


class MoETransformerLM(TransformerLM):
    """Causal MoE LM: [B, S] tokens -> ([B, S, V] f32 logits, aux f32).

    Odd layers are routed (GShard's every-other placement) over
    ``num_experts`` experts, ``top_k`` choices a token and
    ``capacity_factor``; ``mesh`` (one with an "expert" axis) makes the
    routed layers expert-parallel, as the flax module's argument does
    (``bind_mesh`` sets it on a built model); every other option and
    ``forward`` argument is ``TransformerLM``'s."""

    def __init__(self, vocab_size=32000, embed_dim=512, num_layers=8,
                 num_heads=8, num_experts=8, max_seq_len=2048, mlp_ratio=4,
                 top_k=2, capacity_factor=1.25, dtype=torch.bfloat16,
                 num_kv_heads=None, pos_embedding="learned",
                 kv_cache_dtype=None, attention_window=0,
                 weights="native", chunk_attends_cache=False, ring_slack=0,
                 kv_pages=None, device="cuda", param_dtype=torch.float32,
                 attention_fn=None, mesh=None):
        # The dense LM without blocks; the stack is built below, in the
        # place the dense one holds in the module tree.
        super().__init__(vocab_size, embed_dim, 0, num_heads, max_seq_len,
                         mlp_ratio, dtype, num_kv_heads, pos_embedding,
                         kv_cache_dtype, attention_window, weights,
                         chunk_attends_cache, ring_slack, kv_pages, device,
                         param_dtype, attention_fn)
        self.num_layers = num_layers
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        common = dict(num_kv_heads=num_kv_heads,
                      rope=pos_embedding == "rope", dtype=dtype,
                      device=device, param_dtype=param_dtype,
                      attention_fn=attention_fn, weights=weights,
                      window=self.attention_window)
        self.blocks = nn.ModuleList(
            MoEBlock(embed_dim, num_heads, num_experts, mlp_ratio, top_k,
                     capacity_factor, **common) if i % 2 == 1 else
            Block(embed_dim, num_heads, mlp_ratio, **common)
            for i in range(num_layers))
        self.bind_mesh(mesh)

    def bind_mesh(self, mesh):
        """Route every MoE layer expert-parallel over ``mesh``'s
        "expert" axis (None: on one device)."""
        self.mesh = mesh
        for block in self.blocks:
            if isinstance(block, MoEBlock):
                block.moe.mesh = mesh
        return self

    def forward(self, tokens, cache=None, index=None, block_table=None,
                chunk_attends_cache=False):
        """``TransformerLM.forward``'s arguments; returns (logits,
        aux)."""
        if cache is None:
            index = self.seq_offset
        x, layers, slot_pos = self._embed(tokens, cache, index)
        aux_losses = []
        for block, layer_cache in zip(self.blocks, layers):
            out = block(x, layer_cache, index, block_table,
                        chunk_attends_cache, slot_pos)
            if isinstance(block, MoEBlock):
                x, aux = out
                aux_losses.append(aux)
            else:
                x = out
        aux = (sum(aux_losses) / len(aux_losses) if aux_losses else
               torch.zeros((), dtype=torch.float32, device=x.device))
        return self._head(x), aux


def with_router_loss(loss_fn, aux_weight=0.01):
    """Wrap a (logits, labels) loss to add the router aux loss of the
    model's (logits, aux) output."""

    def wrapped(outputs, labels):
        logits, aux = outputs
        return loss_fn(logits, labels) + aux_weight * aux

    return wrapped

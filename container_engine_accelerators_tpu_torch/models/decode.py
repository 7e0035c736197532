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

"""Autoregressive decoding: the single-request functions and the slot
engine.

Counterpart of container_engine_accelerators_tpu/models/decode.py:

- ``greedy_decode``: the single-request oracle. One-shot prefill of the
  prompt (the flash kernel on the raw chunk), then single-token steps,
  as ``decode()``'s greedy fast-prefill path.
- ``decode`` (sampling, EOS, ragged ``prompt_len``, logprobs,
  repetition penalty), ``prefill_prefix``/``decode_with_prefix``,
  ``stream_decode`` and ``beam_search``, on dense caches and on a
  sliding-window model's ring alike. Sampling draws Gumbel-max from an
  explicit ``torch.Generator`` (or injected uniforms): the JAX
  functions' distribution, not their threefry numbers.
- ``SlotDecodeEngine``: ``admit`` prefills a prompt into a free slot
  and returns the first token, ``step`` advances every slot one token
  with per-row sampling knobs, ``release`` frees a slot. Two pools, as
  in the JAX engine: the paged block pool (the default) with its
  content-keyed prefix index, copy-on-write forks of the partial
  boundary block and the host spill tier; and the dense slot pool
  (``CEA_TPU_PAGED_KV=0`` or ``paged=False``), whose admission
  prefill runs the flash kernel. Either pool holds its cache in the
  mode ``kv_quant`` / ``CEA_TPU_KV_QUANT`` asks for (bf16, int8, int4)
  with the model's weights as they are; a sliding-window model runs on
  full-length band-masked caches. With a draft model (``draft_model``,
  ``spec_k``) greedy rows speculate: the draft proposes k-1 tokens
  from its own cache (a dense slot row, or a block span of its own
  arena on the paged pool) and the target verifies them as one
  width-k chunk (the ``models/speculative.py`` machinery, per row).
  The engine calls ``utils.faults.fire`` where the JAX engine does (the
  admission prefills, the spill tier's rehydrate, the step after its
  host block upkeep), so a ``CEA_TPU_FAULT_PLAN`` fires at the same
  invocation of the same trace on both.

Every path takes the MoE family too, whose forward returns (logits,
aux) and is read through ``logits_of``. A dropping router makes a
token's output depend on the other tokens of its forward call, so each
call here holds exactly the tokens of the JAX call it mirrors: a step
feeds every slot (free rows' scratch tokens included), an admission its
whole bucket-padded chunk.

JAX's programs are pure; here the engine's cache is updated in place
(the dense admission prefill writes straight into its slot's row
instead of into a batch-1 cache that is then copied in, and the paged
pool's copy-on-write, insert and rehydrate are in-place scatters into
the arena). Sampling draws from one ``torch.Generator`` per row,
seeded from the request's ``seed``: the same distribution as the JAX
engine's threefry keys, not the same numbers.

The paged pool's bookkeeping (refcounts, free list, reservations, the
prefix index, the spill tier's LRU) is host Python, copied from the
JAX engine line for line: on the same script the port holds the same
block ids, tables, keys and counters as the JAX engine. The device
sees only block tables and index vectors; there is no fallback, so a
CUDA engine's arena never leaves the card except as the spill tier's
explicit host copies.
"""

import collections
import time

import numpy as np
import torch

from .. import obs
from ..analysis import tsan
from ..serving.affinity import KV_BLOCK_ENV, chain_digest
from ..utils import _env_flag, env_number, env_str, faults
from .transformer import map_cache

PAGED_KV_ENV = "CEA_TPU_PAGED_KV"
KV_BLOCKS_ENV = "CEA_TPU_KV_BLOCKS"
KV_QUANT_ENV = "CEA_TPU_KV_QUANT"
KV_SPILL_ENV = "CEA_TPU_KV_SPILL"
KV_SPILL_BYTES_ENV = "CEA_TPU_KV_SPILL_BYTES"
SPEC_KV_BLOCKS_ENV = "CEA_TPU_SPEC_KV_BLOCKS"

# Host spill tier's default byte budget (256 MiB): the LRU evicts past
# it, and an evicted prefix is a true miss that re-prefills.
DEFAULT_SPILL_BYTES = 256 * 1024 * 1024


def paged_kv_enabled(default=True):
    """CEA_TPU_PAGED_KV gate: unset/empty -> ``default`` (the paged
    pool); 0/false/off/no -> the dense pool."""
    return _env_flag(PAGED_KV_ENV, default)


def kv_quant_mode(explicit=None):
    """The engine's KV-cache mode: the explicit kwarg, else
    ``CEA_TPU_KV_QUANT``, else "bf16" (the model's compute dtype)."""
    mode = explicit if explicit is not None else env_str(KV_QUANT_ENV)
    mode = (str(mode).strip().lower() or "bf16") if mode else "bf16"
    if mode not in ("bf16", "int8", "int4"):
        raise ValueError(
            f"{KV_QUANT_ENV} must be one of bf16|int8|int4: {mode!r}")
    return mode


def kv_spill_enabled(default=True):
    """CEA_TPU_KV_SPILL gate: unset/empty -> ``default`` (spill on for
    paged pools); 0/false/off/no -> evicted cold blocks are recycled
    (re-prefill on the next miss)."""
    return _env_flag(KV_SPILL_ENV, default)


def _model_quant_mode(model):
    """The cache-dtype mode a model serves ("bf16" = its compute
    dtype)."""
    native = getattr(model, "kv_cache_dtype", None)
    if native in ("int8", "int4"):
        return native
    return "bf16"


def kv_token_bytes(model, mode="bf16"):
    """Per-token per-layer KV-cache bytes (K + V, per-(token, head) f32
    scales included) for one cache mode: the basis of the paged arena's
    equal-memory sizing. ``mode="bf16"`` means the model's own mode."""
    heads = int(model.num_heads)
    kv_heads = int(getattr(model, "num_kv_heads", None) or heads)
    d = int(model.embed_dim) // heads
    if mode == "bf16":
        mode = _model_quant_mode(model)
    if mode == "int8":
        per_head = d + 4.0          # 1 byte/value + one f32 scale
    elif mode == "int4":
        per_head = d / 2 + 4.0      # packed value pairs + f32 scale
    else:
        per_head = float(d * model.dtype.itemsize)
    return 2.0 * kv_heads * per_head


def logits_of(outputs):
    """A forward's logits: the MoE family returns (logits, aux), the
    dense LM its logits (the JAX package's ``_logits_of``)."""
    return outputs[0] if isinstance(outputs, tuple) else outputs


# --------------------------------------------------------------------
# Sampling. Every knob is a per-row [B] tensor; masked tokens get -inf
# (a finite sentinel would flip sign under extreme temperatures).
# --------------------------------------------------------------------


def _apply_repetition_penalty(logits, seen, penalty):
    """CTRL-style penalty: logits of already-seen tokens divide by
    ``penalty`` when positive and multiply when negative. ``seen``:
    [B, V] bool; ``penalty``: [B] (1.0 is a no-op row)."""
    p = penalty.reshape(-1, 1)
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen, penalized, logits)


def _mask_top_k_rows(logits, top_k):
    """Per-row top-k with k a [B] int tensor (0 = off): full sort and
    a per-row gather of the k-th largest logit."""
    desc = torch.sort(logits, dim=-1, descending=True).values
    idx = torch.clamp(top_k - 1, 0, logits.shape[-1] - 1)[:, None]
    kth = torch.gather(desc, 1, idx)
    return torch.where((top_k[:, None] > 0) & (logits < kth),
                       float("-inf"), logits)


def _mask_top_p(logits, top_p):
    """Nucleus mask: keep the smallest prefix of the probability-
    sorted vocab whose mass reaches top_p ([B]; 1.0 is a no-op row)."""
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p.reshape(-1, 1)
    cutoff = torch.where(keep, desc, float("inf")).min(
        dim=-1, keepdim=True).values
    return torch.where(logits < cutoff, float("-inf"), logits)


def _mask_min_p(logits, min_p):
    """min-p filter: keep tokens whose probability is at least
    min_p * p_max ([B]; 0.0 is a no-op row, with a -inf cutoff so a
    zero row masks nothing)."""
    logp = torch.log_softmax(logits, dim=-1)
    mp = min_p.reshape(-1, 1)
    cutoff = torch.where(
        mp > 0,
        logp.max(dim=-1, keepdim=True).values
        + torch.log(torch.clamp(mp, min=1e-38)),
        float("-inf"))
    return torch.where(logp < cutoff, float("-inf"), logits)


def _gumbel_argmax(logits, uniforms):
    """Categorical draw by the Gumbel-max trick on given uniforms in
    [0, 1) (the draw jax.random.categorical makes, fed other bits)."""
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(uniforms, min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


class SamplingKnobs:
    """Per-row sampling knobs of a batch, on the host (numpy)."""

    def __init__(self, rows):
        self.temps = np.zeros((rows,), np.float32)
        self.top_ks = np.zeros((rows,), np.int64)
        self.top_ps = np.ones((rows,), np.float32)
        self.min_ps = np.zeros((rows,), np.float32)
        self.rep_pens = np.ones((rows,), np.float32)

    def set(self, row, temperature=0.0, top_k=0, top_p=1.0, min_p=0.0,
            repetition_penalty=1.0):
        self.temps[row] = temperature
        self.top_ks[row] = top_k
        self.top_ps[row] = top_p
        self.min_ps[row] = min_p
        self.rep_pens[row] = repetition_penalty

    def reset(self, row):
        self.set(row)


def _slot_sample(raw, seen, knobs, generators):
    """The engine's per-row sampling chain: repetition penalty on the
    raw logits, greedy rows (temperature 0) take the argmax of the
    penalised logits, sampling rows draw after temperature and the
    top_k -> top_p -> min_p masks from their own generator. The sort-
    bearing masks only run when some sampling row asks for them.
    Returns (token [B] int64, logprob [B] f32) where the logprob scores
    the chosen token under the RAW logits."""
    dev = raw.device
    logits = _apply_repetition_penalty(
        raw, seen, torch.as_tensor(knobs.rep_pens, device=dev))
    tok = torch.argmax(logits, dim=-1)
    rows = np.flatnonzero(knobs.temps > 0.0)
    if rows.size:
        sel = torch.as_tensor(rows, device=dev)
        temps = torch.as_tensor(knobs.temps[rows], device=dev)
        scaled = logits[sel] / torch.clamp(temps, min=1e-6)[:, None]
        if ((knobs.top_ks[rows] > 0) | (knobs.top_ps[rows] < 1.0)
                | (knobs.min_ps[rows] > 0.0)).any():
            scaled = _mask_top_k_rows(
                scaled, torch.as_tensor(knobs.top_ks[rows], device=dev))
            scaled = _mask_top_p(
                scaled, torch.as_tensor(knobs.top_ps[rows], device=dev))
            scaled = _mask_min_p(
                scaled, torch.as_tensor(knobs.min_ps[rows], device=dev))
        uniforms = torch.stack([
            torch.rand(scaled.shape[-1], generator=generators[r],
                       device=dev) for r in rows])
        tok = tok.index_put((sel,), _gumbel_argmax(scaled, uniforms))
    lsm = torch.log_softmax(raw.float(), dim=-1)
    lp = torch.gather(lsm, 1, tok[:, None])[:, 0]
    return tok, lp


# --------------------------------------------------------------------
# The single-request oracle.
# --------------------------------------------------------------------


@torch.inference_mode()
def greedy_decode(model, prompt, max_new_tokens, kv_quant=None):
    """Greedy generation of ``max_new_tokens`` after ``prompt``
    ([B, P] ints). Returns the [B, P + max_new_tokens] int64 sequence
    (prompt included) on the model's device: one forward pass fills
    the cache with the whole prompt, then one step per new token. The
    cache is in the model's kv_cache_dtype, or in ``kv_quant`` ("bf16",
    "int8", "int4") as decode() on a ``kv_cache_dtype`` clone."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, p = prompt.shape
    if max_new_tokens <= 0:
        return prompt.clone()
    cache = model.init_cache(b, p + max_new_tokens, quant=kv_quant)
    logits = logits_of(model(prompt, cache, 0))
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [prompt, tok[:, None]]
    for t in range(p, p + max_new_tokens - 1):
        logits = logits_of(model(tok[:, None], cache, t))
        tok = torch.argmax(logits[:, 0], dim=-1)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


# --------------------------------------------------------------------
# Single-request decoding: decode(), prefill_prefix/decode_with_prefix,
# stream_decode and beam_search. Python loops over the model's steps
# where the JAX functions scan; the caches are updated in place.
# --------------------------------------------------------------------


def _sampling_flags(temperature, top_k, top_p, min_p):
    """Host-side validation shared by every sampling entry point.
    Returns (sample, top_k, use_top_p, use_min_p)."""
    t_host = np.asarray(temperature, np.float32)
    if (t_host < 0.0).any():
        raise ValueError(f"temperature must be >= 0: {temperature}")
    if t_host.ndim == 0:
        sample = bool(t_host > 0.0)
    elif (t_host > 0.0).all():
        sample = True
    elif (t_host == 0.0).all():
        sample = False
    else:
        raise ValueError(
            "per-row temperatures must be all zero (greedy) or all "
            "positive (sampling); greedy and sampling rows compile "
            "to different programs")
    top_k = int(top_k)
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0: {top_k}")
    p_host = np.asarray(top_p, np.float32)
    if (p_host <= 0.0).any() or (p_host > 1.0).any():
        raise ValueError("top_p entries must be in (0, 1]")
    mp_host = np.asarray(min_p, np.float32)
    if (mp_host < 0.0).any() or (mp_host >= 1.0).any():
        raise ValueError("min_p entries must be in [0, 1)")
    return (sample, top_k, bool((p_host < 1.0).any()),
            bool((mp_host > 0.0).any()))


def _pick_token(logits, draw, temperature, top_p, min_p, *, sample,
                top_k, use_top_p, use_min_p):
    """The sampling chain of the single-request paths: temperature
    (a scalar or [B] tensor), then top_k -> top_p -> min_p, then the
    Gumbel-max draw on ``draw(shape)``'s uniforms; argmax when
    greedy."""
    if not sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature.reshape(-1, 1)
    if top_k:
        logits = _mask_top_k_rows(logits, torch.full(
            logits.shape[:1], top_k, device=logits.device))
    if use_top_p:
        logits = _mask_top_p(logits, top_p)
    if use_min_p:
        logits = _mask_min_p(logits, min_p)
    return _gumbel_argmax(logits, draw(tuple(logits.shape)))


def _uniform_source(generator, uniforms, device):
    """``draw(shape)``: uniforms in [0, 1) from ``generator`` (a
    torch.Generator on ``device``; seed 0 when None), or from the
    ``uniforms(shape)`` callable when given (the JAX chain's own
    uniforms, to hold the draws to it)."""
    if uniforms is not None:
        return lambda shape: torch.tensor(
            np.asarray(uniforms(shape)), dtype=torch.float32, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return lambda shape: torch.rand(shape, generator=generator,
                                    device=device)


def _advance_token(sampled, padded, t, prompt_len, done, eos_row):
    """Prompt takeover + EOS freeze (JAX ``_advance_token``): inside
    the prompt the actual prompt token is fed, and a row whose
    generated text reached its EOS keeps emitting it (prompt-resident
    EOS ids don't trigger). Returns (next_token, done)."""
    forced = padded[:, min(t + 1, padded.shape[1] - 1)]
    in_prompt = t + 1 < prompt_len
    nxt = torch.where(in_prompt, forced, sampled)
    if eos_row is not None:
        nxt = torch.where(done, eos_row, nxt)
        done = done | (~in_prompt & (nxt == eos_row))
    return nxt, done


def _token_logprob(raw, tok):
    """log P(tok) under the RAW logits [B, V] (the scoring quantity)."""
    lsm = torch.log_softmax(raw.float(), dim=-1)
    return torch.gather(lsm, 1, tok[:, None])[:, 0]


class _Chain:
    """One request batch's per-step knobs on the device: the sampling
    chain, EOS and the repetition penalty's seen-token rows."""

    def __init__(self, model, b, temperature, top_k, top_p, min_p,
                 eos_id, repetition_penalty, generator, uniforms):
        dev = model.device
        (self.sample, self.top_k, self.use_top_p,
         self.use_min_p) = _sampling_flags(temperature, top_k, top_p, min_p)
        rp_host = np.asarray(repetition_penalty, np.float32)
        if (rp_host <= 0.0).any():
            raise ValueError("repetition_penalty entries must be > 0")
        self.use_rp = bool((rp_host != 1.0).any())

        def knob(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        self.temps, self.top_p, self.min_p = (
            knob(temperature), knob(top_p), knob(min_p))
        self.rep_pen = knob(repetition_penalty)
        self.eos_row = (None if eos_id is None else torch.as_tensor(
            np.asarray(eos_id, np.int64), device=dev).reshape(-1))
        self.rows = torch.arange(b, device=dev)
        self.seen = (torch.zeros((b, model.vocab_size), dtype=torch.bool,
                                 device=dev) if self.use_rp else None)
        self.draw = _uniform_source(generator, uniforms, dev)

    def mark(self, tok):
        if self.use_rp:
            self.seen[self.rows, tok] = True

    def pick(self, logits):
        if self.use_rp:
            # On raw logits, before temperature and filters (CTRL).
            logits = _apply_repetition_penalty(logits, self.seen,
                                               self.rep_pen)
        return _pick_token(logits, self.draw, self.temps, self.top_p,
                           self.min_p, sample=self.sample, top_k=self.top_k,
                           use_top_p=self.use_top_p,
                           use_min_p=self.use_min_p)

    def first_done(self, first):
        if self.eos_row is None:
            return torch.zeros_like(first, dtype=torch.bool)
        return first == self.eos_row


def _generate(model, cache, offset, prompt, prompt_len, max_new_tokens,
              chain, fast_prefill, logprobs, attend_cache):
    """The loop behind ``decode`` and ``decode_with_prefix``: the
    [B, P] ``prompt`` continues a cache holding ``offset`` tokens.
    Fast prefill runs the prompt as ONE chunk (the one-shot prefill
    into an empty cache, or with ``attend_cache`` a chunk attending
    the cache), then one step a new token; stepwise feeds every position, the prompt's own tokens
    taking over the prediction inside the prompt. Returns the
    [B, P + max_new_tokens] sequence, and with ``logprobs`` the
    [B, P + max_new_tokens] f32 logprobs (entry 0 = 0.0; prompt
    positions score the prompt)."""
    b, p_pad = prompt.shape
    total = p_pad + max_new_tokens
    padded = torch.nn.functional.pad(prompt, (0, max_new_tokens))
    plen = torch.as_tensor(np.asarray(prompt_len, np.int64),
                           device=prompt.device).reshape(-1)
    toks, lps = [], []

    def step(tok, t, done):
        raw = logits_of(model(tok[:, None], cache, offset + t))[:, 0]
        nxt, done = _advance_token(chain.pick(raw), padded, t, plen, done,
                                   chain.eos_row)
        if logprobs:
            lps.append(_token_logprob(raw, nxt))
        chain.mark(nxt)
        toks.append(nxt)
        return nxt, done

    if fast_prefill and max_new_tokens > 0:
        if chain.use_rp:
            chain.seen[chain.rows[:, None], prompt] = True
        pre = logits_of(model(prompt, cache, offset,
                              chunk_attends_cache=attend_cache))
        first = chain.pick(pre[:, -1])
        done = chain.first_done(first)
        chain.mark(first)
        tok = first
        for t in range(p_pad, total - 1):
            tok, done = step(tok, t, done)
        seq = torch.cat([prompt, first[:, None]] + [x[:, None] for x in toks],
                        dim=1)
        if not logprobs:
            return seq
        pl = pre[:, :-1].float()
        chosen = torch.gather(pl, 2, prompt[:, 1:, None])[..., 0]
        plp = chosen - torch.logsumexp(pl, dim=-1)
        first_lp = _token_logprob(pre[:, -1], first)
        return seq, torch.cat(
            [torch.zeros((b, 1), device=prompt.device), plp,
             first_lp[:, None]] + [x[:, None] for x in lps], dim=1)
    tok = prompt[:, 0]
    chain.mark(tok)
    done = torch.zeros((b,), dtype=torch.bool, device=prompt.device)
    for t in range(total - 1):
        tok, done = step(tok, t, done)
    seq = torch.cat([prompt[:, :1]] + [x[:, None] for x in toks], dim=1)
    if not logprobs:
        return seq
    return seq, torch.cat([torch.zeros((b, 1), device=prompt.device)]
                          + [x[:, None] for x in lps], dim=1)


@torch.inference_mode()
def decode(model, prompt, max_new_tokens, *, temperature=0.0,
           generator=None, prompt_len=None, fast_prefill=None, top_k=0,
           top_p=1.0, eos_id=None, repetition_penalty=1.0, min_p=0.0,
           return_logprobs=False, uniforms=None):
    """Generate ``max_new_tokens`` after ``prompt`` ([B, P] ints), as
    the JAX ``decode()``. Returns the [B, P + max_new_tokens] int64
    sequence (prompt included) on the model's device, and with
    ``return_logprobs`` also the [B, P + max_new_tokens] f32
    log-probabilities under the RAW logits (entry 0 is 0.0; prompt
    positions are the prompt's echo logprobs).

    temperature 0 is greedy argmax; > 0 (a scalar, or a [B] vector of
    all-positive entries) samples after the ``top_k`` (int), ``top_p``
    and ``min_p`` (scalars or [B]) filters, drawing by Gumbel-max from
    ``generator`` (a torch.Generator on the model's device; seed 0
    when None) or from ``uniforms(shape)``: the same distribution as
    the JAX function's threefry draws, not its numbers.
    ``repetition_penalty`` (scalar or [B], 1.0 = off) pushes the row's
    seen tokens away before temperature and filters. ``eos_id``
    (scalar or [B]) freezes a row on its EOS once its generated text
    emits it. ``prompt_len`` (scalar or [B], default P) is where
    generation takes over from a right-padded prompt.

    The fast prefill (auto-chosen when every row is full width) runs
    the prompt as one forward: the flash kernel on the raw chunk, with
    the window on a sliding-window model, whose cache is a ring of
    min(P + max_new_tokens, window + ring_slack) slots; otherwise every
    position is one step."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, p_pad = prompt.shape
    if prompt_len is None:
        prompt_len = p_pad
    full_width = bool((np.asarray(prompt_len) == p_pad).all())
    if fast_prefill is None:
        fast_prefill = full_width
    elif fast_prefill and not full_width:
        raise ValueError(
            "fast_prefill=True requires every row's prompt_len to "
            "equal the prompt width (no right-padding)")
    chain = _Chain(model, b, temperature, top_k, top_p, min_p, eos_id,
                   repetition_penalty, generator, uniforms)
    cache = model.init_cache(b, p_pad + max_new_tokens)
    return _generate(model, cache, 0, prompt, prompt_len, max_new_tokens,
                     chain, fast_prefill, bool(return_logprobs), False)


@torch.inference_mode()
def prefill_prefix(model, prefix, *, max_total_len, chunk_slack=0):
    """Prefill a shared prefix ([Bp, P] ints, full width) ONCE into a
    cache sized for ``max_total_len`` tokens (a ring on a
    sliding-window model); returns the state (cache, P,
    max_total_len) that ``decode_with_prefix`` continues.
    ``chunk_slack`` (sliding-window models only): ring slots beyond
    the window, so a suffix of that width can prefill as one chunk."""
    prefix = torch.as_tensor(prefix, device=model.device).long()
    if prefix.shape[1] >= max_total_len:
        raise ValueError(
            f"max_total_len {max_total_len} leaves no room after the "
            f"{prefix.shape[1]}-token prefix")
    slack = None
    if chunk_slack:
        if int(chunk_slack) < 0:
            raise ValueError(f"chunk_slack must be >= 0: {chunk_slack}")
        if not model.attention_window:
            raise ValueError(
                "chunk_slack only applies to sliding-window models "
                "(dense caches already hold every position)")
        slack = int(chunk_slack)
    cache = model.init_cache(prefix.shape[0], int(max_total_len),
                             ring_slack=slack)
    model(prefix, cache, 0)
    return cache, prefix.shape[1], int(max_total_len)


def _ring_capacity(cache):
    """Slot count of the cache's first K buffer (None: no layer)."""
    return cache[0][0].shape[1] if len(cache) else None


def _continue(model, prefix_state, prompt, max_new_tokens, *, temperature,
              generator, prompt_len, top_k, top_p, min_p, eos_id,
              fast_prefill, return_state, uniforms, owned):
    """``decode_with_prefix``; ``owned``: the state's cache may be
    updated in place (``stream_decode``'s own), else it is copied."""
    cache, prefix_len, max_total_len = prefix_state
    prompt = torch.as_tensor(prompt, device=model.device).long()
    prefix_b = cache[0][0].shape[0]
    b, p_pad = prompt.shape
    if b % prefix_b != 0:
        raise ValueError(
            f"request batch {b} is not a multiple of the prefix "
            f"batch {prefix_b}")
    need = prefix_len + p_pad + max_new_tokens
    if need > max_total_len:
        raise ValueError(
            f"prefix state sized for {max_total_len} total tokens; "
            f"prefix {prefix_len} + prompt {p_pad} + "
            f"max_new_tokens {max_new_tokens} = {need} overflows it")
    if prompt_len is None:
        prompt_len = p_pad
    full_width = bool((np.asarray(prompt_len) == p_pad).all())
    # A windowed ring must hold the chunk AND each early query's
    # pre-chunk window: window + chunk width slots, or never wrap.
    window = model.attention_window
    can_chunk = True
    if window:
        capacity = _ring_capacity(cache)
        can_chunk = capacity is not None and (
            capacity >= window + p_pad or capacity >= max_total_len)
    if fast_prefill is None:
        fast_prefill = full_width and max_new_tokens > 0 and can_chunk
    elif fast_prefill and not (full_width and max_new_tokens > 0
                               and can_chunk):
        raise ValueError(
            "fast_prefill=True requires every row's prompt_len to "
            "equal the suffix width (no right-padding), "
            "max_new_tokens > 0, and a model with the "
            "chunk_attends_cache mid-cache chunk path (for "
            "sliding-window models the prefix state's ring must "
            "also hold window + suffix width slots; allocate it "
            "with prefill_prefix(chunk_slack=...))")
    chain = _Chain(model, b, temperature, top_k, top_p, min_p, eos_id,
                   1.0, generator, uniforms)
    fan_out = b // prefix_b
    # Request row bp * fan_out + j continues prefix row bp.
    if fan_out > 1:
        cache = map_cache(lambda a: a.repeat_interleave(fan_out, dim=0),
                          cache)
    elif not owned:
        cache = map_cache(torch.clone, cache)
    seq = _generate(model, cache, prefix_len, prompt, prompt_len,
                    max_new_tokens, chain, bool(fast_prefill), False, True)
    if not return_state:
        return seq
    # Tokens resident in the cache: the final sampled token is not yet
    # among them (the next call feeds it as its 1-token prompt).
    return seq, (cache, prefix_len + p_pad + max_new_tokens - 1,
                 max_total_len)


@torch.inference_mode()
def decode_with_prefix(model, prefix_state, prompt, max_new_tokens, *,
                       temperature=0.0, generator=None, prompt_len=None,
                       top_k=0, top_p=1.0, min_p=0.0, eos_id=None,
                       fast_prefill=None, return_state=False,
                       uniforms=None):
    """Continue generation from a ``prefill_prefix`` state, as the JAX
    function: ``prompt`` [B, P] holds each request's own tokens, B a
    multiple of the prefix batch Bp, and request row i continues prefix
    row i // (B / Bp). Returns the [B, P + max_new_tokens] suffix
    sequences (the prefix is not re-emitted). Knobs as ``decode``
    (no repetition penalty or logprobs: they need the prefix's tokens).
    The state is left as it was, so it serves many continuations.

    ``fast_prefill`` (None: auto) runs a full-width suffix as ONE chunk
    attending the cache; a sliding-window state needs a ring of window
    + suffix width slots (``prefill_prefix(chunk_slack=)``) or one that
    never wraps, else the suffix steps. ``return_state=True`` also
    returns the advanced state: the sequence's last token is not yet
    in the cache and is the next call's 1-token prompt."""
    return _continue(model, prefix_state, prompt, max_new_tokens,
                     temperature=temperature, generator=generator,
                     prompt_len=prompt_len, top_k=top_k, top_p=top_p,
                     min_p=min_p, eos_id=eos_id, fast_prefill=fast_prefill,
                     return_state=return_state, uniforms=uniforms,
                     owned=False)


@torch.inference_mode()
def stream_decode(model, prompt, max_new_tokens, *, chunk=16,
                  temperature=0.0, generator=None, top_k=0, top_p=1.0,
                  min_p=0.0, eos_id=None, uniforms=None):
    """Incremental generation, as the JAX function: yields [B, <=chunk]
    int64 numpy token blocks as they are produced. The full-width
    prompt prefills once (all but its last token, through
    ``prefill_prefix``); each chunk continues the state with
    ``decode_with_prefix(return_state=True)``. Greedy chunked output is
    ``decode``'s; sampling continues the one generator across chunks.
    ``eos_id`` freezes finished rows across chunk boundaries (host
    side) and stops early once every row finished."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, p = prompt.shape
    if max_new_tokens < 1:
        raise ValueError("stream_decode needs max_new_tokens >= 1")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1: {chunk}")
    total = p + max_new_tokens
    if p >= 2:
        state = prefill_prefix(model, prompt[:, :-1], max_total_len=total)
        feed = prompt[:, -1:]
    else:
        state = (model.init_cache(b, total), 0, total)
        feed = prompt
    if generator is None and uniforms is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    done = np.zeros((b,), bool)
    remaining = max_new_tokens
    while remaining > 0:
        n = min(chunk, remaining)
        seq, state = _continue(
            model, state, feed, n, temperature=temperature,
            generator=generator, prompt_len=None, top_k=top_k,
            top_p=top_p, min_p=min_p, eos_id=eos_id, fast_prefill=None,
            return_state=True, uniforms=uniforms, owned=True)
        block = seq[:, 1:].cpu().numpy().copy()
        feed = seq[:, -1:]
        remaining -= n
        if eos_id is not None:
            block[done] = int(eos_id)
            done |= (block == int(eos_id)).any(axis=1)
        yield block
        if eos_id is not None and bool(done.all()):
            return


@torch.inference_mode()
def beam_search(model, prompt, max_new_tokens, *, num_beams=4,
                eos_id=None, length_penalty=0.0):
    """Beam search, as the JAX function: the num_beams highest
    sum-logprob continuations per batch element. Returns (sequences
    [B, K, P + max_new_tokens] int64, scores [B, K] f32), best first;
    num_beams=1 is exactly greedy. The prompt prefills a [B]-row cache
    once (the flash kernel), the cache fans out to [B*K] beam rows,
    and each step takes the global top-K (beam, token) pairs (a stable
    descending sort: ties go to the lower index, as lax.top_k's) and
    gathers the cache rows (a ring's slot_pos too) onto the survivors.
    Beams beyond the distinct continuations come back at -inf with
    token 0. ``eos_id`` (scalar) freezes a finished beam's score (its
    only continuation is EOS at logprob 0); ``length_penalty`` (GNMT
    alpha, needs eos_id) ranks finished beams by score / ((5 + len) /
    6)^alpha, and the returned scores are then that quantity."""
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1: {num_beams}")
    if max_new_tokens < 1:
        raise ValueError("beam_search needs max_new_tokens >= 1")
    use_eos = eos_id is not None
    if use_eos:
        eos_host = np.asarray(eos_id)
        if eos_host.ndim != 0:
            raise ValueError(
                "beam_search eos_id must be a scalar (per-row EOS "
                "vectors are a decode()/stream_decode() feature)")
        if not 0 <= int(eos_host) < model.vocab_size:
            raise ValueError(
                f"eos_id must be in 0..{model.vocab_size - 1}: {eos_id}")
        eos_id = int(eos_host)
    use_lp = float(length_penalty) != 0.0
    if use_lp and not use_eos:
        raise ValueError(
            "length_penalty applies to finished beams and therefore "
            "requires eos_id")
    dev = model.device
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, p = prompt.shape
    k, n_new = int(num_beams), int(max_new_tokens)
    alpha = torch.tensor(float(length_penalty), dtype=torch.float32,
                         device=dev)
    cache = model.init_cache(b, p + n_new)
    logprobs = torch.log_softmax(
        logits_of(model(prompt, cache, 0))[:, -1].float(), -1)
    v = logprobs.shape[-1]
    # Beam rows of one batch element are adjacent (row b * k + j).
    cache = map_cache(lambda a: a.repeat_interleave(k, dim=0), cache)
    logprobs = logprobs.repeat_interleave(k, dim=0)
    # Only beam 0 is live at first, so the first expansion picks K
    # distinct tokens.
    scores = torch.full((b, k), float("-inf"), device=dev)
    scores[:, 0] = 0.0
    seqs = torch.zeros((b, k, n_new), dtype=torch.long, device=dev)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    gen_len = torch.zeros((b, k), dtype=torch.long, device=dev)
    base = torch.arange(b, device=dev)[:, None] * k
    if use_eos:
        frozen = torch.full((v,), float("-inf"), device=dev)
        frozen[eos_id] = 0.0

    def select(seqs, scores, finished, gen_len, logprobs, t):
        if use_eos:
            logprobs = torch.where(finished.reshape(b * k, 1), frozen[None],
                                   logprobs)
        totals = scores[:, :, None] + logprobs.reshape(b, k, v)
        eff = totals
        if use_lp:
            # A candidate ending in EOS competes penalized at its true
            # length (a live beam's finishes at gen_len + 1).
            fin_len = torch.where(finished, gen_len, gen_len + 1)
            eff = totals.clone()
            eff[:, :, eos_id] = totals[:, :, eos_id] / (
                (5.0 + fin_len.float()) / 6.0) ** alpha
        order = torch.sort(eff.reshape(b, k * v), dim=1, descending=True,
                           stable=True)
        eff_scores, idx = order.values[:, :k], order.indices[:, :k]
        new_scores = torch.gather(totals.reshape(b, k * v), 1, idx)
        parent = idx // v
        token = torch.where(torch.isfinite(eff_scores), idx % v,
                            torch.zeros_like(idx))
        seqs = torch.gather(seqs, 1, parent[..., None].expand_as(seqs))
        seqs[:, :, t] = token
        if use_eos:
            parent_fin = torch.gather(finished, 1, parent)
            # Generated length counts tokens through the first EOS.
            gen_len = (torch.gather(gen_len, 1, parent)
                       + (~parent_fin).long())
            finished = parent_fin | (token == eos_id)
        return (seqs, new_scores, finished, gen_len, token,
                (base + parent).reshape(-1), eff_scores)

    for t in range(n_new - 1):
        seqs, scores, finished, gen_len, token, flat_parent, _ = select(
            seqs, scores, finished, gen_len, logprobs, t)
        cache = map_cache(lambda a: a[flat_parent], cache)
        logits = logits_of(model(token.reshape(b * k, 1), cache, p + t))
        logprobs = torch.log_softmax(logits[:, 0].float(), dim=-1)
    seqs, scores, _, _, _, _, eff = select(seqs, scores, finished, gen_len,
                                           logprobs, n_new - 1)
    full = torch.cat([prompt[:, None].expand(b, k, p), seqs], dim=2)
    return full, (eff if use_lp else scores)


# --------------------------------------------------------------------
# The paged pool's host-side allocator.
# --------------------------------------------------------------------


class _BlockPool:
    """Host-side allocator for the paged KV arena.

    Blocks are refcounted: a row's table entry holds one reference;
    identical prompt prefixes share blocks by incref. Freed blocks
    (refcount 0) join the free list but keep their prefix-index keys
    until REUSED (lazy purge): a later admission with the same prefix
    revives the block instead of re-prefilling it, so sequential
    same-system-prompt traffic hits, not only overlapping rows.

    ``committed`` counts blocks reserved for admitted rows' worst-case
    remaining growth but not yet allocated: admission gates on free -
    committed, so a mid-generation block-boundary allocation never
    fails. Exhaustion queues an admission; it never corrupts a table.
    """

    def __init__(self, num_blocks, block_size):
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # The last block is the TRASH block: never allocated, the
        # gather/scatter target of every unallocated table entry and
        # every free row. Its junk is masked by the per-row horizon,
        # so a free row's write never touches a live block.
        self.trash = self.num_blocks - 1
        self.usable = self.num_blocks - 1
        self.ref = np.zeros((self.num_blocks,), np.int64)
        self._free_order = collections.deque(range(self.usable))
        self._free_set = set(range(self.usable))
        self._index = {}        # content key -> block id
        self._block_keys = {}   # block id -> [keys] (purged on reuse)
        self.committed = 0
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.shared_tokens = 0
        # Host spill tier (off until configure_spill): when a
        # registered free block is about to be reused, its contents
        # are copied to host memory under the same content keys; a
        # later admission whose chain misses the device index but hits
        # here rehydrates (upload + table splice) instead of
        # re-prefilling. LRU over entries, bounded by a byte budget.
        self.spill_bytes_limit = 0
        self._fetch_block = None
        self._spill_lru = collections.OrderedDict()   # seq -> entry
        self._spill_index = {}                        # key -> entry
        self._spill_seq = 0
        self.spill_bytes_used = 0
        self.spill_hits = 0
        self.spill_probes = 0
        self.spill_captures = 0
        self.spill_evictions = 0
        self.rehydrated_blocks = 0
        self.rehydrate_seconds_total = 0.0
        self._rehydrate_events = []

    def free_count(self):
        return len(self._free_set)

    def available(self):
        """Blocks an admission may claim without endangering any
        admitted row's reserved growth."""
        return self.free_count() - self.committed

    def shared_count(self):
        return int((self.ref > 1).sum())

    def _purge(self, bid):
        for key in self._block_keys.pop(bid, ()):
            if self._index.get(key) == bid:
                del self._index[key]

    def alloc(self):
        tsan.note_write("engine.block_pool", self)
        while self._free_order:
            bid = self._free_order.popleft()
            if bid in self._free_set:
                self._free_set.discard(bid)
                if self.spill_enabled() and self._block_keys.get(bid):
                    # The block's registered content is about to be
                    # destroyed: evict it to the host tier first.
                    self._spill_out(bid)
                self._purge(bid)  # content is about to be overwritten
                self.ref[bid] = 1
                return bid
        raise RuntimeError(
            "KV block pool exhausted: admission accounting should have "
            "queued this request (engine invariant violated)")

    def incref(self, bid):
        tsan.note_write("engine.block_pool", self)
        if self.ref[bid] == 0:
            # Revival: a free-listed block whose indexed content a new
            # admission matched goes back to resident, keys kept.
            self._free_set.discard(bid)
        self.ref[bid] += 1

    def decref(self, bid):
        tsan.note_write("engine.block_pool", self)
        self.ref[bid] -= 1
        if self.ref[bid] < 0:
            raise RuntimeError(f"KV block {bid} refcount underflow")
        if self.ref[bid] == 0:
            self._free_set.add(bid)
            self._free_order.append(bid)
            # Keys stay until reuse (lazy purge) for revival hits.

    # -- host spill tier ----------------------------------------------

    def configure_spill(self, bytes_limit, fetch_block):
        """Arm the spill tier: ``fetch_block(bid)`` returns the block's
        contents as a tuple of host tensors (the engine's device-to-host
        copy); ``bytes_limit`` bounds host residency (LRU past it)."""
        self.spill_bytes_limit = int(bytes_limit)
        self._fetch_block = fetch_block

    def spill_enabled(self):
        return self.spill_bytes_limit > 0 and self._fetch_block is not None

    def spill_block_count(self):
        return len(self._spill_lru)

    def _spill_out(self, bid):
        """Capture a registered block's contents into the host tier
        (called by ``alloc`` at the moment of reuse, so the LRU order is
        free-list order: coldness). Keys whose index pointer moved on to
        a newer block are skipped; if every key is already host-resident
        the capture is skipped (same chain key = same content)."""
        keys = [k for k in self._block_keys.get(bid, ())
                if self._index.get(k) == bid]
        if not keys:
            return
        fresh = [k for k in keys if k not in self._spill_index]
        if not fresh:
            for k in keys:
                self._spill_lru.move_to_end(self._spill_index[k]["seq"])
            return
        data = self._fetch_block(bid)
        entry = {"keys": keys, "data": data,
                 "nbytes": int(sum(a.numel() * a.element_size()
                                   for a in data))}
        self._spill_seq += 1
        entry["seq"] = self._spill_seq
        self._spill_lru[entry["seq"]] = entry
        displaced = {}
        for k in keys:
            old = self._spill_index.get(k)
            if old is not None:
                displaced[old["seq"]] = old
            self._spill_index[k] = entry
        self.spill_bytes_used += entry["nbytes"]
        self.spill_captures += 1
        # Drop entries this capture fully displaced: their bytes would
        # otherwise stay counted against the budget until LRU churn.
        for old in displaced.values():
            if not any(self._spill_index.get(k) is old
                       for k in old["keys"]):
                self._spill_lru.pop(old["seq"], None)
                self.spill_bytes_used -= old["nbytes"]
        self._spill_trim()

    def _spill_trim(self):
        while (self.spill_bytes_used > self.spill_bytes_limit
               and self._spill_lru):
            _, entry = self._spill_lru.popitem(last=False)
            for k in entry["keys"]:
                if self._spill_index.get(k) is entry:
                    del self._spill_index[k]
            self.spill_bytes_used -= entry["nbytes"]
            self.spill_evictions += 1

    def _spill_lookup(self, key, count):
        """Consult the host tier for a chain key that missed the device
        index (counted probes and hits feed the spill hit rate)."""
        if not self.spill_enabled():
            return None
        entry = self._spill_index.get(key)
        if count:
            self.spill_probes += 1
            if entry is not None:
                self.spill_hits += 1
        return entry

    def take_spill(self, key):
        """Host-tier content for ``key``, for the admitting engine to
        upload into a freshly allocated block. The entry stays resident
        (LRU-refreshed): the host copy keeps serving later admissions
        after the rehydrated device block is recycled again."""
        entry = self._spill_index[key]
        self._spill_lru.move_to_end(entry["seq"])
        return entry["data"]

    def note_rehydrate(self, blocks, seconds):
        self.rehydrated_blocks += int(blocks)
        self.rehydrate_seconds_total += float(seconds)
        self._rehydrate_events.append(float(seconds))

    def drain_rehydrate_events(self):
        """Rehydrate-latency samples since the last drain."""
        events, self._rehydrate_events = self._rehydrate_events, []
        return events

    # -- content-keyed prefix index -----------------------------------

    _chain = staticmethod(chain_digest)

    def lookup(self, tokens, count=True):
        """Longest indexed prefix of ``tokens`` usable for sharing,
        clipped to len(tokens) - 1 (at least one suffix token must
        remain to feed the admission prefill). Full blocks chain-hash
        block contents; the prompt-tail partial block matches via
        (chain, partial-tokens) keys and comes back as ``fork_src``: the
        new row writes inside that block's span, so it forks a copy
        instead of taking a reference (copy-on-write).

        Two-level: a chain key that misses the device index falls
        through to the host spill tier; such blocks come back as
        ("spill", key) sources the admitting engine rehydrates into
        fresh device blocks. Returns (shared_len, sources, fork_src)
        where sources is an in-order list of ("dev", block_id) /
        ("spill", key) and fork_src is None, ("dev", block_id), or
        ("spill", key)."""
        if count:
            self.prefix_lookups += 1
        bs = self.block_size
        limit = len(tokens) - 1
        chain = None
        sources = []
        i = 0
        while (i + 1) * bs <= limit:
            key = self._chain(chain, tuple(tokens[i * bs:(i + 1) * bs]))
            bid = self._index.get(key)
            if bid is not None:
                sources.append(("dev", bid))
            elif self._spill_lookup(key, count) is not None:
                sources.append(("spill", key))
            else:
                break
            chain = key
            i += 1
        shared = i * bs
        fork_src, best_q = None, 0
        for q in range(1, bs):
            if shared + q > limit:
                break
            pk = self._chain(
                chain, ("partial", tuple(tokens[shared:shared + q])))
            bid = self._index.get(pk)
            if bid is not None:
                fork_src, best_q = ("dev", bid), q
            elif self._spill_lookup(pk, count=False) is not None:
                fork_src, best_q = ("spill", pk), q
        shared += best_q
        if count:
            if shared:
                self.prefix_hits += 1
            self.shared_tokens += shared
            if fork_src is not None and fork_src[0] == "spill":
                # The partial scan probes every q; count the one match
                # so the hit rate stays per block, not per q.
                self.spill_probes += 1
                self.spill_hits += 1
        return shared, sources, fork_src

    def register(self, tokens, plen, block_of_index):
        """Index an admitted row's prompt blocks: one chain key per full
        prompt block (immutable: the row only writes at positions >=
        plen) plus partial keys for every prefix of the prompt-tail
        partial block. ``block_of_index``: logical block index ->
        physical block id for this row."""
        bs = self.block_size
        chain = None
        full = plen // bs
        for i in range(full):
            key = self._chain(chain, tuple(tokens[i * bs:(i + 1) * bs]))
            self._set_key(key, int(block_of_index[i]))
            chain = key
        rem = plen - full * bs
        if rem:
            bid = int(block_of_index[full])
            for q in range(1, rem + 1):
                pk = self._chain(
                    chain,
                    ("partial", tuple(tokens[full * bs:full * bs + q])))
                self._set_key(pk, bid)

    def _set_key(self, key, bid):
        if self._index.get(key) == bid:
            return
        self._index[key] = bid
        self._block_keys.setdefault(bid, []).append(key)

    def state(self, max_rows=32):
        """JSON-safe snapshot of the pool."""
        free = list(self._free_set)
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "free": len(free),
            "free_list_head": sorted(free)[:max_rows],
            "committed": int(self.committed),
            "shared": self.shared_count(),
            "max_refcount": int(self.ref.max()) if self.usable else 0,
            "indexed_keys": len(self._index),
            "prefix_lookups": int(self.prefix_lookups),
            "prefix_hits": int(self.prefix_hits),
            "spill": {
                "enabled": self.spill_enabled(),
                "bytes_limit": int(self.spill_bytes_limit),
                "bytes_used": int(self.spill_bytes_used),
                "blocks": self.spill_block_count(),
                "hits": int(self.spill_hits),
                "probes": int(self.spill_probes),
                "captures": int(self.spill_captures),
                "evictions": int(self.spill_evictions),
                "rehydrated_blocks": int(self.rehydrated_blocks),
            },
        }


# --------------------------------------------------------------------
# The slot engine.
# --------------------------------------------------------------------


class EngineCapacityError(RuntimeError):
    """An ``admit`` the pool cannot hold right now (no free slot, or
    the block budget is short): transient, a release frees capacity."""


def _prefill_tail(logits, row, valid_len, knobs, generator, agree=None):
    """The rest of an admission prefill once the chunk's logits
    [width, V] are in: echo logprobs of the chunk's tokens (entry 0 =
    0.0), the seen-token row (the chunk's first ``valid_len`` tokens and
    the first generated one), and the first token, sampled from the
    logits at valid_len - 1 (then passed through ``agree``, the
    engine's seam: see ``SlotDecodeEngine.agree``). Returns (first [1],
    first_lp [1], echo [width] f32, seen_row [V] bool)."""
    lse = torch.logsumexp(logits[:-1], dim=-1)
    chosen = torch.gather(logits[:-1], 1, row[0, 1:, None])[:, 0]
    echo = torch.cat([torch.zeros(1, device=row.device), chosen - lse])
    seen_row = torch.zeros(logits.shape[-1], dtype=torch.bool,
                           device=row.device)
    seen_row[row[0, :valid_len]] = True
    last = logits[max(valid_len - 1, 0)]
    first, first_lp = _slot_sample(last[None], seen_row[None], knobs,
                                   [generator])
    if agree is not None:
        first = agree(first)
    seen_row[first[0]] = True
    return first, first_lp, echo, seen_row


def _slot_prefill(model, row, prompt_len, cache, knobs, generator,
                  agree=None):
    """Dense admission prefill: ONE chunk forward of the bucket-padded
    row ([1, bucket]) into ``cache`` (a batch-1 view of the slot's rows),
    on the flash kernel. A sliding-window model's chunk rides per-row
    positions instead: it attends the full-length cache with the band
    and launches no kernel, as the JAX engine's ``per_row_index``
    prefill clone does. Padding positions' K/V are junk the position
    rewind makes unreachable. Returns (first [1], first_lp [1], echo
    [bucket] f32, seen_row [V] bool)."""
    index = (torch.zeros((1,), dtype=torch.long, device=row.device)
             if model.attention_window else 0)
    return _prefill_tail(logits_of(model(row, cache, index))[0], row,
                         prompt_len, knobs, generator, agree)


def _arena_to_dense(arena, table, slot_len):
    """Gather a row's (prefix) blocks out of the paged arena into the
    batch-1 dense cache [1, slot_len, Hkv, D] the admission prefill
    runs against: ``table`` [n_blk] puts logical position p back at
    index p. Entries beyond the shared span point at the trash block;
    their junk sits at positions >= shared_len, which the chunk's
    causal mask never reaches before the chunk's own writes land. The
    gather copies, so the prefill never writes the arena."""
    return [tuple(a[table].flatten(0, 1)[None, :slot_len] for a in layer)
            for layer in arena]


def _paged_prefill_impl(model, arena, prefix_table, row, shared_len,
                        suffix_len, knobs, generator, slot_len,
                        agree=None):
    """Admission prefill against resident prefix blocks: gather the
    shared span's K/V out of the arena, then run the (bucket-padded)
    suffix as ONE chunk forward that attends the cache at offset
    ``shared_len``, so the shared span's prefill work is skipped.
    shared_len 0 (no prefix hit) takes the same path, never the flash
    kernel, as the JAX engine's chunk_attends_cache clone does; a
    sliding-window model's chunk rides per-row positions (the band on
    the full-length cache), as its ``per_row_index`` clone. The
    seen-token row marks the suffix's valid tokens only; the echo
    covers this chunk. Returns (dense cache, first [1], first_lp [1],
    echo [width], seen_row [V] bool). Spans: ``engine.prefix_gather``,
    ``engine.prefill_forward`` and ``engine.first_token``, timed on the
    device."""
    dev = row.device
    with obs.span("engine.prefix_gather", timed_on=dev):
        cache = _arena_to_dense(arena, prefix_table, slot_len)
    with obs.span("engine.prefill_forward", timed_on=dev):
        if model.attention_window:
            logits = logits_of(model(row, cache, torch.full(
                (1,), int(shared_len), device=dev)))
        else:
            logits = logits_of(model(row, cache, int(shared_len),
                                     chunk_attends_cache=True))
    with obs.span("engine.first_token", timed_on=dev):
        tail = _prefill_tail(logits[0], row, suffix_len, knobs,
                             generator, agree)
    return (cache,) + tail


def _draft_scan(draft, cache, row_pos, tok, k, span, block_table=None):
    """The draft step over every slot: k-1 greedy single-token steps of
    the draft model from each row's last committed token, step j at
    min(row_pos + j, span - 1) (``span``: the row's cache length, or
    the table's n_blk * block_size on the draft arena). Rows without
    speculation step too; their writes land in their own unused draft
    row, or on the trash block. Returns proposals [slots, k-1]."""
    props = []
    for j in range(k - 1):
        pos = torch.clamp(row_pos + j, max=span - 1)
        logits = logits_of(draft(tok[:, None], cache, pos,
                                 block_table=block_table))
        tok = torch.argmax(logits[:, 0], dim=-1)
        props.append(tok)
    return torch.stack(props, dim=1)


def _verify_commit(raw, proposals, gate, active, seen, knobs, generators,
                   agree=None):
    """The verify step's tail: the chunk's raw logits [slots, k, V] to
    per-row accepted prefixes. Column 0 goes through the row's full
    sampling chain (for a gate-off row that IS the single-token step:
    sampling, penalty, one draw a step); columns 1..k-1 are greedy;
    ``m`` counts the matched proposals (0 where the gate is off) and
    ``counts = m + 1`` tokens commit on active rows (0 on free rows).
    Only the consumed tokens are marked seen. The rejected tail's K/V
    stay in the cache past row_pos + counts, masked until the next
    chunk rewrites them. ``agree`` (the engine's seam) sees the picked
    tokens and the proposals before anything is decided from them.
    Returns (toks [slots, k], lps [slots, k] f32, counts [slots])."""
    k = proposals.shape[1] + 1
    dev = raw.device
    tok0, lp0 = _slot_sample(raw[:, 0], seen, knobs, generators)
    toks = torch.cat([tok0[:, None], torch.argmax(raw[:, 1:], dim=-1)],
                     dim=1)
    if agree is not None:
        both = agree(torch.cat([toks, proposals], dim=1))
        toks, proposals = both[:, :k], both[:, k:]
    match = (proposals == toks[:, :k - 1]).long()
    m = torch.cumprod(match, dim=1).sum(dim=1)
    m = torch.where(gate, m, torch.zeros_like(m))
    counts = torch.where(active, m + 1, torch.zeros_like(m))
    lp_all = torch.gather(torch.log_softmax(raw.float(), dim=-1), 2,
                          toks[..., None])[..., 0]
    lps = torch.cat([lp0[:, None], lp_all[:, 1:]], dim=1)
    r, c = (torch.arange(k, device=dev)[None, :] <= m[:, None]).nonzero(
        as_tuple=True)
    seen[r, toks[r, c]] = True
    return toks, lps, counts


class SlotDecodeEngine:
    """Persistent decode slot pool with in-flight admission.

    ``admit`` prefills a request into a free slot (and hands back its
    first token), ``step`` advances every slot one token, ``release``
    frees a slot. Retirement policy (EOS, budgets) belongs to the
    caller. All methods must be called from ONE thread; the pool state
    is not synchronized.

    **Paged mode** (the default; ``CEA_TPU_PAGED_KV=0`` or
    ``paged=False`` gives the dense pool): one [num_blocks, block_size,
    Hkv, D] arena per layer with per-row block tables. A row holds
    blocks for its used tokens only; admission is gated on block
    availability (worst-case remaining growth is reserved, so a step
    never fails to allocate: exhaustion queues admissions); prompt
    prefixes resident in the pool are shared. Admission looks the
    prompt up in the content-keyed prefix index, maps matching full
    blocks refcounted, copy-on-write-forks the partial boundary block,
    and prefills only the unshared suffix. ``max_new`` at ``admit``
    bounds the reservation; ``pin_prefix`` keeps a system prompt's
    blocks resident. The default arena holds the dense pool's bytes
    (``slots * ceil(slot_len / block_size)`` usable blocks) plus
    ``pin_reserve_tokens``' blocks plus the trash block.

    **Windowed models** (``attention_window`` > 0) run in the same
    slots on full-length band-masked caches, never rings (a reused
    ring slot's stale position could leak into a rewound row's band);
    the admission prefill of either pool rides per-row positions, so
    it launches no kernel. ``ring_slack`` is refused.

    **Speculative decoding** (``draft_model``, ``spec_k`` >= 2): a
    greedy row without repetition penalty mirrors its prompt into the
    draft's cache at admission (a one-shot prefill through the draft,
    on the flash kernel, on either pool), and each step the draft
    proposes k-1 tokens that the target verifies as ONE width-k chunk
    at the row's position; ``counts[row]`` tokens commit (rejection is
    a position rewind, never a cache edit). Every other row (sampled,
    penalized, or within k of its span) takes the single-token path in
    the same chunk. ``step()`` then returns (toks [slots, k], lps
    [slots, k], counts [slots]). The paged pool keeps the draft's K/V
    in an arena of its own: a plain free list (no prefix index,
    copy-on-write or spill), a trash block, and the row's whole span
    taken at admission, sized ``slots * n_blk + 1`` blocks or
    ``spec_kv_blocks`` / ``CEA_TPU_SPEC_KV_BLOCKS``. The draft's cache
    is in the ``kv_quant`` mode too (its own mode for bf16), with its
    weights as they are. A windowed target is served; a windowed draft
    is refused.

    **Quantized KV** (``kv_quant`` / ``CEA_TPU_KV_QUANT``: bf16, int8,
    int4): the arena (or the dense pool) holds the cache in that mode,
    whatever the model's own ``kv_cache_dtype`` (bf16 keeps it), with
    the model's weights unchanged; the default block count is the
    dense pool's bytes in the model's own mode divided by the served
    mode's bytes a token, so int8 and int4 hold ~2x and ~4x the bf16
    blocks.

    **Spill tier** (``kv_spill`` / ``CEA_TPU_KV_SPILL``, default on;
    budget ``kv_spill_bytes`` / ``CEA_TPU_KV_SPILL_BYTES``): a
    registered free block's contents are copied to host memory when
    the block is reused, and uploaded back (one transfer per admission,
    table splice, copy-on-write and reservations intact) when a later
    admission's chain hits them.
    """

    def __init__(self, model, slots, slot_len, *, paged=None,
                 kv_block_size=None, kv_blocks=None, buckets=None,
                 pin_reserve_tokens=0, kv_quant=None, kv_spill=None,
                 kv_spill_bytes=None, draft_model=None, spec_k=0,
                 spec_kv_blocks=None):
        if slot_len > model.max_seq_len:
            raise ValueError(
                f"slot_len {slot_len} exceeds max_seq_len "
                f"{model.max_seq_len}")
        if slots < 1 or slot_len < 2:
            raise ValueError("need slots >= 1 and slot_len >= 2")
        if draft_model is not None:
            if int(spec_k) < 2:
                raise ValueError(
                    f"spec_k must be >= 2 (the verify chunk width; "
                    f"k-1 draft proposals per step): {spec_k}")
            if getattr(draft_model, "attention_window", 0):
                raise ValueError(
                    "draft model must use a dense cache "
                    "(attention_window=0); only the TARGET model "
                    "may be windowed")
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.vocab_size} != "
                    f"target vocab {model.vocab_size}")
            if slot_len > draft_model.max_seq_len:
                raise ValueError(
                    f"slot_len {slot_len} exceeds draft "
                    f"max_seq_len {draft_model.max_seq_len}")
            for m, which in ((model, "target"), (draft_model, "draft")):
                experts = int(getattr(m, "num_experts", 0) or 0)
                if experts and m.capacity_factor * m.top_k < experts:
                    raise ValueError(
                        f"{which} MoE model can drop tokens "
                        f"(capacity_factor * top_k < num_experts); "
                        "verify logits would not be reproducible")
        if getattr(model, "ring_slack", 0):
            # The flax per_row_index clone's refusal: slot caches are
            # full-length and band-masked, never rings.
            raise ValueError(
                "per_row_index does not take ring_slack (slot-engine "
                "windowed caches are full-length and band-masked, "
                "not rings)")
        # The requested mode wins over the model's own ("bf16" keeps
        # the model's); the caches are made in it, so the weights are
        # shared, where the JAX engine clones the module.
        quant = kv_quant_mode(kv_quant)
        self._model = model
        self.device = model.device
        # Parameter counts, the 2·N-FLOPs-per-token basis of the serving
        # loop's tpu_decode_mfu (obs.efficiency.transformer_decode_flops).
        # A MoE token runs only top_k of num_experts expert MLPs, so the
        # expert-stacked leaves (leading dim num_experts, rank >= 3:
        # w_in, w_out; the [d, E] gate is fully used) count at k/E in
        # ``active_param_count``.
        params = list(model.parameters())
        self.param_count = sum(p.numel() for p in params)
        experts = int(getattr(model, "num_experts", 0) or 0)
        top_k = int(getattr(model, "top_k", 0) or 0)
        if experts and top_k and top_k < experts:
            self.active_param_count = sum(
                (p.numel() * top_k // experts
                 if p.dim() >= 3 and p.shape[0] == experts else p.numel())
                for p in params)
        else:
            self.active_param_count = self.param_count
        # The same gauge's attention term: 4·D per attended key per
        # query head per layer (the scores and the weighted sum), over
        # ``live_keys()``.
        self.key_flops = 4.0 * model.embed_dim * model.num_layers
        self.slots = int(slots)
        self.slot_len = int(slot_len)
        self.kv_quant = _model_quant_mode(model) if quant == "bf16" else quant
        self.paged = (paged_kv_enabled() if paged is None
                      else bool(paged))
        if self.paged:
            bs = int(kv_block_size
                     or env_number(KV_BLOCK_ENV, 16, parse=int))
            if bs < 1:
                raise ValueError(f"kv_block_size must be >= 1: {bs}")
            self._block_size = bs
            self._n_blk = -(-self.slot_len // bs)
            nb = kv_blocks or env_number(KV_BLOCKS_ENV, None, parse=int)
            # The pinned prefix's span goes on top of the rows' worst
            # case: without it a worst-case row on a small pool could
            # never admit (a queued-forever wedge).
            pin_blocks = -(-int(pin_reserve_tokens) // bs)
            # `is not None`: an explicit 0 must hit the too-small guard
            # below, not select the default arena.
            if nb is not None:
                nb = int(nb)
            else:
                # Equal memory: the dense pool's bytes in the model's
                # own mode buy this many blocks in the served mode.
                usable = int(self.slots * self._n_blk
                             * kv_token_bytes(model)
                             / kv_token_bytes(model, quant))
                nb = usable + pin_blocks + 1
            if nb < self._n_blk + 1:
                raise ValueError(
                    f"kv_blocks {nb} cannot hold even one full row "
                    f"({self._n_blk} blocks) plus the trash block")
            self._num_blocks = nb
            self._trash = nb - 1
            self._pool = _BlockPool(nb, bs)
            spill_on = (kv_spill if kv_spill is not None
                        else kv_spill_enabled())
            spill_bytes = int(
                kv_spill_bytes if kv_spill_bytes is not None
                else env_number(KV_SPILL_BYTES_ENV, DEFAULT_SPILL_BYTES,
                                parse=int))
            if spill_on and spill_bytes > 0:
                self._pool.configure_spill(spill_bytes, self._fetch_block)
            self._tables = np.full((self.slots, self._n_blk), self._trash,
                                   np.int64)
            self._slot_blocks = [[] for _ in range(self.slots)]
            self._committed_slot = np.zeros((self.slots,), np.int64)
            self._pinned = []
            self._buckets = (sorted({int(b) for b in buckets})
                             if buckets else None)
            self._cache = model.init_paged_cache(nb, bs, self.kv_quant)
        else:
            self._cache = model.init_cache(self.slots, self.slot_len,
                                           self.kv_quant, ring=False)
        # Exact resident KV bytes (what kv_block_stats reports).
        self.kv_arena_bytes = int(sum(t.numel() * t.element_size()
                                      for layer in self._cache
                                      for t in layer))
        self._row_pos = np.zeros((self.slots,), np.int64)
        self._seen = torch.zeros((self.slots, model.vocab_size),
                                 dtype=torch.bool, device=self.device)
        self._generators = [None] * self.slots
        self._tok = np.zeros((self.slots,), np.int64)
        self._active = np.zeros((self.slots,), bool)
        self._knobs = SamplingKnobs(self.slots)
        self.steps = 0          # step() calls
        self.row_steps = 0      # sum of active slots over steps
        self.prefills = 0
        # {admission width: prefill calls}
        self.prefill_widths = collections.Counter()
        # Speculation counters exist on every engine; they move only
        # with a draft configured.
        self.spec_steps = 0      # step() calls with >= 1 gated row
        self.spec_row_steps = 0  # gated row-steps (rows that verified)
        self.spec_proposed = 0   # draft proposals offered (k-1 a row)
        self.spec_accepted = 0   # draft proposals accepted
        self.draft_prefills = 0
        # The token-agreement seam: None, or a callable that takes the
        # tokens a step or an admission picked (a device tensor) and
        # returns the ones to commit (a lockstep follower's: rank 0's;
        # serving/lockstep.py). It runs before any state reads them.
        self.agree = None
        self._draft_model = None
        self._spec_k = 0
        if draft_model is not None:
            self._init_draft(draft_model, int(spec_k), quant,
                             spec_kv_blocks)

    def _init_draft(self, draft_model, spec_k, quant, spec_kv_blocks):
        """The draft's cache: a dense slot pool, or on the paged pool an
        arena of its own (``spec_kv_blocks`` / CEA_TPU_SPEC_KV_BLOCKS
        blocks, default every slot's full span plus the trash block)."""
        self._spec_k = spec_k
        self._draft_model = draft_model
        self._draft_quant = (_model_quant_mode(draft_model)
                             if quant == "bf16" else quant)
        if self.paged:
            dnb = spec_kv_blocks or env_number(SPEC_KV_BLOCKS_ENV, None,
                                               parse=int)
            dnb = (int(dnb) if dnb is not None
                   else self.slots * self._n_blk + 1)
            if dnb < self._n_blk + 1:
                raise ValueError(
                    f"spec_kv_blocks {dnb} cannot hold even one full row "
                    f"({self._n_blk} blocks) plus the trash block")
            self._draft_num_blocks = dnb
            self._draft_trash = dnb - 1
            self._draft_free = collections.deque(range(dnb - 1))
            self._draft_tables = np.full((self.slots, self._n_blk),
                                         self._draft_trash, np.int64)
            self._draft_blocks = [[] for _ in range(self.slots)]
            self._draft_cache = draft_model.init_paged_cache(
                dnb, self._block_size, self._draft_quant)
        else:
            self._draft_cache = draft_model.init_cache(
                self.slots, self.slot_len, self._draft_quant, ring=False)
        self.spec_kv_arena_bytes = int(sum(
            t.numel() * t.element_size() for layer in self._draft_cache
            for t in layer))
        # Per-row gate state: whether the row drafts, and the end of
        # the span its reservation covers.
        self._spec_row = np.zeros((self.slots,), bool)
        self._span_limit = np.zeros((self.slots,), np.int64)

    def free_slots(self):
        return int((~self._active).sum())

    def active_count(self):
        return int(self._active.sum())

    def live_keys(self):
        """The keys the next step's queries attend over live tokens:
        min(pos + 1, window) summed over the active rows (host arrays
        only)."""
        keys = self._row_pos[self._active].astype(np.int64) + 1
        if self._model.attention_window:
            keys = np.minimum(keys, self._model.attention_window)
        return int(keys.sum())

    def _row(self, tokens):
        faults.fire("prefill")
        row = torch.as_tensor(np.asarray(tokens, np.int64).reshape(-1),
                              device=self.device)[None, :]
        if row.shape[1] > self.slot_len:
            raise ValueError(f"prompt row of {row.shape[1]} tokens "
                             f"exceeds slot_len {self.slot_len}")
        self.prefills += 1
        self.prefill_widths[int(row.shape[1])] += 1
        return row

    @torch.inference_mode()
    def score(self, tokens, prompt_len, *, span=None):
        """Prompt echo logprobs only (the max_new_tokens=0 scoring
        mode): the admission prefill into a scratch cache; no slot used
        and, paged, no blocks. Returns a [>= prompt_len] f32 array
        (entry 0 = 0.0); entries at and beyond prompt_len are padding
        scratch. ``span``, as in ``admit``."""
        if self.paged:
            _, _, _, echo, _, _ = self._paged_prefill(
                np.asarray(tokens, np.int64).reshape(-1)[:prompt_len], 0,
                np.full((self._n_blk,), self._trash, np.int64),
                SamplingKnobs(1), 0, span)
            return echo.cpu().numpy()
        row = self._row(tokens)
        if span:
            span.set(shared_tokens=0, width=int(row.shape[1]))
        _, _, echo, _ = _slot_prefill(
            self._model, row, int(prompt_len),
            self._model.init_cache(1, row.shape[1], self.kv_quant,
                                   ring=False),
            SamplingKnobs(1),
            torch.Generator(device=self.device))
        return echo.cpu().numpy()

    # ----- paged-pool internals --------------------------------------

    def _pick_width(self, suffix_len, shared_len):
        """Admission prefill width: the smallest configured bucket that
        holds the suffix and fits the dense prefill cache after the
        shared offset; the exact width when none does."""
        for b in (self._buckets or ()):
            if b >= suffix_len and shared_len + b <= self.slot_len:
                return b
        return suffix_len

    def _paged_plan(self, tokens, prompt_len, max_new, allow_prefix,
                    repetition_penalty, count=True):
        """Admission plan: prefix-index lookup + block accounting.
        ``needed`` counts what this admission must be able to claim:
        its whole private span (prompt blocks beyond the shared prefix
        + worst-case generation growth, reserved up front so a step
        never fails to allocate), any shared device blocks it revives
        off the free list, and one fresh device block per spilled
        source it must rehydrate into."""
        toks = np.asarray(tokens, np.int64).reshape(-1)[:prompt_len]
        share = (allow_prefix and prompt_len >= 2
                 and float(repetition_penalty) == 1.0)
        if share:
            shared, sources, fork_src = self._pool.lookup(
                toks, count=count)
        else:
            shared, sources, fork_src = 0, [], None
        if max_new is None:
            max_new = self.slot_len - prompt_len
        bs = self._block_size
        total_span = -(-(prompt_len + int(max_new)) // bs)
        private_total = total_span - len(sources)
        revived = sum(1 for kind, b in sources
                      if kind == "dev" and self._pool.ref[b] == 0)
        spilled = sum(1 for kind, _ in sources if kind == "spill")
        # A rehydrating admission pins a free-listed (ref-0) device
        # fork donor for its duration (see _paged_admit), taking it out
        # of the free set: one extra block of headroom.
        pin_donor = (spilled > 0 and fork_src is not None
                     and fork_src[0] == "dev"
                     and self._pool.ref[fork_src[1]] == 0)
        return {"tokens": toks, "shared": shared, "sources": sources,
                "fork_src": fork_src, "total_span": total_span,
                "private_total": private_total,
                "needed": (private_total + revived + spilled
                           + (1 if pin_donor else 0)),
                # One authority for lookup and registration.
                "share_eligible": share}

    def _spec_eligible(self, temperature, repetition_penalty):
        """Whether a row with these knobs drafts: greedy rows without a
        repetition penalty (a sampled row's verify column would need
        per-proposal acceptance sampling, a penalized draft stream the
        target's seen state); the others take the single-token path in
        the same chunk."""
        return (self._draft_model is not None
                and float(temperature) == 0.0
                and float(repetition_penalty) == 1.0)

    def _draft_span_blocks(self, prompt_len, max_new):
        """Draft blocks a row's whole span needs (taken at admission:
        the draft step never allocates)."""
        if max_new is None:
            max_new = self.slot_len - prompt_len
        limit = min(prompt_len + int(max_new), self.slot_len)
        return -(-limit // self._block_size)

    def admission_block_cause(self, tokens, prompt_len, max_new=None,
                              *, allow_prefix=True,
                              repetition_penalty=1.0,
                              temperature=0.0):
        """What an ``admit`` with these arguments is blocked on now:
        ``"slots"`` (no free slot), ``"kv_blocks"`` (a free slot, but
        the block budget, free minus other rows' reservations, cannot
        cover the row's worst-case private span), ``"spec_kv_blocks"``
        (a drafting row's span does not fit the draft arena's free
        list), or None (admissible)."""
        if self.free_slots() == 0:
            return "slots"
        if not self.paged:
            return None
        plan = self._paged_plan(tokens, prompt_len, max_new,
                                allow_prefix, repetition_penalty,
                                count=False)
        if self._pool.available() < plan["needed"]:
            return "kv_blocks"
        if (self._spec_eligible(temperature, repetition_penalty)
                and len(self._draft_free)
                < self._draft_span_blocks(prompt_len, max_new)):
            return "spec_kv_blocks"
        return None

    def can_admit(self, tokens, prompt_len, max_new=None, *,
                  allow_prefix=True, repetition_penalty=1.0,
                  temperature=0.0):
        """Whether ``admit`` with these arguments would succeed now:
        a free slot on the dense pool; on the paged pool also the block
        budget (``admission_block_cause`` names what is short)."""
        return self.admission_block_cause(
            tokens, prompt_len, max_new, allow_prefix=allow_prefix,
            repetition_penalty=repetition_penalty,
            temperature=temperature) is None

    def block_availability(self):
        """(available, usable) KV blocks: *available* nets out admitted
        rows' growth reservations, the budget ``can_admit`` gates on.
        None on the dense pool."""
        if not self.paged:
            return None
        return self._pool.available(), self._pool.usable

    def _paged_prefill(self, suffix, shared_len, prefix_table, knobs,
                       seed, span=None):
        faults.fire("prefill")
        width = self._pick_width(max(len(suffix), 1), shared_len)
        row = np.zeros((width,), np.int64)
        row[:len(suffix)] = suffix
        self.prefills += 1
        self.prefill_widths[int(width)] += 1
        if span:
            span.set(shared_tokens=int(shared_len), width=int(width))
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed))
        out = _paged_prefill_impl(
            self._model, self._cache,
            torch.as_tensor(prefix_table, device=self.device),
            torch.as_tensor(row, device=self.device)[None],
            shared_len, len(suffix), knobs, generator, self.slot_len,
            self.agree)
        return out + (generator,)

    def _take_commit(self, slot):
        if self._committed_slot[slot] > 0:
            self._committed_slot[slot] -= 1
            self._pool.committed -= 1

    def _fetch_block(self, bid):
        """The spill tier's capture: one arena block of every layer,
        one host tensor per cache leaf (K, V and, quantized, their
        scales; their dtypes and widths differ), each [layers,
        block_size, Hkv, ...] and copied in one transfer. Called by the
        pool when a registered block is reused, between forwards on the
        engine's thread."""
        return tuple(torch.stack([layer[i][bid] for layer in self._cache])
                     .cpu() for i in range(len(self._cache[0])))

    def _copy_block(self, src, dst):
        """Copy-on-write: arena block ``src`` into ``dst``, every
        layer's K and V (and scales)."""
        for layer in self._cache:
            for a in layer:
                a[dst] = a[src]

    def _rehydrate(self, pairs, spill_data):
        """Upload spilled block contents into freshly allocated arena
        blocks: one host-to-device transfer per cache leaf and
        admission, then one scatter per layer and leaf; timed
        (synchronized on the card) into the pool's rehydrate
        samples."""
        faults.fire("hydrate")
        t0 = time.perf_counter()
        dests = torch.as_tensor([bid for bid, _ in pairs],
                                device=self.device)
        for i in range(len(self._cache[0])):
            payload = torch.stack([spill_data[key][i] for _, key in pairs]
                                  ).to(self.device)  # [n, layers, bs, ...]
            for li, layer in enumerate(self._cache):
                layer[i][dests] = payload[:, li]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._pool.note_rehydrate(len(pairs), time.perf_counter() - t0)

    def _paged_insert(self, pre_cache, shared, prompt_len, block_of_index,
                      cow=None):
        """Write a prefilled batch-1 dense cache into arena blocks:
        first the admission's copy-on-write fork (``cow`` = (src, dst),
        the shared partial boundary block), then positions [shared,
        prompt_len) only, so the shared span is not rewritten and the
        bucket padding past the prompt is dropped."""
        if cow is not None:
            self._copy_block(*cow)
        if prompt_len <= shared:
            return
        span = np.arange(shared, prompt_len)
        blocks = torch.as_tensor(
            np.asarray(block_of_index)[span // self._block_size],
            device=self.device)
        offsets = torch.as_tensor(span % self._block_size,
                                  device=self.device)
        for layer, pre in zip(self._cache, pre_cache):
            for a, p in zip(layer, pre):
                a[blocks, offsets] = p[0, shared:prompt_len]

    def _paged_admit(self, slot, plan, prompt_len, knobs, seed, span):
        pool, bs = self._pool, self._block_size
        if pool.available() < plan["needed"]:
            raise EngineCapacityError(
                f"insufficient free KV blocks "
                f"(need {plan['needed']}, "
                f"available {pool.available()}); queue the admission")
        toks, shared = plan["tokens"], plan["shared"]
        fork_src = plan["fork_src"]
        # Snapshot host-tier payloads first: the allocations below can
        # spill blocks and trim the LRU, and an entry this admission
        # planned to rehydrate must stay alive.
        spill_keys = [ref for kind, ref in plan["sources"]
                      if kind == "spill"]
        if fork_src is not None and fork_src[0] == "spill":
            spill_keys.append(fork_src[1])
        spill_data = {key: pool.take_spill(key) for key in spill_keys}
        # Materialize the shared span. Device blocks take a reference
        # before any alloc, so a revived (ref-0 free-listed) shared
        # block is never popped out from under the plan. Host-tier
        # blocks allocate fresh device blocks and batch into one
        # rehydrate upload.
        table_row = self._tables[slot]
        slot_blocks = self._slot_blocks[slot]
        hold = None
        try:
            for i, (kind, ref) in enumerate(plan["sources"]):
                if kind == "dev":
                    pool.incref(ref)
                    table_row[i] = ref
                    slot_blocks.append(ref)
            if (fork_src is not None and fork_src[0] == "dev"
                    and any(kind == "spill"
                            for kind, _ in plan["sources"])):
                # Pin the fork donor while a rehydrate is in flight: it
                # may be a free-listed (ref-0 revival) block, and the
                # hydrate allocations below must never pop it, or an
                # upload landing in it would destroy the partial
                # content the prefill gather and the fork still need.
                hold = fork_src[1]
                pool.incref(hold)
            hydrate = []                      # (dest block, key)
            for i, (kind, ref) in enumerate(plan["sources"]):
                if kind == "spill":
                    bid = pool.alloc()
                    table_row[i] = bid
                    slot_blocks.append(bid)
                    hydrate.append((bid, ref))
            cow = None
            aligned_idx = shared // bs
            if fork_src is not None:
                dst = pool.alloc()
                table_row[aligned_idx] = dst
                slot_blocks.append(dst)
                kind, ref = fork_src
                if kind == "dev":
                    cow = (ref, dst)
                    boundary = ref
                else:
                    # A spilled partial boundary block rehydrates
                    # directly into its fork destination: the upload is
                    # the copy-on-write copy.
                    hydrate.append((dst, ref))
                    boundary = dst
                fresh_from = aligned_idx + 1
            else:
                fresh_from = aligned_idx
            if hydrate:
                self._rehydrate(hydrate, spill_data)
            # Prefill the suffix against the now fully resident prefix:
            # the full shared blocks, and the partial boundary block
            # read from its current owner.
            ptab = np.full((self._n_blk,), self._trash, np.int64)
            for i in range(len(plan["sources"])):
                ptab[i] = table_row[i]
            if fork_src is not None:
                ptab[len(plan["sources"])] = boundary
            pre_cache, first, first_lp, echo, seen_row, generator = (
                self._paged_prefill(toks[shared:], shared, ptab, knobs,
                                    seed, span))
            last_idx = (prompt_len - 1) // bs
            for bi in range(fresh_from, last_idx + 1):
                b = pool.alloc()
                table_row[bi] = b
                slot_blocks.append(b)
            remaining = plan["total_span"] - (last_idx + 1)
            self._committed_slot[slot] = remaining
            pool.committed += remaining
            with obs.span("engine.kv_insert", timed_on=self.device):
                self._paged_insert(pre_cache, shared, prompt_len,
                                   table_row, cow)
            if hold is not None:
                # The copy has landed; drop the donor pin (a revival
                # donor returns to the free list, keys intact).
                pool.decref(hold)
                hold = None
        except BaseException:
            # A failure mid-admission (a device error or an
            # interrupt) leaves the pool exactly as it found it: the
            # serving loop catches admission errors and keeps serving,
            # so a leaked reference would shrink the budget forever.
            for b in slot_blocks:
                pool.decref(b)
            self._slot_blocks[slot] = []
            table_row[:] = self._trash
            pool.committed -= int(self._committed_slot[slot])
            self._committed_slot[slot] = 0
            if hold is not None:
                pool.decref(hold)
            raise
        if plan["share_eligible"]:
            pool.register(toks, prompt_len, table_row)
        return first, first_lp, echo, seen_row, generator

    @torch.inference_mode()
    def pin_prefix(self, tokens):
        """Prefill a shared prompt prefix once into permanently held
        arena blocks and register it in the prefix index: every later
        admission whose prompt starts with it maps the blocks and
        prefills only its own suffix. Consumes no slot. Returns the
        pinned block count."""
        if not self.paged:
            raise ValueError("pin_prefix requires the paged KV pool "
                             f"({PAGED_KV_ENV}=1)")
        toks = np.asarray(tokens, np.int64).reshape(-1)
        plen = int(toks.size)
        if not 1 <= plen <= self.slot_len - 1:
            raise ValueError(
                f"prefix length {plen} must be in "
                f"1..{self.slot_len - 1}")
        bs = self._block_size
        n_need = -(-plen // bs)
        if self._pool.available() < n_need:
            raise RuntimeError(
                f"insufficient free KV blocks to pin a "
                f"{n_need}-block prefix")
        if self._pool.usable - n_need < self._n_blk:
            # What remains must hold one worst-case row, or that row
            # would queue forever.
            raise ValueError(
                f"kv_blocks too small for a pinned "
                f"{n_need}-block prefix plus one worst-case "
                f"{self._n_blk}-block row; raise {KV_BLOCKS_ENV} to "
                f">= {self._n_blk + n_need + 1}")
        pre_cache = self._paged_prefill(
            toks, 0, np.full((self._n_blk,), self._trash, np.int64),
            SamplingKnobs(1), 0)[0]
        blocks = [self._pool.alloc() for _ in range(n_need)]
        self._paged_insert(pre_cache, 0, plen, blocks)
        self._pool.register(toks, plen, blocks)
        self._pinned.extend(blocks)
        return n_need

    def kv_block_stats(self):
        """Block-pool telemetry (None on the dense pool): totals plus
        the utilization and prefix-hit-rate ratios."""
        if not self.paged:
            return None
        pool = self._pool
        used = pool.usable - pool.free_count()
        stats = {
            "kv_blocks_total": pool.usable,
            "kv_blocks_free": pool.free_count(),
            "kv_blocks_shared": pool.shared_count(),
            "kv_block_size": pool.block_size,
            "kv_block_utilization": (round(used / pool.usable, 4)
                                     if pool.usable else None),
            "prefix_lookups": pool.prefix_lookups,
            "prefix_hits": pool.prefix_hits,
            "prefix_hit_rate": (
                round(pool.prefix_hits / pool.prefix_lookups, 4)
                if pool.prefix_lookups else None),
            "prefix_tokens_shared": pool.shared_tokens,
            "kv_quant_mode": self.kv_quant,
            "kv_arena_bytes": self.kv_arena_bytes,
            "kv_spill_blocks": pool.spill_block_count(),
            "kv_spill_bytes": int(pool.spill_bytes_used),
            "kv_spill_hits": int(pool.spill_hits),
            "kv_spill_hit_rate": (
                round(pool.spill_hits / pool.spill_probes, 4)
                if pool.spill_probes else None),
            "kv_rehydrated_blocks": int(pool.rehydrated_blocks),
        }
        if self._draft_model is not None:
            stats["spec_kv_blocks_total"] = self._draft_num_blocks - 1
            stats["spec_kv_blocks_free"] = len(self._draft_free)
            stats["spec_kv_arena_bytes"] = self.spec_kv_arena_bytes
        return stats

    def reset_prefix_counters(self):
        """Zero the prefix-sharing counters (no-op on the dense pool),
        so a published hit rate describes real traffic only."""
        if self.paged:
            self._pool.prefix_lookups = 0
            self._pool.prefix_hits = 0
            self._pool.shared_tokens = 0
            self._pool.spill_probes = 0
            self._pool.spill_hits = 0

    def drain_rehydrate_events(self):
        """Rehydrate latencies (seconds) since the last call; empty on
        the dense pool."""
        if not self.paged:
            return []
        return self._pool.drain_rehydrate_events()

    def block_pool_state(self):
        """The pool's audit snapshot: free list, refcounts, tables of
        the active rows, reservations."""
        if not self.paged:
            return {"paged": False}
        state = self._pool.state()
        state["paged"] = True
        state["kv_quant_mode"] = self.kv_quant
        state["kv_arena_bytes"] = self.kv_arena_bytes
        state["pinned_blocks"] = len(self._pinned)
        state["tables"] = {
            int(s): [int(b) for b in self._tables[s] if b != self._trash]
            for s in np.flatnonzero(self._active)[:32]}
        state["committed_per_slot"] = {
            int(s): int(self._committed_slot[s])
            for s in np.flatnonzero(self._committed_slot)[:32]}
        return state

    @torch.inference_mode()
    def admit(self, tokens, prompt_len, *, temperature=0.0, top_k=0,
              top_p=1.0, min_p=0.0, repetition_penalty=1.0, seed=0,
              max_new=None, allow_prefix=True, span=None):
        """Prefill ``tokens`` (a [>= prompt_len] int row: bucket-padded
        on the dense pool, padding ignored on the paged pool) into a
        free slot. Returns (slot, first_token, first_logprob,
        echo_logprobs). The first generated token is produced here; the
        next ``step`` yields the second. A ``span`` (the caller's
        admission span) is given the prefill's ``shared_tokens`` (the
        prefix hit) and padded ``width``.

        Paged pool: ``max_new`` bounds the row's block reservation
        (default: the worst case to slot_len); ``allow_prefix=False``
        turns off prefix sharing and registration for this row (rows
        that need full-prompt echo logprobs: a shared span's echo is
        never computed). Raises EngineCapacityError when the block
        budget cannot cover the row: callers queue and retry after a
        release.

        With a draft model, a greedy row without penalty also mirrors
        its prompt into the draft's cache; on the paged pool its whole
        draft span must fit the draft arena's free list, checked before
        the pool is touched (EngineCapacityError otherwise)."""
        tsan.note_write("engine.slot_tables", self)
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise EngineCapacityError("no free slot; release one first")
        slot = int(free[0])
        spec = self._spec_eligible(temperature, repetition_penalty)
        if spec and self.paged:
            d_need = self._draft_span_blocks(prompt_len, max_new)
            if len(self._draft_free) < d_need:
                raise EngineCapacityError(
                    f"insufficient free draft KV blocks "
                    f"(need {d_need}, free {len(self._draft_free)});"
                    " queue the admission")
        knobs = SamplingKnobs(1)
        knobs.set(0, temperature, top_k, top_p, min_p, repetition_penalty)
        if self.paged:
            plan = self._paged_plan(tokens, prompt_len, max_new,
                                    allow_prefix, repetition_penalty)
            first, first_lp, echo, seen_row, generator = self._paged_admit(
                slot, plan, prompt_len, knobs, seed, span)
        else:
            row = self._row(tokens)
            if span:
                span.set(shared_tokens=0, width=int(row.shape[1]))
            generator = torch.Generator(device=self.device)
            generator.manual_seed(int(seed))
            view = [tuple(a[slot:slot + 1] for a in layer)
                    for layer in self._cache]
            first, first_lp, echo, seen_row = _slot_prefill(
                self._model, row, int(prompt_len), view, knobs, generator,
                self.agree)
        # Rewind the slot's position to its true prompt length (the
        # generation then overwrites any bucket padding) and install
        # its seen-token row and generator.
        self._row_pos[slot] = prompt_len
        self._seen[slot] = seen_row
        self._generators[slot] = generator
        if self._draft_model is not None:
            self._spec_row[slot] = spec
            if spec:
                self._span_limit[slot] = min(
                    prompt_len + (int(max_new) if max_new is not None
                                  else self.slot_len - prompt_len),
                    self.slot_len)
                self._admit_draft(slot, tokens, prompt_len)
            else:
                self._span_limit[slot] = 0
        first_tok = int(first[0])
        self._tok[slot] = first_tok
        self._active[slot] = True
        self._knobs.set(slot, temperature, top_k, top_p, min_p,
                        repetition_penalty)
        return slot, first_tok, float(first_lp[0]), echo.cpu().numpy()

    def _admit_draft(self, slot, tokens, prompt_len):
        """Mirror an admitted greedy row into the draft's cache: take
        its whole draft span (paged; checked in ``admit``), prefill the
        full prompt through the draft in one forward on the flash
        kernel (no prefix sharing: draft blocks are private), padded to
        ``_pick_width(prompt_len, 0)`` on the paged pool and as given
        on the dense one, and write it into the slot's draft row (the
        rest of the row zeroed, as the JAX engine's insert of a fresh
        batch-1 cache does) or the span's blocks. The blocks are booked
        before the device work, so a torn admission's release returns
        them."""
        row = np.asarray(tokens, np.int64).reshape(-1)
        if self.paged:
            bs = self._block_size
            d_need = -(-int(self._span_limit[slot]) // bs)
            blocks = [self._draft_free.popleft() for _ in range(d_need)]
            self._draft_blocks[slot] = blocks
            self._draft_tables[slot, :d_need] = blocks
            width = self._pick_width(prompt_len, 0)
            padded = np.zeros((width,), np.int64)
            padded[:prompt_len] = row[:prompt_len]
            row = padded
        self.draft_prefills += 1
        chunk = torch.as_tensor(row, device=self.device)[None]
        if not self.paged:
            view = [tuple(a[slot:slot + 1] for a in layer)
                    for layer in self._draft_cache]
            for layer in view:
                for a in layer:
                    a.zero_()
            self._draft_model(chunk, view, 0)
            return
        pre = self._draft_model.init_cache(1, chunk.shape[1],
                                           self._draft_quant, ring=False)
        self._draft_model(chunk, pre, 0)
        span = np.arange(prompt_len)
        dest = torch.as_tensor(self._draft_tables[slot, span // bs],
                               device=self.device)
        offsets = torch.as_tensor(span % bs, device=self.device)
        for layer, pre_layer in zip(self._draft_cache, pre):
            for a, p in zip(layer, pre_layer):
                a[dest, offsets] = p[0, :prompt_len]

    def _paged_prestep(self, gate=None):
        """Host-side block upkeep before a step: every active row is
        about to write at its current position, and a row of ``gate``
        (a verify step's speculating rows) its whole [pos, pos + k)
        span, which can cross a block. Allocate each block of the span
        that is still the trash block (the reservation guarantees
        success: the gate keeps a span inside the row's total), and fork
        copy-on-write each shared one (refcount > 1: prompt sharing
        never writes a shared block by construction; the check keeps
        any other sharing policy safe). The other rows' junk proposal
        columns land on trash or on their own tail, which no mask
        admits. Returns the step's (src, dst) copies."""
        cows = []
        bs = self._block_size
        for slot in np.flatnonzero(self._active):
            wp = int(self._row_pos[slot])
            if wp >= self.slot_len:
                continue  # clamped row; its writes rewrite junk
            span = self._spec_k if gate is not None and gate[slot] else 1
            for bi in range(wp // bs,
                            (min(wp + span, self.slot_len) - 1) // bs + 1):
                cur = int(self._tables[slot, bi])
                if cur == self._trash:
                    b = self._pool.alloc()
                    self._tables[slot, bi] = b
                    self._slot_blocks[slot].append(b)
                    self._take_commit(slot)
                elif self._pool.ref[cur] > 1:
                    dst = self._pool.alloc()
                    cows.append((cur, dst))
                    self._tables[slot, bi] = dst
                    self._slot_blocks[slot].remove(cur)
                    self._slot_blocks[slot].append(dst)
                    self._pool.decref(cur)
                    self._take_commit(slot)
        return cows

    def _spec_step(self):
        """One speculative step: the draft proposes k-1 tokens for
        every row (when any row is gated: active, drafting, and pos + k
        within its span), the target verifies [last | proposals] as one
        width-k chunk at each row's position, and ``counts[row]``
        tokens commit. Returns (toks [slots, k], lps [slots, k],
        counts [slots]) as numpy."""
        k = self._spec_k
        dev = self.device
        gate = (self._active & self._spec_row
                & (self._row_pos + k <= self._span_limit))
        any_gated = bool(gate.any())
        tok = torch.as_tensor(self._tok, device=dev)
        if self.paged:
            # The fault fires after the host-side block upkeep, as in
            # the JAX engine: the torn tables a mid-step device failure
            # leaves are what quarantine and force_reclaim must survive.
            cows = self._paged_prestep(gate)
            faults.fire("step")
            for src, dst in cows:
                self._copy_block(src, dst)
            span = self._n_blk * self._block_size
            tables = torch.as_tensor(self._tables, device=dev)
            draft_tables = torch.as_tensor(self._draft_tables, device=dev)
        else:
            faults.fire("step")
            span = self.slot_len
            tables = draft_tables = None
        row_pos = torch.as_tensor(self._row_pos, device=dev)
        if any_gated:
            props = _draft_scan(self._draft_model, self._draft_cache,
                                row_pos, tok, k, span, draft_tables)
        else:
            props = torch.zeros((self.slots, k - 1), dtype=torch.long,
                                device=dev)
        raw = logits_of(self._model(
            torch.cat([tok[:, None], props], dim=1), self._cache,
            torch.clamp(row_pos, max=span - 1), block_table=tables))
        toks, lps, counts = _verify_commit(
            raw, props, torch.as_tensor(gate, device=dev),
            torch.as_tensor(self._active, device=dev), self._seen,
            self._knobs, self._generators, self.agree)
        toks, lps = toks.cpu().numpy(), lps.cpu().numpy()
        counts = counts.cpu().numpy()
        last = np.maximum(counts, 1) - 1
        np.copyto(self._tok, toks[np.arange(self.slots), last],
                  where=self._active)
        self._row_pos += counts
        self.steps += 1
        self.row_steps += int(self._active.sum())
        if any_gated:
            self.spec_steps += 1
            self.spec_row_steps += int(gate.sum())
            self.spec_proposed += int(gate.sum()) * (k - 1)
            self.spec_accepted += int((counts[gate] - 1).sum())
        return toks, lps, counts

    @torch.inference_mode()
    def step(self):
        """Advance EVERY slot one token. Returns (tokens [slots] int64,
        logprobs [slots] f32) as numpy; entries for free slots are
        scratch. None when the pool is empty. Free rows step too, at a
        position clamped into the row (paged: their tables point at the
        trash block), and their output is ignored. With a draft model
        the step is speculative and returns (toks [slots, k], lps
        [slots, k], counts [slots]): row r commits its first
        ``counts[r]`` tokens (``_spec_step``)."""
        if not self._active.any():
            return None
        tsan.note_write("engine.slot_tables", self)
        if self._draft_model is not None:
            return self._spec_step()
        dev = self.device
        # Spans: the host's block upkeep and uploads, then the forward
        # (every row attends ``span`` positions) and the sampling, timed
        # on the device.
        with obs.span("engine.prestep"):
            tok = torch.as_tensor(self._tok, device=dev)[:, None]
            if self.paged:
                cows = self._paged_prestep()
                faults.fire("step")
                for src, dst in cows:
                    self._copy_block(src, dst)
                span = self._n_blk * self._block_size
                tables = torch.as_tensor(self._tables, device=dev)
            else:
                faults.fire("step")
                span, tables = self.slot_len, None
            pos = torch.as_tensor(np.minimum(self._row_pos, span - 1),
                                  device=dev)
        with obs.span("engine.forward", timed_on=dev) as sp:
            if sp:
                sp.set(keys_attended=self.slots * span,
                       keys_live=self.live_keys())
            raw = logits_of(self._model(tok, self._cache, pos,
                                        block_table=tables))
        with obs.span("engine.sample", timed_on=dev):
            nxt, lp = _slot_sample(raw[:, 0], self._seen, self._knobs,
                                   self._generators)
            if self.agree is not None:
                nxt = self.agree(nxt)
            self._seen[torch.arange(self.slots, device=dev), nxt] = True
        self._row_pos += self._active
        toks = nxt.cpu().numpy()
        np.copyto(self._tok, toks, where=self._active)
        self.steps += 1
        self.row_steps += int(self._active.sum())
        return toks, lp.cpu().numpy()

    def release(self, slot):
        """Free a slot for the next admission; its sampling knobs reset
        to the no-op values. Dense pool: the row's cache content stays
        but is unreachable (admission overwrites it, the per-row mask
        hides it meanwhile). Paged pool: every block reference the row
        holds is dropped (blocks at refcount 0 return to the free list,
        their prefix keys kept for revival until reuse), its table
        resets to the trash block and its unspent reservation returns
        to the budget."""
        tsan.note_write("engine.slot_tables", self)
        if self.paged:
            for b in self._slot_blocks[slot]:
                self._pool.decref(b)
            self._slot_blocks[slot] = []
            self._tables[slot, :] = self._trash
            self._pool.committed -= int(self._committed_slot[slot])
            self._committed_slot[slot] = 0
            self._row_pos[slot] = 0
        if self._draft_model is not None:
            if self.paged:
                self._draft_free.extend(self._draft_blocks[slot])
                self._draft_blocks[slot] = []
                self._draft_tables[slot, :] = self._draft_trash
            self._spec_row[slot] = False
            self._span_limit[slot] = 0
        self._active[slot] = False
        self._generators[slot] = None
        self._knobs.reset(slot)

    def pool_leak_report(self):
        """Invariant audit for a pool that should be empty (every row
        failed or released): None when clean, else {violation: detail}.
        Paged: every non-pinned block free, nothing shared, no
        outstanding reservation, every table all-trash, refcounts
        exactly the pinned set. Dense pools only have the active-row
        check."""
        problems = {}
        if self._active.any():
            problems["active_rows"] = [
                int(s) for s in np.flatnonzero(self._active)]
        if not self.paged:
            return problems or None
        pool = self._pool
        pinned = len(self._pinned)
        if pool.free_count() != pool.usable - pinned:
            problems["free_blocks"] = {
                "free": pool.free_count(),
                "expected": pool.usable - pinned}
        if pool.shared_count() != 0:
            problems["shared_blocks"] = pool.shared_count()
        if pool.committed != 0:
            problems["committed"] = int(pool.committed)
        if not bool((self._tables == self._trash).all()):
            problems["tables"] = [
                int(s) for s in range(self.slots)
                if (self._tables[s] != self._trash).any()]
        refsum = int(np.abs(pool.ref).sum())
        if refsum != pinned:
            problems["refcounts"] = {"held": refsum, "pinned": pinned}
        if self._draft_model is not None:
            free_d = len(self._draft_free)
            if free_d != self._draft_num_blocks - 1:
                problems["draft_blocks"] = {
                    "free": free_d, "expected": self._draft_num_blocks - 1}
            if not bool((self._draft_tables == self._draft_trash).all()):
                problems["draft_tables"] = [
                    int(s) for s in range(self.slots)
                    if (self._draft_tables[s] != self._draft_trash).any()]
        return problems or None

    def force_reclaim(self):
        """Pool repair after a failure tore a step or an admission:
        release every slot (idempotent), so blocks, reservations and
        tables return to the empty-pool state. Returns the residual
        ``pool_leak_report()``: None when the reclaim restored the
        invariants."""
        for slot in range(self.slots):
            self.release(slot)
        return self.pool_leak_report()

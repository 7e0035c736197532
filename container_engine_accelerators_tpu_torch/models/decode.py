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

"""Autoregressive decoding: the greedy oracle and the slot engine.

Counterpart of container_engine_accelerators_tpu/models/decode.py for
the dense KV cache:

- ``greedy_decode``: the single-request oracle. One-shot prefill of the
  prompt (the flash kernel on the raw chunk), then single-token steps,
  as ``decode()``'s greedy fast-prefill path.
- ``SlotDecodeEngine`` with the dense slot pool: ``admit`` prefills a
  bucket-padded prompt into a free slot's cache row and returns the
  first token, ``step`` advances every slot one token with per-row
  sampling knobs, ``release`` frees a slot. The paged block pool,
  quantized caches and speculation are not ported yet and raise.

JAX's programs are pure; here the engine's cache is updated in place
(the admission prefill writes straight into its slot's row instead of
into a batch-1 cache that is then copied in), which saves the copy and
a second slot-sized buffer. Sampling draws from one
``torch.Generator`` per row, seeded from the request's ``seed``: the
same distribution as the JAX engine's threefry keys, not the same
numbers.
"""

import collections

import numpy as np
import torch

from ..utils import _env_flag, env_str, not_ported

PAGED_KV_ENV = "CEA_TPU_PAGED_KV"
KV_QUANT_ENV = "CEA_TPU_KV_QUANT"


def paged_kv_enabled(default=False):
    """CEA_TPU_PAGED_KV gate. The port defaults to the dense pool (the
    only one it has); turning the paged pool on raises at engine
    construction."""
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
def greedy_decode(model, prompt, max_new_tokens):
    """Greedy generation of ``max_new_tokens`` after ``prompt``
    ([B, P] ints). Returns the [B, P + max_new_tokens] int64 sequence
    (prompt included) on the model's device: one forward pass fills
    the cache with the whole prompt, then one step per new token."""
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, p = prompt.shape
    if max_new_tokens <= 0:
        return prompt.clone()
    cache = model.init_cache(b, p + max_new_tokens)
    logits = model(prompt, cache, 0)
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [prompt, tok[:, None]]
    for t in range(p, p + max_new_tokens - 1):
        logits = model(tok[:, None], cache, t)
        tok = torch.argmax(logits[:, 0], dim=-1)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


# --------------------------------------------------------------------
# The slot engine (dense pool).
# --------------------------------------------------------------------


class EngineCapacityError(RuntimeError):
    """An ``admit`` the pool cannot hold right now (no free slot)."""


def _slot_prefill(model, row, prompt_len, cache, knobs, generator):
    """Admission prefill: ONE chunk forward of the bucket-padded row
    ([1, bucket]) into ``cache`` (a batch-1 view of the slot's rows),
    the first token sampled from the logits at prompt_len - 1, echo
    logprobs for the prompt. Padding positions' K/V are junk the
    position rewind makes unreachable. Returns (first [1],
    first_lp [1], echo [bucket] f32, seen_row [V] bool)."""
    logits = model(row, cache, 0)[0]                    # [bucket, V]
    lse = torch.logsumexp(logits[:-1], dim=-1)
    chosen = torch.gather(logits[:-1], 1, row[0, 1:, None])[:, 0]
    echo = torch.cat([torch.zeros(1, device=row.device), chosen - lse])
    seen_row = torch.zeros(logits.shape[-1], dtype=torch.bool,
                           device=row.device)
    seen_row[row[0, :prompt_len]] = True
    last = logits[max(prompt_len - 1, 0)]
    first, first_lp = _slot_sample(last[None], seen_row[None], knobs,
                                   [generator])
    seen_row[first[0]] = True
    return first, first_lp, echo, seen_row


class SlotDecodeEngine:
    """Persistent decode slot pool with in-flight admission (dense).

    ``admit`` prefills a request into a free slot (and hands back its
    first token), ``step`` advances every slot one token, ``release``
    frees a slot. Retirement policy (EOS, budgets) belongs to the
    caller. All methods must be called from ONE thread; the pool state
    is not synchronized.
    """

    def __init__(self, model, slots, slot_len, *, paged=None,
                 buckets=None, pin_reserve_tokens=0, kv_quant=None,
                 draft_model=None, spec_k=0):
        if slot_len > model.max_seq_len:
            raise ValueError(
                f"slot_len {slot_len} exceeds max_seq_len "
                f"{model.max_seq_len}")
        if slots < 1 or slot_len < 2:
            raise ValueError("need slots >= 1 and slot_len >= 2")
        if paged_kv_enabled() if paged is None else paged:
            raise not_ported(
                "the paged KV pool (pass paged=False or set "
                f"{PAGED_KV_ENV}=0)")
        if kv_quant_mode(kv_quant) != "bf16":
            raise not_ported(f"kv_quant={kv_quant_mode(kv_quant)!r}")
        if draft_model is not None or spec_k:
            raise not_ported("speculative decoding (draft_model)")
        if pin_reserve_tokens:
            raise not_ported("pin_reserve_tokens (prefix pinning)")
        del buckets  # the paged pool's width choice; dense prefills as given
        self._model = model
        self.device = model.device
        self.slots = int(slots)
        self.slot_len = int(slot_len)
        self.paged = False
        self.kv_quant = "bf16"
        self._cache = model.init_cache(self.slots, self.slot_len)
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

    def free_slots(self):
        return int((~self._active).sum())

    def active_count(self):
        return int(self._active.sum())

    def occupancy_avg(self):
        return self.row_steps / self.steps if self.steps else None

    def _row(self, tokens):
        row = torch.as_tensor(np.asarray(tokens, np.int64).reshape(-1),
                              device=self.device)[None, :]
        if row.shape[1] > self.slot_len:
            raise ValueError(f"prompt row of {row.shape[1]} tokens "
                             f"exceeds slot_len {self.slot_len}")
        self.prefills += 1
        self.prefill_widths[int(row.shape[1])] += 1
        return row

    @torch.inference_mode()
    def score(self, tokens, prompt_len):
        """Prompt echo logprobs only (the max_new_tokens=0 scoring
        mode): the same prefill into a scratch cache, no slot used.
        Returns a [len(tokens)] f32 array (entry 0 = 0.0); entries at
        and beyond prompt_len are padding scratch."""
        row = self._row(tokens)
        knobs = SamplingKnobs(1)
        _, _, echo, _ = _slot_prefill(
            self._model, row, int(prompt_len),
            self._model.init_cache(1, row.shape[1]), knobs,
            torch.Generator(device=self.device))
        return echo.cpu().numpy()

    @torch.inference_mode()
    def admit(self, tokens, prompt_len, *, temperature=0.0, top_k=0,
              top_p=1.0, min_p=0.0, repetition_penalty=1.0, seed=0,
              max_new=None, allow_prefix=True):
        """Prefill ``tokens`` (a bucket-padded [>= prompt_len] int row)
        into a free slot. Returns (slot, first_token, first_logprob,
        echo_logprobs). The first generated token is produced HERE;
        the next ``step`` yields the second. ``max_new`` and
        ``allow_prefix`` are paged-pool arguments, accepted and unused
        by the dense pool."""
        del max_new, allow_prefix
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise EngineCapacityError("no free slot; release one first")
        slot = int(free[0])
        row = self._row(tokens)
        knobs = SamplingKnobs(1)
        knobs.set(0, temperature, top_k, top_p, min_p, repetition_penalty)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(seed))
        view = [(k[slot:slot + 1], v[slot:slot + 1])
                for k, v in self._cache]
        first, first_lp, echo, seen_row = _slot_prefill(
            self._model, row, int(prompt_len), view, knobs, generator)
        self._slot_insert(slot, int(prompt_len), seen_row, generator)
        first_tok = int(first[0])
        self._tok[slot] = first_tok
        self._active[slot] = True
        self._knobs.set(slot, temperature, top_k, top_p, min_p,
                        repetition_penalty)
        return slot, first_tok, float(first_lp[0]), echo.cpu().numpy()

    def _slot_insert(self, slot, prompt_len, seen_row, generator):
        """Rewind the slot's position to its true prompt length (the
        generation then overwrites the bucket padding) and install
        its seen-token row and generator."""
        self._row_pos[slot] = prompt_len
        self._seen[slot] = seen_row
        self._generators[slot] = generator

    @torch.inference_mode()
    def step(self):
        """Advance EVERY slot one token. Returns (tokens [slots] int64,
        logprobs [slots] f32) as numpy; entries for free slots are
        scratch. None when the pool is empty. Free rows step too, at
        a position clamped into the row, and their output is
        ignored."""
        if not self._active.any():
            return None
        pos = torch.as_tensor(np.minimum(self._row_pos, self.slot_len - 1),
                              device=self.device)
        tok = torch.as_tensor(self._tok, device=self.device)[:, None]
        raw = self._model(tok, self._cache, pos)[:, 0]
        nxt, lp = _slot_sample(raw, self._seen, self._knobs,
                               self._generators)
        self._seen[torch.arange(self.slots, device=self.device), nxt] = True
        self._row_pos += self._active
        toks = nxt.cpu().numpy()
        np.copyto(self._tok, toks, where=self._active)
        self.steps += 1
        self.row_steps += int(self._active.sum())
        return toks, lp.cpu().numpy()

    def release(self, slot):
        """Free a slot for the next admission. The row's cache content
        stays but is unreachable (admission overwrites it, the per-row
        mask hides it meanwhile); its sampling knobs reset to the
        no-op values."""
        self._active[slot] = False
        self._generators[slot] = None
        self._knobs.reset(slot)

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

"""Speculative decoding: a small draft LM proposes, the target LM
verifies k proposals in ONE cached forward.

Counterpart of container_engine_accelerators_tpu/models/speculative.py,
its loop written as a Python loop over explicit caches:

- each round, k draft steps from the last committed token propose k-1
  tokens (the k-th step only keys the draft cache), and the target
  scores [last | proposals] as one width-k chunk that attends the
  cache (``chunk_attends_cache``), so every column is the logits a
  single-token step would give;
- greedy: the longest prefix of proposals equal to the target's argmax
  commits, then the target's own token; sampling: proposal d commits
  with probability min(1, p(d)/q(d)), a rejection resamples from
  normalize(max(0, p - q)), a fully accepted round draws one bonus
  token from p; top_k, top_p and min_p transform p and q alike;
- the whole batch advances by the MINIMUM acceptance across rows;
- a rewind is the committed position handed to the next forward: the
  K/V written past it by rejected proposals stay in the cache, masked
  by the attention's ``k_pos <= q_pos`` (a ring's ``slot_pos`` holds
  their positions), until the next round rewrites them.

Greedy output equals ``decode()``'s token for token; sampled output
follows the target's filtered softmax(logits / T). Sampling draws from
an explicit ``torch.Generator`` (or injected uniforms, ``uniforms=``):
the JAX function's distribution, not its threefry numbers.

The prompt prefills (target and draft) are one-shot forwards on the
flash kernel; the draft steps and the verify chunks attend the cache
through the grouped product, as the JAX package runs them in XLA.

Either model may be a MoETransformerLM with drop-free routing
(capacity_factor * top_k >= num_experts): a dropping router scores a
token of a width-k chunk unlike a single-token step, and is refused.
"""

import inspect

import numpy as np
import torch

from .decode import (
    _gumbel_argmax,
    _mask_min_p,
    _mask_top_k_rows,
    _mask_top_p,
    _token_logprob,
    logits_of,
)
from .transformer import map_cache


def _takes_chunk_path(model):
    """Whether ``model.forward`` takes ``chunk_attends_cache`` (the
    verify chunk's path)."""
    try:
        params = inspect.signature(model.forward).parameters
    except (TypeError, ValueError, AttributeError):
        return False
    return "chunk_attends_cache" in params


def check_spec_models(model, draft_model):
    """Structural speculation preconditions, shared by
    ``speculative_decode`` and the server's construction-time check:
    both models take the chunk-attends-cache verify path, MoE routing
    is drop-free (capacity_factor * top_k >= num_experts: a dropping
    router scores a token of a width-k chunk unlike a single-token
    step), and the vocab sizes match."""
    for m, which in ((model, "target"), (draft_model, "draft")):
        if not _takes_chunk_path(m):
            raise ValueError(
                f"speculative decode does not support this {which} "
                f"model ({type(m).__name__}): it has no "
                f"chunk_attends_cache verify path")
        ne = int(getattr(m, "num_experts", 0) or 0)
        if ne and m.capacity_factor * m.top_k < ne:
            raise ValueError(
                f"speculative decode requires drop-free MoE routing "
                f"on the {which} model: capacity_factor "
                f"({m.capacity_factor}) * top_k ({m.top_k}) must be "
                f">= num_experts ({ne}) so verify chunks route "
                f"identically to single-token decode steps")
    if draft_model.vocab_size != model.vocab_size:
        raise ValueError(
            f"draft vocab {draft_model.vocab_size} != target vocab "
            f"{model.vocab_size}")


def _draw_source(generator, uniforms, device):
    """``draw(kind, shape)``: uniforms in [0, 1) from ``generator``
    (seed 0 when None), or from ``uniforms(kind, shape)`` when given.
    ``kind`` names the draw: "first" (the first token of a full-width
    prompt), "walk" (a step of a ragged prompt's walk), "draft" (a
    draft step's proposal), "accept" (a round's [B, k-1] accept test),
    "resid" (its [B, k-1, V] residual resamples) and "bonus" (its
    [B, V] bonus token), in the order the JAX function splits its keys
    for them."""
    if uniforms is not None:
        return lambda kind, shape: torch.tensor(
            np.asarray(uniforms(kind, shape)), dtype=torch.float32,
            device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return lambda kind, shape: torch.rand(shape, generator=generator,
                                          device=device)


def _spec_impl(model, draft_model, prompt, max_new_tokens, k, *, plen,
               eos_row, sample, temps, draw, active, logprobs, top_k,
               top_p, min_p, return_stats, prefix=None):
    """The speculation loop (JAX ``_spec_impl``). ``plen``: [B] true
    prompt lengths (None: full width, one-shot prefills); ``eos_row``,
    ``top_p``, ``min_p``, ``active``: [B] tensors or None (off);
    ``prefix``: (target cache, draft cache, p0) of a fanned-out prefix
    state, the prompt then being each row's suffix."""
    b, p = prompt.shape
    dev = prompt.device
    total = p + max_new_tokens + k          # slack for optimistic writes
    use_eos = eos_row is not None

    def scaled_filtered(logits, reps=1):
        """Temperature-scaled logits in f32 after top_k -> top_p ->
        min_p (decode's order); ``reps`` repeats the per-row knobs when
        the rows are B * reps verify columns."""
        scaled = logits.float() / temps.repeat_interleave(reps)[:, None]
        if top_k:
            scaled = _mask_top_k_rows(scaled, torch.full(
                scaled.shape[:1], top_k, device=dev))
        if top_p is not None:
            scaled = _mask_top_p(scaled, top_p.repeat_interleave(reps))
        if min_p is not None:
            scaled = _mask_min_p(scaled, min_p.repeat_interleave(reps))
        return scaled

    def dist(logits, reps=1):
        """The effective sampling distribution the accept ratio and
        the residual are defined over. [R, V] -> [R, V] f32."""
        return torch.softmax(scaled_filtered(logits, reps), dim=-1)

    def pick(logits, kind):
        if sample:
            return _gumbel_argmax(scaled_filtered(logits),
                                  draw(kind, tuple(logits.shape)))
        return torch.argmax(logits, dim=-1)

    if prefix is not None:
        # Caches given, prefilled with a shared p0-token prefix; both
        # suffix prefills are mid-cache chunks.
        t_cache, d_cache, p0 = prefix
    else:
        # A sliding-window model's ring is over-allocated by k slots
        # (ring_slack): a write at pos + W + k evicts the key at pos,
        # and writes never run more than k positions ahead of the
        # oldest query still to attend, so an evicted key is already
        # outside that query's (q - W, q] band. Rejected entries stay
        # masked by k_pos <= q_pos until the next round rewrites their
        # slot, before any query reaches their position.
        t_cache = model.init_cache(b, total, ring_slack=k)
        d_cache = draft_model.init_cache(b, total, ring_slack=k)
        p0 = 0
    mid = prefix is not None
    out = torch.zeros((b, total), dtype=torch.long, device=dev)
    lp = torch.zeros((b, total), dtype=torch.float32, device=dev)

    if plen is not None:
        # Rows diverge inside the padded prompt, so the padded region
        # is walked stepwise as decode() does (forced token while in
        # the prompt, a pick after), up to the uniform frontier p.
        padded = torch.nn.functional.pad(prompt, (0, 1))
        tok = prompt[:, 0]
        done = torch.zeros((b,), dtype=torch.bool, device=dev)
        walked, walked_lp = [], []
        for t in range(p):
            logits = logits_of(model(tok[:, None], t_cache, p0 + t))[:, 0]
            in_prompt = t + 1 < plen
            tok = torch.where(in_prompt, padded[:, t + 1],
                              pick(logits, "walk"))
            if use_eos:
                # decode's order: the done mask after prompt forcing;
                # a prompt-resident EOS never triggers.
                tok = torch.where(done, eos_row, tok)
                done = done | (~in_prompt & (tok == eos_row))
            walked.append(tok)
            if logprobs:
                walked_lp.append(_token_logprob(logits, tok))
        first = tok
        # The resolved prefix (prompt tokens and the target's picks
        # inside the padding) prefills the draft in one forward.
        resolved = torch.stack([prompt[:, 0]] + walked[:p - 1], dim=1)
        draft_model(resolved, d_cache, p0, chunk_attends_cache=mid)
        out[:, :p] = resolved
        if logprobs:
            lp[:, 1:p + 1] = torch.stack(walked_lp, dim=1)
    else:
        # Full-width prompts: one forward each; the target's last
        # logits give the first generated token (decode()'s fast
        # prefill).
        outs = logits_of(model(prompt, t_cache, p0,
                               chunk_attends_cache=mid))
        first = pick(outs[:, -1], "first")
        done = ((first == eos_row) if use_eos
                else torch.zeros((b,), dtype=torch.bool, device=dev))
        draft_model(prompt, d_cache, p0, chunk_attends_cache=mid)
        out[:, :p] = prompt
        if logprobs:
            pl = outs[:, :-1].float()
            chosen = torch.gather(pl, 2, prompt[:, 1:, None])[..., 0]
            lp[:, 1:p] = chosen - torch.logsumexp(pl, dim=-1)
            lp[:, p] = _token_logprob(outs[:, -1], first)
    out[:, p] = first

    if use_eos and active is not None:
        # Pad rows count as finished, so the early exit keys off the
        # real rows only.
        done = done | ~active
    n, last, rounds, accepted = 1, first, 0, 0
    # With logprobs every emitted position needs a real score, so the
    # loop runs to max_new_tokens as plain decode does.
    early_exit = use_eos and not logprobs
    while n < max_new_tokens and not (early_exit and bool(done.all())):
        # The invariant: both caches hold every committed token but
        # `last`, whose position is pos.
        start = p + n                 # first uncommitted output position
        pos = p0 + start - 1
        # Draft: k steps from `last`; a finished row proposes EOS
        # forever (decode's done chain), so the verify chunk matches
        # the committed stream on accepted prefixes. The k-th step's
        # token is discarded; the step keys d_{k-1}, without which a
        # fully accepted round would leave the draft a key short.
        tok, done_d, proposals, qs = last, done, [], []
        for j in range(k):
            logits = logits_of(draft_model(tok[:, None], d_cache,
                                           pos + j))[:, 0]
            tok = pick(logits, "draft")
            if use_eos:
                tok = torch.where(done_d, eos_row, tok)
                done_d = done_d | (tok == eos_row)
            proposals.append(tok)
            if sample and j < k - 1:
                qs.append(dist(logits))
        d = torch.stack(proposals[:k - 1], dim=1) if k > 1 else (
            torch.zeros((b, 0), dtype=torch.long, device=dev))
        # Verify: ONE width-k chunk at the position of `last`; column j
        # predicts the token after chunk position j.
        vl = logits_of(model(torch.cat([last[:, None], d], dim=1), t_cache,
                             pos, chunk_attends_cache=True))
        if sample:
            v = vl.shape[-1]
            pd = dist(vl.reshape(b * k, v), reps=k).reshape(b, k, v)
            qd = (torch.stack(qs, dim=1) if qs else
                  torch.zeros((b, 0, v), device=dev))
            p_of_d = torch.gather(pd[:, :k - 1], 2, d[..., None])[..., 0]
            q_of_d = torch.gather(qd, 2, d[..., None])[..., 0]
            ratio = p_of_d / torch.clamp(q_of_d, min=1e-20)
            accept = draw("accept", (b, k - 1)) < ratio
            resid = torch.clamp(pd[:, :k - 1] - qd, min=0.0)
            # Self-draft (p == q): the residual is all zero and never
            # drawn from (accept probability 1); p keeps the draw
            # finite.
            resid = torch.where(resid.sum(-1, keepdim=True) <= 0.0,
                                pd[:, :k - 1], resid)
            replacement = _gumbel_argmax(torch.log(resid),
                                         draw("resid", (b, k - 1, v)))
            bonus = _gumbel_argmax(torch.log(pd[:, k - 1]),
                                   draw("bonus", (b, v)))
            g = torch.cat([torch.where(accept, d, replacement),
                           bonus[:, None]], dim=1)
        else:
            g = torch.argmax(vl, dim=-1)
        if use_eos:
            # decode's done mask on the target's picks column by
            # column; sampling also auto-accepts finished rows (both
            # streams emit EOS there).
            acc_in = (torch.cat([accept, torch.ones((b, 1), dtype=torch.bool,
                                                    device=dev)], dim=1)
                      if sample else None)
            cols, acc_cols, done_cols, done_c = [], [], [], done
            for j in range(k):
                cj = torch.where(done_c, eos_row, g[:, j])
                if sample:
                    acc_cols.append(acc_in[:, j] | done_c)
                done_c = done_c | (cj == eos_row)
                cols.append(cj)
                done_cols.append(done_c)
            c = torch.stack(cols, dim=1)
            if sample:
                accept = torch.stack(acc_cols, dim=1)[:, :k - 1]
        else:
            c = g
        # The longest accepted prefix, uniform across the batch.
        match = (accept if sample else d == c[:, :k - 1]).long()
        if active is not None:
            # Pad rows auto-accept: their output is discarded, so they
            # never cap the real rows' acceptance.
            match = torch.where(active[:, None], match,
                                torch.ones_like(match))
        m = int(torch.cumprod(match, dim=1).sum(dim=1).min()) if k > 1 else 0
        nxt = c[:, m]
        if use_eos:
            done = done_cols[m]
        # Accepted proposals d[:, :m], then the committed token at the
        # first divergence; columns past m are overwritten by later
        # rounds, as the tokens are.
        out[:, start:start + k - 1] = d
        out[:, start + m] = nxt
        if logprobs:
            lpc = torch.gather(torch.log_softmax(vl.float(), dim=-1), 2,
                               c[..., None])[..., 0]
            lp[:, start:start + k - 1] = lpc[:, :k - 1]
            lp[:, start + m] = lpc[:, m]
        n, last = n + m + 1, nxt
        rounds, accepted = rounds + 1, accepted + m

    if early_exit:
        # Every row finished: the positions the loop never reached are
        # EOS by decode's keep-emitting contract (only done rows fill).
        fill = (torch.arange(total, device=dev)[None, :] >= p + n) & (
            done[:, None])
        out = torch.where(fill, eos_row[:, None], out)
    tokens = out[:, :p + max_new_tokens]
    result = (tokens, lp[:, :p + max_new_tokens]) if logprobs else tokens
    if return_stats:
        return result, {"rounds": rounds, "accepted_drafts": accepted,
                        "generated": n}
    return result


def _row_vector(value, b, name, dtype):
    """A scalar or [B] knob as a [B] numpy array (the JAX function's
    per-row rule and message)."""
    host = np.asarray(value, dtype).reshape(-1)
    if host.shape[0] not in (1, b):
        raise ValueError(
            f"{name} must be a scalar or one entry per row ({b}): got "
            f"shape {host.shape}")
    return np.broadcast_to(host, (b,))


def _prepare_and_run_spec(model, draft_model, prompt, max_new_tokens, *,
                          k, temperature, generator, top_k, top_p, min_p,
                          prompt_len, eos_id, active_rows, return_logprobs,
                          return_stats, uniforms, prefix=None):
    """Knob normalization and validation shared by the plain and the
    prefix forms (the JAX function's rules and messages). Variant
    selection is type-driven (None against given), never
    value-driven."""
    b, p = prompt.shape
    dev = prompt.device

    def on_dev(host, dtype):
        return torch.as_tensor(np.array(host), dtype=dtype,
                               device=dev)

    plen = None
    if prompt_len is not None:
        plen_host = _row_vector(prompt_len, b, "prompt_len", np.int64)
        if (plen_host < 1).any() or (plen_host > p).any():
            raise ValueError(
                f"prompt_len entries must be in 1..{p}: {plen_host}")
        plen = on_dev(plen_host, torch.long)
    t_host = _row_vector(temperature, b, "temperature", np.float32)
    if (t_host < 0).any():
        raise ValueError(f"temperatures must be >= 0: {t_host}")
    sample = bool((t_host > 0).any())
    if sample and not (t_host > 0).all():
        raise ValueError(
            "per-row temperatures must be all zero (greedy) or all "
            f"positive (sampling): {t_host}")
    eos_row = None
    if eos_id is not None:
        eos_host = _row_vector(eos_id, b, "eos_id", np.int64)
        if ((eos_host < -1) | (eos_host >= model.vocab_size)).any():
            raise ValueError(
                f"eos_id entries must be -1 (off) or in "
                f"0..{model.vocab_size - 1}: {eos_host}")
        eos_row = on_dev(eos_host, torch.long)
    top_k = int(top_k)
    if not 0 <= top_k <= model.vocab_size:
        raise ValueError(
            f"top_k must be in 0..{model.vocab_size}: {top_k}")
    tp = mp = None
    if top_p is not None:
        tp_host = _row_vector(top_p, b, "top_p", np.float32)
        if ((tp_host <= 0) | (tp_host > 1)).any():
            raise ValueError(f"top_p entries must be in (0, 1]: {tp_host}")
        tp = on_dev(tp_host, torch.float32)
    if min_p is not None:
        mp_host = _row_vector(min_p, b, "min_p", np.float32)
        if ((mp_host < 0) | (mp_host >= 1)).any():
            raise ValueError(f"min_p entries must be in [0, 1): {mp_host}")
        mp = on_dev(mp_host, torch.float32)
    if not sample:
        # Greedy ignores the filters, exactly as decode does.
        top_k, tp, mp = 0, None, None
    active = None
    if active_rows is not None:
        act_host = np.asarray(active_rows, bool).reshape(-1)
        if act_host.shape[0] != b:
            raise ValueError(
                f"active_rows must have one entry per row ({b}): got "
                f"shape {act_host.shape}")
        if not act_host.any():
            raise ValueError("active_rows must mark at least one row")
        active = on_dev(act_host, torch.bool)
    return _spec_impl(
        model, draft_model, prompt, max_new_tokens, k, plen=plen,
        eos_row=eos_row, sample=sample,
        temps=on_dev(t_host, torch.float32),
        draw=_draw_source(generator, uniforms, dev), active=active,
        logprobs=bool(return_logprobs), top_k=top_k, top_p=tp, min_p=mp,
        return_stats=return_stats, prefix=prefix)


@torch.inference_mode()
def speculative_decode(model, draft_model, prompt, max_new_tokens, *, k=4,
                       temperature=0.0, generator=None, top_k=0, top_p=None,
                       min_p=None, prompt_len=None, eos_id=None,
                       active_rows=None, return_logprobs=False,
                       return_stats=False, uniforms=None):
    """Decode of ``model`` accelerated by ``draft_model`` (both the
    port's TransformerLM, on one device), as the JAX function.

    Greedy (``temperature`` 0): the [B, P + max_new_tokens] int64
    tokens equal ``decode(model, prompt, max_new_tokens)``'s. Sampling
    (``temperature`` > 0, a scalar or [B], all rows > 0): rejection
    sampling, so each committed token follows the target's
    softmax(logits / T) after ``top_k`` (int, 0 off), ``top_p`` and
    ``min_p`` (scalars or [B], None off), drawn from ``generator`` (a
    torch.Generator on the model's device; seed 0 when None) or from
    ``uniforms(kind, shape)`` (see ``_draw_source``). Greedy ignores the
    filters, as decode does. The repetition penalty is not supported
    (it is stateful over the committed prefix).

    ``prompt_len`` (scalar or [B]) walks a right-padded prompt's padded
    region stepwise; ``eos_id`` (scalar or [B], -1 off) freezes a row
    on its EOS, and once every row finished the loop stops and fills
    EOS; ``active_rows`` ([B] bools) marks pad rows that auto-accept;
    ``return_logprobs`` adds the [B, P + max_new_tokens] f32 scores
    under the raw logits (decode's, with prompt echo; the EOS early
    exit is then off); ``return_stats`` adds {"rounds",
    "accepted_drafts", "generated"}. Sliding-window models (target,
    draft or both) run on rings of window + k slots.

    Needs P + max_new_tokens + k within both models' max_seq_len and a
    shared vocab."""
    if max_new_tokens < 1:
        raise ValueError("speculative decode needs max_new_tokens >= 1")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    check_spec_models(model, draft_model)
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, p = prompt.shape
    need = p + max_new_tokens + k
    for m, which in ((model, "target"), (draft_model, "draft")):
        if need > m.max_seq_len:
            raise ValueError(
                f"prompt {p} + max_new_tokens {max_new_tokens} + k "
                f"{k} exceeds {which} max_seq_len {m.max_seq_len}")
    return _prepare_and_run_spec(
        model, draft_model, prompt, max_new_tokens, k=k,
        temperature=temperature, generator=generator, top_k=top_k,
        top_p=top_p, min_p=min_p, prompt_len=prompt_len, eos_id=eos_id,
        active_rows=active_rows, return_logprobs=return_logprobs,
        return_stats=return_stats, uniforms=uniforms)


@torch.inference_mode()
def speculative_decode_with_prefix(model, draft_model, target_prefix_state,
                                   draft_prefix_state, prompt,
                                   max_new_tokens, *, k=4, temperature=0.0,
                                   generator=None, top_k=0, top_p=None,
                                   min_p=None, prompt_len=None, eos_id=None,
                                   active_rows=None, return_stats=False,
                                   uniforms=None):
    """Speculative decoding over shared-prefix caches, as the JAX
    function: ``prefill_prefix`` states of the target AND the draft
    over the same prefix tokens; ``prompt`` [B, P] holds each request's
    suffix, B a multiple of the prefix batch Bp, and request row
    bp * (B / Bp) + j continues prefix row bp. Returns the [B, P +
    max_new_tokens] suffix sequences, greedy equal to
    ``decode_with_prefix``'s; knobs as ``speculative_decode``. The
    states are left as they were. Both states must hold prefix +
    suffix + max_new_tokens + k tokens. Not supported:
    sliding-window models, logprobs, the repetition penalty."""
    if max_new_tokens < 1:
        raise ValueError("speculative decode needs max_new_tokens >= 1")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    check_spec_models(model, draft_model)
    for m, which in ((model, "target"), (draft_model, "draft")):
        if getattr(m, "attention_window", 0):
            raise ValueError(
                f"speculative_decode_with_prefix does not support "
                f"sliding-window models ({which}): the prefix ring "
                f"would need suffix-width + k extra slots")
    t_cache, t_plen, t_total = target_prefix_state
    d_cache, d_plen, d_total = draft_prefix_state
    if t_plen != d_plen:
        raise ValueError(
            f"target and draft prefix states disagree on prefix "
            f"length: {t_plen} vs {d_plen} — both must be "
            f"prefill_prefix states over the SAME prefix tokens")
    prompt = torch.as_tensor(prompt, device=model.device).long()
    b, p = prompt.shape
    prefix_b = t_cache[0][0].shape[0]
    if d_cache[0][0].shape[0] != prefix_b:
        raise ValueError(
            f"target and draft prefix states disagree on prefix "
            f"batch: {prefix_b} vs {d_cache[0][0].shape[0]}")
    if b % prefix_b:
        raise ValueError(
            f"request batch {b} must be a multiple of the prefix "
            f"batch {prefix_b}")
    need = t_plen + p + max_new_tokens + k
    for cap, which in ((t_total, "target"), (d_total, "draft")):
        if need > cap:
            raise ValueError(
                f"prefix {t_plen} + suffix {p} + max_new_tokens "
                f"{max_new_tokens} + k {k} = {need} overflows the "
                f"{which} prefix state's max_total_len {cap}")
    for m, which in ((model, "target"), (draft_model, "draft")):
        if need > m.max_seq_len:
            raise ValueError(
                f"prefix {t_plen} + suffix {p} + max_new_tokens "
                f"{max_new_tokens} + k {k} exceeds {which} "
                f"max_seq_len {m.max_seq_len}")
    fan = b // prefix_b

    def own(cache):
        # A copy the loop may write (the fan-out copies already).
        if fan > 1:
            return map_cache(lambda a: a.repeat_interleave(fan, dim=0),
                             cache)
        return map_cache(torch.clone, cache)

    return _prepare_and_run_spec(
        model, draft_model, prompt, max_new_tokens, k=k,
        temperature=temperature, generator=generator, top_k=top_k,
        top_p=top_p, min_p=min_p, prompt_len=prompt_len, eos_id=eos_id,
        active_rows=active_rows, return_logprobs=False,
        return_stats=return_stats, uniforms=uniforms,
        prefix=(own(t_cache), own(d_cache), int(t_plen)))

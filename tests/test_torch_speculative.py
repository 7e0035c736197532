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

"""The port's ``speculative_decode`` and ``speculative_decode_with_prefix``
against the JAX package's models/speculative.py, in f32 on the CPU: the
counterparts of tests/test_speculative.py on its own fixtures (the same
flax inits, sizes, seeds and prompts), the MoE cases aside.

Greedy: tokens and ``return_stats`` identical to the JAX function's,
and tokens equal to the port's ``decode()`` (``decode_with_prefix``).
Logprobs agree at 1e-4 (two layers of f32 reduction order). Sampling
draws from a torch.Generator, not threefry: tokens and stats are held
to the JAX function's on the JAX loop's own draws (``uniforms``,
reconstructed key for key by ``_JaxSpecUniforms``), and a generator's
draws to the target's exact marginals, as the JAX tests hold theirs.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu.models import speculative as jax_spec
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import speculative
from container_engine_accelerators_tpu_torch.models import transformer
from tests import torch_parity

LP_TOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _make(vocab=64, embed=32, layers=2, heads=4, seq=96, seed=0,
          **kwargs):
    """(flax model, params, the port's model): tests/test_speculative.py's
    ``_make``."""
    model, tree, config = torch_parity.flax_lm_of(
        seed, vocab_size=vocab, embed_dim=embed, num_layers=layers,
        num_heads=heads, max_seq_len=seq, **kwargs)
    return model, tree, torch_parity.port_lm(config, tree)


def _draft(**kwargs):
    return _make(**dict(dict(embed=16, layers=1, heads=2, seed=99),
                        **kwargs))


def _small(vocab=16, seed=0, **kw):
    return _make(vocab=vocab, embed=kw.pop("embed", 32),
                 layers=kw.pop("layers", 2), heads=kw.pop("heads", 4),
                 seq=32, seed=seed, **kw)


def _prompt(b, p, vocab=64, seed=7):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (b, p),
                                       0, vocab))


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=LP_TOL)


def _stats(stats):
    return {key: int(value) for key, value in stats.items()}


class _JaxSpecUniforms:
    """The uniforms the JAX function's loop draws, key for key: the
    first token splits ``rng``; a ragged walk splits ``rng`` once and
    its own key every step; each round splits the loop key five ways
    (draft, accept, resid, bonus), the draft steps split theirs every
    step; categorical draws are uniform(tiny, 1) and the accept test
    uniform(0, 1)."""

    def __init__(self, key, k):
        self.rng, self.k = key, k
        self.walk = self.loop = None
        self.drafts = 0

    def __call__(self, kind, shape):
        split = jax.random.split
        if kind == "first":
            self.rng, sub = split(self.rng)
        elif kind == "walk":
            if self.walk is None:
                self.rng, self.walk = split(self.rng)
            self.walk, sub = split(self.walk)
        elif kind == "draft":
            if self.drafts % self.k == 0:
                if self.loop is None:
                    self.loop = self.rng
                (self.loop, self.r_draft, self.r_accept, self.r_resid,
                 self.r_bonus) = split(self.loop, 5)
            self.drafts += 1
            self.r_draft, sub = split(self.r_draft)
        elif kind == "accept":
            return np.asarray(jax.random.uniform(self.r_accept, shape))
        else:
            sub = self.r_resid if kind == "resid" else self.r_bonus
        return np.asarray(jax.random.uniform(
            sub, shape, jnp.float32, jnp.finfo(jnp.float32).tiny, 1.0))


def _both(target, draft, prompt, n, *, jax_kwargs=None, **kwargs):
    """The JAX function and the port's on the same arguments (numpy
    values; ``jax_kwargs`` overrides the JAX side's), each returning
    (result, stats)."""
    (jm, jt, pm), (dm, dt, dp) = target, draft
    jkw = {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for key, v in kwargs.items() if key != "uniforms"}
    jkw.update(jax_kwargs or {})
    want = jax_spec.speculative_decode(jm, jt, dm, dt, jnp.asarray(prompt),
                                       n, return_stats=True, **jkw)
    got = speculative.speculative_decode(pm, dp, prompt, n,
                                         return_stats=True, **kwargs)
    return got, want


def _greedy_matches(target, draft, prompt, n, **kwargs):
    """Tokens and stats equal to the JAX function's; tokens equal to
    the port's decode() with the same knobs. Returns the stats."""
    (got, g_st), (want, w_st) = _both(target, draft, prompt, n, **kwargs)
    _same(got, want)
    assert g_st == _stats(w_st)
    knobs = {key: v for key, v in kwargs.items() if key != "k"}
    _same(got, decode.decode(target[2], prompt, n, **knobs))
    return g_st


def _sampled_matches(target, draft, prompt, n, key, k, **kwargs):
    """Tokens (and logprobs) and stats equal to the JAX function's on
    its own draws."""
    (got, g_st), (want, w_st) = _both(
        target, draft, prompt, n, k=k, jax_kwargs={"rng": key},
        uniforms=_JaxSpecUniforms(key, k), **kwargs)
    if kwargs.get("return_logprobs"):
        _same(got[0], want[0])
        _close(got[1], want[1])
    else:
        _same(got, want)
    assert g_st == _stats(w_st)
    return got, g_st


# -- greedy ---------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_spec_equals_greedy_disagreeing_draft(k):
    _greedy_matches(_make(seed=0), _draft(), _prompt(2, 8), 16, k=k)


def test_spec_equals_greedy_self_draft_full_acceptance():
    target = _make(seed=0)
    st = _greedy_matches(target, target, _prompt(1, 8), 20, k=4)
    assert st["accepted_drafts"] > 0
    assert st["rounds"] <= -(-20 // 4)


@pytest.mark.parametrize("kwargs", [
    {"pos_embedding": "rope"},
    {"num_kv_heads": 2},
    {"kv_cache_dtype": "int8"},
    {"pos_embedding": "rope", "num_kv_heads": 2, "kv_cache_dtype": "int8"},
], ids=["rope", "gqa", "int8", "rope_gqa_int8"])
def test_spec_equals_greedy_model_variants(kwargs):
    draft = _draft(seed=4, **{key: v for key, v in kwargs.items()
                              if key != "num_kv_heads"})
    _greedy_matches(_make(seed=3, **kwargs), draft, _prompt(2, 8), 12, k=3)


def test_spec_batch_uniform_progress():
    target = _make(seed=0)
    _greedy_matches(target, target, _prompt(4, 8, seed=11), 16, k=4)


def test_spec_validation():
    """The JAX function's messages; a dropping MoE router (read through
    getattr, as the JAX check reads it) is refused."""
    _, _, target = _make(seed=0)
    _, _, draft = _draft(seed=1)
    prompt = _prompt(1, 8)
    spec = speculative.speculative_decode
    with pytest.raises(ValueError, match="max_new_tokens >= 1"):
        spec(target, draft, prompt, 0)
    with pytest.raises(ValueError, match="k must be"):
        spec(target, draft, prompt, 4, k=0)
    _, _, vdraft = _draft(vocab=32, seed=1)
    with pytest.raises(ValueError, match="vocab"):
        spec(target, vdraft, prompt, 4)
    with pytest.raises(ValueError, match="max_seq_len"):
        spec(target, draft, prompt, 96, k=4)
    moe = _make(seed=0)[2]
    moe.num_experts, moe.top_k, moe.capacity_factor = 8, 2, 1.25
    with pytest.raises(ValueError, match="drop-free"):
        spec(moe, draft, prompt, 4)
    with pytest.raises(ValueError, match="drop-free"):
        spec(target, moe, prompt, 4)
    moe.capacity_factor = 4.0                       # drop-free: accepted
    speculative.check_spec_models(moe, draft)

    class NoChunk(torch.nn.Module):
        vocab_size = 64

        def forward(self, tokens, cache=None, index=None):
            return tokens

    with pytest.raises(ValueError, match="chunk_attends_cache verify"):
        speculative.check_spec_models(NoChunk(), draft)


def test_spec_equals_greedy_ragged_prompts():
    target, draft = _make(seed=0), _draft(seed=9)
    prompt = _prompt(3, 8, seed=13)
    plen = np.array([3, 8, 5], np.int32)
    for d in (draft, target):
        _greedy_matches(target, d, prompt, 12, k=4, prompt_len=plen)


def test_spec_ragged_validation():
    _, _, target = _make(seed=0)
    _, _, draft = _draft(seed=9)
    spec = speculative.speculative_decode
    with pytest.raises(ValueError, match="prompt_len"):
        spec(target, draft, _prompt(2, 8), 4, prompt_len=np.array([0, 8]))
    with pytest.raises(ValueError, match="prompt_len"):
        spec(target, draft, _prompt(2, 8), 4, prompt_len=9)
    with pytest.raises(ValueError, match="one entry per row"):
        spec(target, draft, _prompt(3, 8), 4, prompt_len=np.array([3, 5]))


def _eos_token(port, prompt, n=20):
    """A token the greedy generation emits (the JAX tests' helper)."""
    gen = decode.decode(port, prompt, n)[:, prompt.shape[1]:].numpy()
    return collections.Counter(gen.flatten().tolist()).most_common(1)[0][0]


def test_spec_equals_greedy_with_eos():
    target, draft = _make(seed=0), _draft(seed=9)
    prompt = _prompt(3, 8, seed=13)
    eos = _eos_token(target[2], prompt)
    for eos_arg in (eos, np.array([eos, -1, eos], np.int32)):
        for d in (draft, target):
            _greedy_matches(target, d, prompt, 20, k=4, eos_id=eos_arg)
    _greedy_matches(target, draft, prompt, 20, k=4, eos_id=eos,
                    prompt_len=np.array([3, 8, 5], np.int32))


def test_spec_eos_early_exit():
    """Once every row finished the loop stops: generated < the budget
    (the JAX test's 40 new tokens)."""
    target = _make(seed=0)
    prompt = _prompt(2, 8, seed=13)
    eos = _eos_token(target[2], prompt)
    st = _greedy_matches(target, target, prompt, 40, k=4, eos_id=eos)
    assert st["generated"] < 40, st


def test_spec_eos_validation():
    _, _, target = _make(seed=0)
    _, _, draft = _draft(seed=9)
    prompt = _prompt(2, 8)
    for bad in (np.array([1, 2, 3]), 64):
        with pytest.raises(ValueError, match="eos_id"):
            speculative.speculative_decode(target, draft, prompt, 4,
                                           eos_id=bad)


# -- rejection sampling -----------------------------------------------------


def _logits(port, seqs):
    with torch.inference_mode():
        return port(torch.as_tensor(np.asarray(seqs)).long())[:, -1].float()


def _marginals(port, prompt, temperature, top_p=None):
    """Exact marginals of ancestral sampling from softmax(logits / T)
    (after the top_p mask when given) at the first three generated
    positions, by enumerating every prefix (the JAX tests'
    ``_marginals`` / ``_filtered_marginals``)."""
    v = port.vocab_size

    def probs(seqs):
        scaled = _logits(port, seqs) / temperature
        if top_p is not None:
            scaled = decode._mask_top_p(scaled, torch.full(
                (scaled.shape[0],), top_p))
        return torch.softmax(scaled, dim=-1).numpy()

    p1 = probs(prompt)[0]
    toks = np.arange(v, dtype=np.int32)
    cond2 = probs(np.concatenate([np.repeat(prompt, v, 0), toks[:, None]],
                                 1))
    cond3 = probs(np.concatenate(
        [np.repeat(prompt, v * v, 0), np.repeat(toks, v)[:, None],
         np.tile(toks, v)[:, None]], 1)).reshape(v, v, v)
    return p1, p1 @ cond2, np.einsum("a,ab,abv->v", p1, cond2, cond3)


def _tv(a, b):
    return 0.5 * float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def _empirical(target, draft, prompt, seeds, seed0, **kwargs):
    v = target.vocab_size
    batch = np.repeat(prompt, 128, 0)
    counts = np.zeros((3, v))
    for s in range(seeds):
        out = speculative.speculative_decode(
            target, draft, batch, 3, k=4,
            generator=torch.Generator().manual_seed(seed0 + s), **kwargs)
        gen = out[:, prompt.shape[1]:].numpy()
        for j in range(3):
            counts[j] += np.bincount(gen[:, j], minlength=v)
    return counts / counts.sum(axis=1, keepdims=True)


def test_spec_sampling_matches_target_distribution():
    """Committed tokens follow the TARGET's softmax(logits/T) at the
    first three generated positions (positions 2-3 ride the accept and
    residual draws), not the draft's (TV > 0.25 apart): ~4k samples
    from generators, the JAX test's bounds."""
    _, _, target = _small(seed=0)
    _, _, draft = _small(embed=16, layers=1, heads=2, seed=99)
    prompt = np.array([[1, 2, 3, 4]], np.int32)
    p = _marginals(target, prompt, 1.0)
    d = _marginals(draft, prompt, 1.0)
    assert _tv(p[1], d[1]) > 0.25 and _tv(p[2], d[2]) > 0.25
    emp = _empirical(target, draft, prompt, 32, 1000, temperature=1.0)
    for j in range(3):
        assert _tv(emp[j], p[j]) < 0.08, (j, _tv(emp[j], p[j]))
    assert _tv(emp[1], d[1]) > 0.25 and _tv(emp[2], d[2]) > 0.25


def test_spec_filtered_sampling_matches_filtered_target():
    """top_p 0.7 speculation follows the target's NUCLEUS-filtered
    softmax, neither the unfiltered target's nor the draft's."""
    _, _, target = _small(seed=0)
    _, _, draft = _small(embed=16, layers=1, heads=2, seed=99)
    prompt = np.array([[1, 2, 3, 4]], np.int32)
    f = _marginals(target, prompt, 1.0, top_p=0.7)
    u = _marginals(target, prompt, 1.0)
    d = _marginals(draft, prompt, 1.0, top_p=0.7)
    assert _tv(f[1], u[1]) > 0.15 and _tv(f[2], u[2]) > 0.1
    assert _tv(f[1], d[1]) > 0.25 and _tv(f[2], d[2]) > 0.25
    emp = _empirical(target, draft, prompt, 32, 3000, temperature=1.0,
                     top_p=0.7)
    for j in range(3):
        assert _tv(emp[j], f[j]) < 0.08, (j, _tv(emp[j], f[j]))
    assert _tv(emp[1], u[1]) > 0.1 and _tv(emp[1], d[1]) > 0.2


@pytest.mark.parametrize("case", [
    dict(temperature=1.0),
    dict(temperature=np.array([0.7, 1.3], np.float32)),
    dict(temperature=1.0, top_k=4),
    dict(temperature=1.0, top_p=0.8),
    dict(temperature=1.0, min_p=0.1),
    dict(temperature=1.0, top_k=8, top_p=0.9, min_p=0.05),
    dict(temperature=1.0, eos_id=3),
    dict(temperature=1.0, prompt_len=np.array([5, 6], np.int32)),
    dict(temperature=0.9, return_logprobs=True),
    dict(temperature=1e-5),
], ids=["plain", "per_row_t", "top_k", "top_p", "min_p", "filters", "eos",
        "ragged", "logprobs", "tiny_t"])
def test_spec_sampling_matches_jax_on_its_draws(case):
    """The rejection-sampling loop on the JAX loop's draws: per-row
    temperatures, each filter and all three, EOS, a ragged walk, scores,
    and T -> 0 (the greedy limit)."""
    target = _small(seed=0)
    draft = _small(embed=16, layers=1, heads=2, seed=99)
    prompt = _prompt(2, 6, vocab=16)
    _sampled_matches(target, draft, prompt, 12, jax.random.PRNGKey(5), 3,
                     **case)


def test_spec_sampling_self_draft_accepts_everything():
    """p == q: every proposal is accepted, on the JAX loop's draws and
    on a generator's."""
    target = _small(seed=0)
    prompt = _prompt(2, 6, vocab=16)
    out, st = _sampled_matches(target, target, prompt, 12,
                               jax.random.PRNGKey(3), 4, temperature=0.7)
    assert st["accepted_drafts"] == 3 * st["rounds"], st
    assert tuple(out.shape) == (2, 18)
    for kw in ({}, {"top_p": 0.9}):
        _, st = speculative.speculative_decode(
            target[2], target[2], prompt, 9, k=4, temperature=0.8,
            generator=torch.Generator().manual_seed(7), return_stats=True,
            **kw)
        assert st["accepted_drafts"] == 3 * st["rounds"], st


def test_spec_sampling_generator_structure():
    """A generator's draws: reproducible, seed-sensitive, the EOS
    keep-emitting contract, a ragged prompt's true region untouched,
    top_k 1 and T -> 0 equal to greedy decode()."""
    _, _, target = _small(seed=0)
    _, _, draft = _small(embed=16, layers=1, heads=2, seed=99)
    prompt = _prompt(2, 6, vocab=16)
    spec = speculative.speculative_decode

    def run(seed, **kw):
        return spec(target, draft, prompt, kw.pop("n", 10), k=4,
                    temperature=kw.pop("temperature", 1.0),
                    generator=torch.Generator().manual_seed(seed), **kw)

    _same(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    for kw in ({"top_k": 4}, {"top_p": 0.8}, {"min_p": 0.1},
               {"top_k": 8, "top_p": 0.9, "min_p": 0.05}):
        _same(run(7, **kw), run(7, **kw))
    greedy = decode.decode(target, prompt, 10)
    _same(run(0, temperature=1e-5), greedy)
    _same(run(7, top_k=1), greedy)
    out = run(11, n=20, eos_id=3).numpy()
    for row in out[:, 6:]:
        hits = np.flatnonzero(row == 3)
        if hits.size:
            assert (row[hits[0]:] == 3).all(), row
    ragged = _prompt(2, 8, vocab=16)
    plen = np.array([5, 8], np.int32)
    out = spec(target, draft, ragged, 8, k=4, temperature=1.0,
               generator=torch.Generator().manual_seed(12),
               prompt_len=plen).numpy()
    assert out.shape == (2, 16)
    for r, n in enumerate(plen):
        _same(out[r, :n], ragged[r, :n])


def test_spec_sampling_validation():
    _, _, target = _small(seed=0)
    _, _, draft = _small(embed=16, layers=1, heads=2, seed=99)
    prompt = _prompt(2, 6, vocab=16)
    spec = speculative.speculative_decode
    with pytest.raises(ValueError, match="all zero .* or all"):
        spec(target, draft, prompt, 4, temperature=np.array([0.0, 1.0]))
    with pytest.raises(ValueError, match=">= 0"):
        spec(target, draft, prompt, 4, temperature=-1.0)
    with pytest.raises(ValueError, match="temperature must be"):
        spec(target, draft, prompt, 4, temperature=np.ones((3,)))
    with pytest.raises(ValueError, match="top_p"):
        spec(target, draft, prompt, 4, temperature=1.0, top_p=0.0)
    with pytest.raises(ValueError, match="min_p"):
        spec(target, draft, prompt, 4, temperature=1.0, min_p=1.0)
    with pytest.raises(ValueError, match="top_k"):
        spec(target, draft, prompt, 4, temperature=1.0, top_k=17)
    # Greedy ignores the filters, as decode() does.
    _same(spec(target, draft, prompt, 6, k=3, top_k=3, top_p=0.9),
          decode.decode(target, prompt, 6))


# -- active_rows ----------------------------------------------------------


def test_spec_active_rows_pad_cannot_gate_real_rows():
    """A masked run behaves exactly like a run over the active rows
    alone (tokens and stats); unmasked, the pad rows do cap acceptance
    under sampling (shown on the JAX loop's draws, where the JAX test
    shows it)."""
    target, draft = _make(seed=0), _draft()
    real = _prompt(1, 8, seed=21)
    padded = np.concatenate([real, np.zeros((3, 8), np.int32)], axis=0)
    active = np.array([True, False, False, False])
    alone, st_alone = speculative.speculative_decode(
        target[2], draft[2], real, 16, k=4, return_stats=True)
    (masked, st_masked), (want, w_st) = _both(
        target, draft, padded, 16, k=4, active_rows=active)
    _same(masked, want)
    assert st_masked == _stats(w_st)
    _same(masked[0], alone[0])
    assert st_masked["rounds"] == st_alone["rounds"]
    assert st_masked["accepted_drafts"] == st_alone["accepted_drafts"]
    key = jax.random.PRNGKey(77)
    _, st_m = _sampled_matches(target, draft, padded, 16, key, 4,
                               temperature=1.0, active_rows=active)
    _, st_u = _sampled_matches(target, draft, padded, 16, key, 4,
                               temperature=1.0)
    assert st_u["accepted_drafts"] < st_m["accepted_drafts"]
    assert st_m["rounds"] < st_u["rounds"]


def test_spec_active_rows_output_identity_all_modes():
    target, draft = _make(seed=0), _draft()
    prompt = _prompt(2, 8, seed=22)
    padded = np.concatenate([prompt, np.zeros((2, 8), np.int32)], axis=0)
    active = np.array([True, True, False, False])
    got = speculative.speculative_decode(target[2], draft[2], padded, 12,
                                         k=4, active_rows=active)
    _same(got[:2], decode.decode(target[2], prompt, 12))
    _sampled_matches(target, draft, padded, 8, jax.random.PRNGKey(6), 3,
                     temperature=1.0, active_rows=active)
    eos = int(decode.decode(target[2], prompt, 1)[0, -1])
    (out, _), (want, _) = _both(target, draft, padded, 16, k=4, eos_id=eos,
                                active_rows=active)
    _same(out, want)
    for row in out[:2, 8:].numpy():
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all(), row


def test_spec_active_rows_validation():
    _, _, target = _make(seed=0)
    _, _, draft = _draft()
    prompt = _prompt(2, 8)
    with pytest.raises(ValueError, match="one entry per row"):
        speculative.speculative_decode(target, draft, prompt, 4,
                                       active_rows=[True])
    with pytest.raises(ValueError, match="at least one row"):
        speculative.speculative_decode(target, draft, prompt, 4,
                                       active_rows=[False, False])


# -- logprobs ---------------------------------------------------------------


def test_spec_logprobs_match_decode_greedy():
    """Scores of the committed stream come from the verify logits and
    equal decode()'s (and the JAX function's), full width and ragged;
    with EOS the early exit is off and forced EOS scores as decode's."""
    target, draft = _make(seed=0), _draft()
    prompt = _prompt(2, 8)
    eos = int(decode.decode(target[2], prompt, 1)[0, -1])
    for k, n, kw in ((4, 12, {}),
                     (3, 12, {"prompt_len": np.array([3, 8], np.int32)}),
                     (4, 16, {"eos_id": eos})):
        (got, g_st), (want, w_st) = _both(target, draft, prompt, n, k=k,
                                          return_logprobs=True, **kw)
        ref = decode.decode(target[2], prompt, n, return_logprobs=True,
                            **kw)
        _same(got[0], want[0])
        _same(got[0], ref[0])
        _close(got[1], want[1])
        _close(got[1], ref[1])
        assert g_st == _stats(w_st)
        if "eos_id" in kw:
            assert g_st["generated"] >= n


def test_spec_logprobs_sampling_self_consistent():
    """Sampled scores equal the target's own teacher-forced log-softmax
    of the emitted sequence under the raw logits."""
    _, _, target = _make(vocab=16, seed=0)
    _, _, draft = _draft(vocab=16)
    seq, lps = speculative.speculative_decode(
        target, draft, _prompt(2, 6, vocab=16), 10, k=3, temperature=0.9,
        generator=torch.Generator().manual_seed(5), return_logprobs=True)
    with torch.inference_mode():
        lsm = torch.log_softmax(target(seq).float(), dim=-1)
    want = torch.gather(lsm[:, :-1], 2, seq[:, 1:, None])[..., 0]
    _close(lps[:, 1:], want)
    assert float(lps[0, 0]) == 0.0


# -- sliding window: rings of W + k slots -------------------------------------

WINDOWS = [6, 8, 24]


@pytest.mark.parametrize("window", WINDOWS)
def test_spec_windowed_target_equals_windowed_greedy(window):
    """A windowed target beside a dense draft (k 1, 2, 4), a windowed
    draft beside a dense target, and both windowed (the self-draft at
    full acceptance: the ring rewinds at the deepest optimistic
    write). The rings hold W + k slots (``ring_slack``)."""
    target = _make(seed=0, attention_window=window)
    dense, draft = _make(seed=0), _draft()
    prompt = _prompt(2, 8)
    for k in (1, 2, 4):
        _greedy_matches(target, draft, prompt, 24, k=k)
    _greedy_matches(dense, _draft(attention_window=window), prompt, 24,
                    k=4)
    st = _greedy_matches(target, target, prompt[:1], 24, k=4)
    assert st["accepted_drafts"] > 0 and st["rounds"] <= -(-24 // 4)


def test_spec_windowed_ring_holds_window_plus_k(monkeypatch):
    """Both caches are rings of min(total, W + k) slots."""
    _, _, target = _make(seed=0, attention_window=8)
    _, _, draft = _draft(attention_window=6)
    shapes = []
    real = transformer.TransformerLM.init_cache

    def spy(self, *args, **kwargs):
        cache = real(self, *args, **kwargs)
        shapes.append(tuple(cache[0][0].shape[:2]))
        return cache

    monkeypatch.setattr(transformer.TransformerLM, "init_cache", spy)
    speculative.speculative_decode(target, draft, _prompt(1, 8), 20, k=4)
    assert shapes == [(1, 12), (1, 10)]


@pytest.mark.parametrize("window", WINDOWS)
def test_spec_windowed_ragged_eos_and_composition(window):
    """Windowed speculation with ragged prompts, with EOS, and on GQA +
    rope + int8 + the window (both models)."""
    target, draft = _make(seed=0, attention_window=window), _draft()
    prompt = _prompt(3, 8, seed=5)
    plen = np.array([8, 3, 6], np.int32)
    _greedy_matches(target, draft, prompt, 20, k=4, prompt_len=plen)
    eos = int(decode.decode(target[2], prompt, 20)[0, 10 + 8])
    _greedy_matches(target, draft, prompt, 20, k=4, eos_id=eos)
    options = dict(num_kv_heads=2, pos_embedding="rope",
                   kv_cache_dtype="int8", attention_window=window)
    _greedy_matches(_make(seed=0, **options), _draft(**options),
                    _prompt(2, 8), 24, k=4)


def test_spec_windowed_logprobs_and_sampling():
    target, draft = _make(seed=0, attention_window=8), _draft()
    prompt = _prompt(2, 8)
    (got, _), (want, _) = _both(target, draft, prompt, 20, k=4,
                                return_logprobs=True)
    _same(got[0], want[0])
    _same(got[0], decode.decode(target[2], prompt, 20))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=2e-4)
    _sampled_matches(target, draft, prompt[:1], 16, jax.random.PRNGKey(3),
                     4, temperature=1.0)
    _same(speculative.speculative_decode(
        target[2], draft[2], prompt[:1], 16, k=4, temperature=1e-6,
        generator=torch.Generator().manual_seed(3)),
        decode.decode(target[2], prompt[:1], 16))


def test_rewind_masks_stale_entries_flat_and_ring():
    """A rewind is the committed position handed to the next forward:
    K/V written past it (rejected proposals) stay masked by k_pos <=
    q_pos until rewritten, on the flat cache and on the ring (its
    slot_pos holds their positions). A chunk written at 8..11 and a
    step from 9 give the logits of a clean cache's step from 9."""
    for options in ({}, {"attention_window": 6}):
        _, _, port = _make(seed=0, **options)
        prompt = torch.as_tensor(_prompt(1, 9)).long()
        junk = torch.as_tensor(_prompt(1, 4, seed=3)).long()
        with torch.inference_mode():
            stale = port.init_cache(1, 20, ring_slack=4)
            clean = port.init_cache(1, 20, ring_slack=4)
            port(prompt[:, :8], stale, 0)
            port(prompt[:, :8], clean, 0)
            port(junk, stale, 8, chunk_attends_cache=True)
            got = port(prompt[:, 8:9], stale, 8)
            want = port(prompt[:, 8:9], clean, 8)
        _close(got, want)


# -- the shared-prefix form -------------------------------------------------


def _prefix_states(target, draft, prefix, max_total):
    states = []
    for jm, jt, pm in (target, draft):
        states.append((
            jax_decode.prefill_prefix(jm, jt, jnp.asarray(prefix),
                                      max_total_len=max_total),
            decode.prefill_prefix(pm, prefix, max_total_len=max_total)))
    return states


def _prefix_matches(target, draft, prefix, suffixes, n, max_total, *,
                    jax_kwargs=None, **kwargs):
    """speculative_decode_with_prefix on both sides: tokens and stats
    equal; the states untouched. Returns (tokens, stats)."""
    (jt_state, pt_state), (jd_state, pd_state) = _prefix_states(
        target, draft, prefix, max_total)
    jkw = {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for key, v in kwargs.items() if key != "uniforms"}
    jkw.update(jax_kwargs or {})
    want, w_st = jax_spec.speculative_decode_with_prefix(
        target[0], target[1], draft[0], draft[1], jt_state, jd_state,
        jnp.asarray(suffixes), n, return_stats=True, **jkw)
    before = [a.clone() for layer in pt_state[0] for a in layer]
    got, g_st = speculative.speculative_decode_with_prefix(
        target[2], draft[2], pt_state, pd_state, suffixes, n,
        return_stats=True, **kwargs)
    _same(got, want)
    assert g_st == _stats(w_st)
    assert all(torch.equal(a, b) for a, b in zip(
        before, [a for layer in pt_state[0] for a in layer]))
    return got, g_st, pt_state


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_prefix_equals_decode_with_prefix(k):
    target, draft = _make(seed=0), _draft()
    prefix, suffixes = _prompt(1, 6, seed=21), _prompt(2, 5, seed=22)
    got, _, state = _prefix_matches(target, draft, prefix, suffixes, 16,
                                    6 + 5 + 16 + k, k=k)
    _same(got, decode.decode_with_prefix(target[2], state, suffixes, 16))


def test_spec_prefix_self_draft_full_acceptance_and_fan_out():
    target = _make(seed=0)
    prefix, suffixes = _prompt(1, 6, seed=23), _prompt(3, 4, seed=24)
    got, st, state = _prefix_matches(target, target, prefix, suffixes, 20,
                                     6 + 4 + 20 + 4, k=4)
    _same(got, decode.decode_with_prefix(target[2], state, suffixes, 20))
    assert st["accepted_drafts"] > 0 and st["rounds"] <= -(-20 // 4)


def test_spec_prefix_ragged_eos_and_composition():
    target, draft = _make(seed=0), _draft()
    prefix, suffixes = _prompt(1, 6, seed=25), _prompt(3, 5, seed=26)
    plen = np.array([5, 2, 4], np.int32)
    got, _, state = _prefix_matches(target, draft, prefix, suffixes, 14,
                                    6 + 5 + 14 + 4, k=4, prompt_len=plen)
    _same(got, decode.decode_with_prefix(target[2], state, suffixes, 14,
                                         prompt_len=plen))
    eos = int(got[0, 7])
    _prefix_matches(target, draft, prefix, suffixes, 14, 6 + 5 + 14 + 4,
                    k=4, eos_id=eos)
    options = dict(num_kv_heads=2, pos_embedding="rope",
                   kv_cache_dtype="int8")
    _prefix_matches(_make(seed=3, **options), _draft(seed=4, **{
        key: v for key, v in options.items() if key != "num_kv_heads"}),
        _prompt(1, 6, seed=27), _prompt(2, 4, seed=28), 12, 6 + 4 + 12 + 3,
        k=3)


def test_spec_prefix_sampling_on_jax_draws_and_greedy_limit():
    target, draft = _make(seed=0), _draft()
    prefix, suffixes = _prompt(1, 6, seed=29), _prompt(2, 4, seed=30)
    key = jax.random.PRNGKey(5)
    _prefix_matches(target, draft, prefix, suffixes, 12, 6 + 4 + 12 + 4,
                    k=4, temperature=1.0, jax_kwargs={"rng": key},
                    uniforms=_JaxSpecUniforms(key, 4))
    _, _, state = _prefix_matches(target, draft, prefix, suffixes, 12,
                                  6 + 4 + 12 + 4, k=4, temperature=1e-6,
                                  jax_kwargs={"rng": key},
                                  uniforms=_JaxSpecUniforms(key, 4))
    (_, pt_state), (_, pd_state) = _prefix_states(target, draft, prefix,
                                                  6 + 4 + 12 + 4)
    _same(speculative.speculative_decode_with_prefix(
        target[2], draft[2], pt_state, pd_state, suffixes, 12, k=4,
        temperature=1e-6, generator=torch.Generator().manual_seed(5)),
        decode.decode_with_prefix(target[2], state, suffixes, 12))


def test_spec_prefix_validation():
    _, _, target = _make(seed=0)
    _, _, draft = _draft()
    prefix, suffixes = _prompt(1, 6, seed=31), _prompt(2, 4, seed=32)
    t_state = decode.prefill_prefix(target, prefix, max_total_len=40)
    d_state = decode.prefill_prefix(draft, prefix, max_total_len=40)
    spec = speculative.speculative_decode_with_prefix
    d_short = decode.prefill_prefix(draft, prefix[:, :4], max_total_len=40)
    with pytest.raises(ValueError, match="prefix length"):
        spec(target, draft, t_state, d_short, suffixes, 8)
    with pytest.raises(ValueError, match="overflows"):
        spec(target, draft, t_state, d_state, suffixes, 40)
    _, _, wtarget = _make(seed=0, attention_window=8)
    wt_state = decode.prefill_prefix(wtarget, prefix, max_total_len=40)
    with pytest.raises(ValueError, match="sliding-window"):
        spec(wtarget, draft, wt_state, d_state, suffixes, 8)
    prefix2 = _prompt(2, 6, seed=34)
    t2 = decode.prefill_prefix(target, prefix2, max_total_len=40)
    d2 = decode.prefill_prefix(draft, prefix2, max_total_len=40)
    with pytest.raises(ValueError, match="multiple"):
        spec(target, draft, t2, d2, _prompt(3, 4, seed=33), 8)
    with pytest.raises(ValueError, match="prefix batch"):
        spec(target, draft, t2, d_state, _prompt(2, 4, seed=33), 8)

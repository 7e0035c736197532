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

"""The slot engine's speculation (draft arena, width-k verify) against
the JAX engine's, on both pools, in f32 on the CPU.

The JAX ``SlotDecodeEngine(draft_model=..., spec_k=...)`` and the
port's run the same script side by side. After every ``admit``,
``step`` and ``release`` they hold the same step output (``toks`` and
``counts`` exact, ``lps`` at 1e-4: two layers of f32 reduction order),
the same draft tables and draft free list, the same five speculation
counters, the same per-row gate state, and on the paged pool the same
block tables and ``kv_block_stats()`` (the draft arena's fields
included). The draft's holes (the position of the newest proposal
after a fully accepted step, never keyed) hold the same content on
both sides: the dense pool zeroes the row at admission, the paged
arena reuses blocks in the same free-list order.

The ledger replay at the end runs PERF_LEDGER.json's ``spec_check``
trace (tools/bench_serving_occupancy.py's trace, baseline and greedy
check) on the port's engine and on the JAX engine in the same process.
"""

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import TransformerLM
from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import speculative
from tests import torch_parity
from tests.conftest import REPO_ROOT

_TOOLS = os.path.join(REPO_ROOT, "tools")
if _TOOLS not in sys.path:
    sys.path.append(_TOOLS)  # append: tools/ must not shadow packages
import bench_serving_occupancy as occupancy  # noqa: E402

LP_TOL = 1e-4
COUNTERS = ("spec_steps", "spec_row_steps", "spec_proposed",
            "spec_accepted", "draft_prefills")
POOLS = ["dense", "paged"]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arr(*tokens):
    return np.array(tokens, np.int32)


def _models(variant="rope_gqa", draft="self", **options):
    """(flax target, its tree, the port's target, flax draft, its tree,
    the port's draft). ``draft``: "self" (the target itself) or a
    variant name (that variant's model from another seed)."""
    model, tree, config = torch_parity.flax_lm(variant)
    if options:
        model, config = model.clone(**options), dict(config, **options)
    port = torch_parity.port_lm(config, tree)
    if draft == "self":
        return model, tree, port, model, tree, port
    dmodel, dtree, dconfig = torch_parity.flax_lm(draft, seed=5)
    return (model, tree, port, dmodel, dtree,
            torch_parity.port_lm(dconfig, dtree))


class SpecPair:
    """A JAX engine and a port engine with a draft, built alike, driven
    alike; every operation is followed by ``check``."""

    def __init__(self, variant="rope_gqa", draft="self", options=None,
                 **kwargs):
        (model, tree, self.port, dmodel, dtree,
         dport) = _models(variant, draft, **(options or {}))
        self.want = jax_decode.SlotDecodeEngine(
            model, tree, draft_model=dmodel, draft_params=dtree, **kwargs)
        self.got = decode.SlotDecodeEngine(self.port, draft_model=dport,
                                           **kwargs)
        self.out = {}     # slot -> committed tokens since admission
        self.check()

    def check(self):
        got, want = self.got, self.want
        assert got.paged == want.paged
        assert got.free_slots() == want.free_slots()
        for name in COUNTERS:
            assert getattr(got, name) == getattr(want, name), name
        np.testing.assert_array_equal(got._spec_row, want._spec_row)
        np.testing.assert_array_equal(got._span_limit, want._span_limit)
        assert got.spec_kv_arena_bytes == want.spec_kv_arena_bytes
        assert got.kv_block_stats() == want.kv_block_stats()
        if got.paged:
            np.testing.assert_array_equal(got._tables, want._tables)
            np.testing.assert_array_equal(got._draft_tables,
                                          want._draft_tables)
            assert list(got._draft_free) == list(want._draft_free)
            np.testing.assert_array_equal(got._pool.ref, want._pool.ref)
            assert got._pool.committed == want._pool.committed
        assert got.pool_leak_report() == want.pool_leak_report()

    def admit(self, row, plen, **kwargs):
        w = self.want.admit(row, plen, **kwargs)
        g = self.got.admit(row, plen, **kwargs)
        assert g[0] == w[0] and g[1] == w[1]
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=LP_TOL)
        self.check()
        self.out[g[0]] = [g[1]]
        return g[0]

    def step(self, n=1):
        for _ in range(n):
            w_tok, w_lp, w_cnt = (np.asarray(a) for a in self.want.step())
            g_tok, g_lp, g_cnt = self.got.step()
            for slot, seq in self.out.items():
                assert g_cnt[slot] == w_cnt[slot], slot
                c = int(g_cnt[slot])
                np.testing.assert_array_equal(g_tok[slot, :c],
                                              w_tok[slot, :c])
                np.testing.assert_allclose(g_lp[slot, :c], w_lp[slot, :c],
                                           rtol=0, atol=LP_TOL)
                seq.extend(int(t) for t in g_tok[slot, :c])
            self.check()

    def release(self, slot):
        self.want.release(slot)
        self.got.release(slot)
        self.check()
        return self.out.pop(slot)

    def reference(self, row, n):
        """The port's greedy_decode stream of n new tokens."""
        return decode.greedy_decode(self.port, torch.from_numpy(
            np.asarray(row, np.int64))[None], n)[0, len(row):].tolist()


def _pair(pool, variant="rope_gqa", draft="self", slots=3, slot_len=20,
          **kwargs):
    if pool == "paged":
        kwargs.setdefault("kv_block_size", 4)
        kwargs.setdefault("kv_spill", False)
    return SpecPair(variant, draft, slots=slots, slot_len=slot_len,
                    paged=pool == "paged", spec_k=kwargs.pop("spec_k", 3),
                    **kwargs)


def _clean(pair):
    assert pair.got.pool_leak_report() is None
    assert pair.got.force_reclaim() is None


# -- the engine against the JAX engine ------------------------------------


@pytest.mark.parametrize("draft", ["self", "learned_mha"])
@pytest.mark.parametrize("pool", POOLS)
def test_mixed_traffic_matches_jax(pool, draft):
    """Greedy rows (drafting) beside a sampled and a penalized row (the
    single-token lane of the same chunk), rows that reach the end of
    their span (the gate turns off within k of it), a release and a
    recycled slot: state equal to the JAX engine's after every
    operation, every greedy stream equal to greedy_decode's."""
    pair = _pair(pool, draft=draft)
    a, b, c = _arr(1, 2, 3, 4), _arr(9, 8, 7, 6, 5), _arr(11, 12, 13)
    sa = pair.admit(a, 4, max_new=9)
    # top_k 1: a sampled row (no draft, the sampling chain) whose
    # tokens do not depend on the generator's numbers.
    sb = pair.admit(b, 5, temperature=0.9, top_k=1, seed=3, max_new=12)
    pair.step(2)
    sc = pair.admit(c, 3, repetition_penalty=1.3, max_new=7)
    pair.step(3)
    got_a = pair.release(sa)
    assert got_a[:9] == pair.reference(a, 9)[:len(got_a[:9])]
    sd = pair.admit(_arr(5, 4, 3, 2, 1, 7), 6)     # to slot_len
    pair.step(4)
    for slot in (sb, sc, sd):
        pair.release(slot)
    assert pair.got.spec_steps > 0
    if draft == "self":
        assert pair.got.spec_accepted > 0
    _clean(pair)


@pytest.mark.parametrize("pool", POOLS)
def test_int8_cache_and_windowed_target_match_jax(pool):
    """The draft's cache follows kv_quant (int8 on both sides, the
    draft arena's bytes included), and a windowed target (W 6) verifies
    on its band-masked full-length cache beside a dense draft."""
    pair = _pair(pool, kv_quant="int8")
    a, b = _arr(3, 1, 4, 1, 5), _arr(2, 7, 1, 8)
    sa = pair.admit(a, 5)
    sb = pair.admit(b, 4, max_new=10)
    pair.step(3)
    for slot in (sa, sb):
        got = pair.release(slot)
        assert got == pair.reference((a, b)[slot], len(got))
    _clean(pair)
    wpair = _pair(pool, draft="learned_mha",
                  options={"attention_window": 6})
    sa = wpair.admit(a, 5)
    wpair.step(6)
    got = wpair.release(sa)
    assert got == wpair.reference(a, len(got))
    _clean(wpair)


def test_engine_matches_speculative_decode_on_reused_slot():
    """tests/test_engine.py's counterpart: a self-draft engine's greedy
    stream equals the port's speculative_decode (itself greedy-exact),
    and a second request in the recycled slot, draft row included,
    too; the acceptance counters move."""
    _, _, port, _, _, _ = _models("learned_mha")
    eng = decode.SlotDecodeEngine(port, 1, 14, draft_model=port, spec_k=3)
    for prompt in (_arr(1, 2, 3, 4), _arr(5, 6, 7, 8)):
        slot, first, _, _ = eng.admit(prompt, 4)
        out = [first]
        while len(out) < 6:
            toks, _, counts = eng.step()
            out.extend(int(t) for t in toks[slot, :counts[slot]])
        eng.release(slot)
        ref = speculative.speculative_decode(port, port, prompt[None], 6,
                                             k=3)[0]
        assert out[:6] == ref[4:10].tolist()
    assert eng.spec_steps > 0 and eng.spec_accepted > 0
    assert eng.spec_accepted <= eng.spec_proposed
    assert eng.pool_leak_report() is None


def test_draft_arena_exhaustion_queues_cleanly():
    """tests/test_engine.py's counterpart, held to the JAX engine: a
    draft arena of one 4-block span names ``spec_kv_blocks`` as the
    second greedy admission's cause, ``admit`` raises before touching
    either pool, and the queued row lands after the release, exact."""
    pair = SpecPair("learned_mha", slots=2, slot_len=16, paged=True,
                    kv_block_size=4, spec_kv_blocks=5, spec_k=3)
    a, b = _arr(1, 2, 3, 4), _arr(5, 6, 7, 8)
    sa = pair.admit(a, 4)
    for eng in (pair.want, pair.got):
        assert eng.admission_block_cause(b, 4) == "spec_kv_blocks"
        assert not eng.can_admit(b, 4)
        # A sampled row does not draft, so the draft arena is no bar.
        assert eng.admission_block_cause(b, 4, temperature=0.5) is None
        with pytest.raises((decode.EngineCapacityError,
                            jax_decode.EngineCapacityError),
                           match="draft KV"):
            eng.admit(b, 4)
    pair.check()
    assert pair.got.free_slots() == 1
    while len(pair.out[sa]) < 6:
        pair.step()
    pair.release(sa)
    assert pair.got.admission_block_cause(b, 4) is None
    sb = pair.admit(b, 4)
    while len(pair.out[sb]) < 6:
        pair.step()
    assert pair.release(sb)[:6] == pair.reference(b, 6)
    stats = pair.got.kv_block_stats()
    assert stats["spec_kv_blocks_total"] == 4
    assert stats["spec_kv_blocks_free"] == 4
    _clean(pair)


def test_spec_kv_blocks_env_sizes_the_draft_arena(monkeypatch):
    """CEA_TPU_SPEC_KV_BLOCKS sizes the draft arena (as on the JAX
    engine); the default holds every slot's span plus the trash
    block."""
    _, _, port, _, _, _ = _models()
    eng = decode.SlotDecodeEngine(port, 3, 20, paged=True, kv_block_size=4,
                                  draft_model=port, spec_k=3)
    assert eng.kv_block_stats()["spec_kv_blocks_total"] == 15
    monkeypatch.setenv(decode.SPEC_KV_BLOCKS_ENV, "9")
    eng = decode.SlotDecodeEngine(port, 3, 20, paged=True, kv_block_size=4,
                                  draft_model=port, spec_k=3)
    stats = eng.kv_block_stats()
    assert stats["spec_kv_blocks_total"] == 8
    # Data leaves only: 2 layers x (K, V) x 9 blocks x 4 x 2 heads x 8.
    assert stats["spec_kv_arena_bytes"] == 2 * 2 * 9 * 4 * 2 * 8 * 4


def test_engine_refuses_what_speculation_cannot_serve():
    """The JAX engine's construction checks and messages."""
    _, _, port, _, _, _ = _models()
    _, _, wport, _, _, _ = _models(attention_window=6)
    _, wide_tree, wide_config = torch_parity.flax_lm("learned_mha",
                                                     vocab=256)
    other = torch_parity.port_lm(wide_config, wide_tree)
    cases = [
        (dict(draft_model=port, spec_k=1), "spec_k must be >= 2"),
        (dict(draft_model=wport, spec_k=3), "dense cache"),
        (dict(draft_model=other, spec_k=3), "draft vocab"),
        (dict(draft_model=port, spec_k=3, paged=True, kv_block_size=4,
              spec_kv_blocks=3), "cannot hold even one full row"),
    ]
    for kwargs, match in cases:
        with pytest.raises(ValueError, match=match):
            decode.SlotDecodeEngine(port, 2, 12, **kwargs)
    _, tree, config = torch_parity.flax_lm("rope_gqa")
    short = torch_parity.port_lm(dict(config, max_seq_len=10), tree)
    with pytest.raises(ValueError, match="exceeds draft max_seq_len"):
        decode.SlotDecodeEngine(port, 2, 12, draft_model=short, spec_k=3)
    # Without a draft, spec_k alone changes nothing (the JAX engine's).
    eng = decode.SlotDecodeEngine(port, 1, 12, spec_k=4)
    eng.admit(_arr(1, 2, 3), 3)
    assert len(eng.step()) == 2


@pytest.mark.parametrize("pool", POOLS)
def test_torn_draft_admission_is_reclaimed(pool, monkeypatch):
    """A failure inside the draft's admission prefill, after its blocks
    were booked: release (force_reclaim) returns the draft span, the
    pools audit clean and the next admission streams exactly."""
    pair = _pair(pool, draft="learned_mha")
    a = _arr(1, 2, 3, 4, 5)

    def boom(*args, **kwargs):
        raise RuntimeError("synthetic device failure")

    with monkeypatch.context() as patch:
        patch.setattr(pair.got._draft_model, "forward", boom)
        with pytest.raises(RuntimeError, match="synthetic"):
            pair.got.admit(a, 5)
    assert pair.got.force_reclaim() is None
    if pool == "paged":
        assert len(pair.got._draft_free) == pair.got._draft_num_blocks - 1
    slot, first, _, _ = pair.got.admit(a, 5, max_new=6)
    out = [first]
    while len(out) < 6:
        toks, _, counts = pair.got.step()
        out.extend(int(t) for t in toks[slot, :counts[slot]])
    assert out[:6] == pair.reference(a, 6)
    pair.got.release(slot)
    _clean(pair)


# -- PERF_LEDGER.json's spec_check row --------------------------------------


def _replay_spec(eng, trace, args):
    """tools/bench_serving_occupancy.py's ``replay_spec`` loop (rows
    padded into the one prompt bucket, ``counts[slot]`` tokens a step,
    rows retiring mid-chunk), time counted in device calls: the step,
    the gated draft scan, the target and the draft prefill. Returns
    (outputs, metrics)."""
    def calls():
        return eng.steps + eng.spec_steps + eng.prefills + eng.draft_prefills

    t = 0.0
    queue = list(range(len(trace)))
    outputs = [[] for _ in trace]
    slot_req = {}
    while queue or slot_req:
        while queue and eng.free_slots():
            i = queue[0]
            if trace[i]["arrival"] > t:
                break
            queue.pop(0)
            row = np.zeros((args.prompt_len,), np.int32)
            row[:trace[i]["p_len"]] = trace[i]["prompt"]
            c0 = calls()
            slot, first, _, _ = eng.admit(row, trace[i]["p_len"])
            t += calls() - c0
            outputs[i].append(int(first))
            if trace[i]["new"] == 1:
                eng.release(slot)
            else:
                slot_req[slot] = i
        if not slot_req:
            if queue:
                t = max(t, trace[queue[0]]["arrival"])
            continue
        c0 = calls()
        toks, _, counts = (np.asarray(a) for a in eng.step())
        t += calls() - c0
        for slot, i in list(slot_req.items()):
            for j in range(int(counts[slot])):
                outputs[i].append(int(toks[slot, j]))
                if len(outputs[i]) >= trace[i]["new"]:
                    eng.release(slot)
                    del slot_req[slot]
                    break
    tokens = sum(r["new"] for r in trace)
    baseline = occupancy.run_baseline(trace, args)
    goodput = tokens / calls()
    return outputs, {
        "goodput_ratio_spec": round(
            goodput / baseline["goodput_tokens_per_step"], 3),
        "spec_accept_ratio": round(
            eng.spec_accepted / max(eng.spec_proposed, 1), 4),
        "accepted_tokens_per_step": round(
            (eng.spec_accepted + eng.spec_row_steps)
            / max(eng.spec_row_steps, 1), 3),
        "goodput_tokens_per_step": round(goodput, 3),
    }


def test_spec_check_ledger_row():
    """PERF_LEDGER.json's spec_check row (the occupancy trace, 4 slots,
    self-draft at k 4, the paged pool): goodput_ratio_spec 3.25 and
    goodput_tokens_per_step 2.405 as the ledger has them; the
    acceptance pair equal to the JAX engine's on the same trace in this
    process (0.7831 and 3.349 with the JAX of this repo's CI; the
    ledger's 0.7923 and 3.377 were taken with JAX 0.4.37, whose f32
    reductions break other near ties between the single-token draft
    step and the width-k chunk). Every greedy stream equals JAX
    decode(), and both arenas are clean."""
    args = argparse.Namespace(
        slots=4, prompt_len=8, max_new=16, server_max_new=32, requests=24,
        arrival_rate=0.6, vocab_size=64, embed_dim=32, num_layers=2,
        num_heads=4, seed=0, spec_k=4)
    max_len = args.prompt_len + args.server_max_new
    config = dict(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                  num_layers=args.num_layers, num_heads=args.num_heads,
                  max_seq_len=max_len)
    model = TransformerLM(**config, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    port = torch_parity.port_lm(config, tree)
    trace = occupancy.build_trace(args, np.random.default_rng(args.seed))
    eng = decode.SlotDecodeEngine(port, args.slots, max_len,
                                  kv_quant="bf16", kv_spill=False,
                                  draft_model=port, spec_k=args.spec_k)
    assert eng.paged
    outputs, got = _replay_spec(eng, trace, args)
    assert eng.pool_leak_report() is None
    assert got["goodput_ratio_spec"] == 3.25
    assert got["goodput_tokens_per_step"] == 2.405
    jax_eng = jax_decode.SlotDecodeEngine(
        model, tree, args.slots, max_len, kv_quant="bf16", kv_spill=False,
        draft_model=model, draft_params=tree, spec_k=args.spec_k)
    jax_outputs, want = _replay_spec(jax_eng, trace, args)
    assert got == want
    assert outputs == jax_outputs
    assert occupancy.verify_greedy(model, tree, trace, outputs, args) == (
        True, None)

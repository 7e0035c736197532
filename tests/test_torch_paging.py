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

"""The port's paged KV pool against the JAX engine's, in f32 on the CPU.

The JAX ``SlotDecodeEngine(paged=True)`` and the port's run the same
script side by side (the scripts of tests/test_paging.py and the
unquantized cases of tests/test_tiered_kv.py). After every operation
the two hold the same block tables, ``kv_block_stats()``,
``block_pool_state()`` and prefix index, key for key: the pool's host
bookkeeping is a line-for-line copy, so any drift is a fault. Tokens
are exact and logprobs (echo included) agree at 1e-4, the tolerance of
the dense engine's parity test (two layers of f32 reduction order).

The ledger replays at the end reproduce the step-counted serving rows
of PERF_LEDGER.json (``occupancy_check``, ``paging_check``) on the
port's pools exactly, with the bench's own trace functions and model.
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
from container_engine_accelerators_tpu.serving import affinity as jax_affinity
from container_engine_accelerators_tpu_torch.models import convert, decode
from container_engine_accelerators_tpu_torch.serving import affinity
from tests import torch_parity
from tests.conftest import REPO_ROOT

_TOOLS = os.path.join(REPO_ROOT, "tools")
if _TOOLS not in sys.path:
    sys.path.append(_TOOLS)  # append, not insert: tools/ modules
    # must never shadow the package/test import namespace.
import bench_serving_occupancy as occupancy  # noqa: E402

LP_TOL = 1e-4
VARIANTS = sorted(torch_parity.VARIANTS)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arr(*tokens):
    return np.array(tokens, np.int32)


class Pair:
    """One JAX engine and one port engine built alike, driven alike.
    Every operation runs on both and is followed by ``check``."""

    def __init__(self, variant, **kwargs):
        self.model, self.tree, config = torch_parity.flax_lm(variant)
        self.port = torch_parity.port_lm(config, self.tree)
        self.want = jax_decode.SlotDecodeEngine(self.model, self.tree,
                                                **kwargs)
        self.got = decode.SlotDecodeEngine(self.port, **kwargs)
        self.out = {}     # slot -> the port's tokens since admission
        self.check()

    def check(self):
        got, want = self.got, self.want
        assert got.paged == want.paged
        assert got.free_slots() == want.free_slots()
        assert got.kv_block_stats() == want.kv_block_stats()
        assert got.block_pool_state() == want.block_pool_state()
        if got.paged:
            np.testing.assert_array_equal(got._tables, want._tables)
            assert got._pool._index == want._pool._index
            assert got._pool.committed == want._pool.committed
            np.testing.assert_array_equal(got._pool.ref, want._pool.ref)
            assert (got.block_availability()
                    == want.block_availability())
        assert got.pool_leak_report() == want.pool_leak_report()

    def admit(self, row, plen, **kwargs):
        w = self.want.admit(row, plen, **kwargs)
        g = self.got.admit(row, plen, **kwargs)
        assert g[0] == w[0] and g[1] == w[1]
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=LP_TOL)
        np.testing.assert_allclose(g[3], np.asarray(w[3]), rtol=0,
                                   atol=LP_TOL)
        self.check()
        self.out[g[0]] = [g[1]]
        return g

    def refused(self, row, plen, **kwargs):
        """An admission both pools refuse on blocks, leaving them
        unchanged."""
        max_new = kwargs.get("max_new")
        assert not self.want.can_admit(row, plen, max_new)
        assert not self.got.can_admit(row, plen, max_new)
        assert self.got.admission_block_cause(row, plen, max_new) == (
            self.want.admission_block_cause(row, plen, max_new))
        for eng in (self.want, self.got):
            with pytest.raises(RuntimeError, match="KV block"):
                eng.admit(row, plen, **kwargs)
        self.check()

    def step(self, n=1):
        for _ in range(n):
            w_tok, w_lp = self.want.step()
            g_tok, g_lp = self.got.step()
            for slot, seq in self.out.items():
                assert g_tok[slot] == w_tok[slot], slot
                np.testing.assert_allclose(g_lp[slot], w_lp[slot], rtol=0,
                                           atol=LP_TOL)
                seq.append(int(g_tok[slot]))
            self.check()

    def release(self, slot):
        self.want.release(slot)
        self.got.release(slot)
        self.check()
        return self.out.pop(slot)

    def run_to(self, row, plen, n, **kwargs):
        """Admit, decode n tokens (the first included), release."""
        slot = self.admit(row, plen, **kwargs)[0]
        self.step(n - 1)
        return self.release(slot)

    def reference(self, row, n):
        """The port's greedy_decode stream of n new tokens."""
        return decode.greedy_decode(self.port, torch.from_numpy(
            np.asarray(row, np.int64))[None], n)[0, len(row):].tolist()


def _paged(variant, slots=3, slot_len=14, block_size=4, **kwargs):
    return Pair(variant, slots=slots, slot_len=slot_len, paged=True,
                kv_block_size=block_size, **kwargs)


def _clean(pair):
    """Refcount exactness (test_paging's invariant) on the port's
    pool."""
    assert pair.got.pool_leak_report() is None
    assert pair.got.force_reclaim() is None


# -- the model's paged addressing and cache-attending chunks ------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_chunk_attending_the_cache_matches_jax(variant):
    """A chunk that attends the cache (the flax module's
    chunk_attends_cache clone, the paged prefill's forward) at offset 0
    and at offset 7 after it, against flax decode mode: logits at 1e-4
    and the cache rows the chunks wrote."""
    model, tree, config = torch_parity.flax_lm(variant)
    port = torch_parity.port_lm(config, tree)
    first, second = torch_parity.tokens(30, (1, 7)), torch_parity.tokens(
        31, (1, 5))
    decode_model, cache = jax_decode.init_cache(model, 1, 16)
    chunk_model = decode_model.clone(chunk_attends_cache=True)
    port_cache = port.init_cache(1, 16)
    with torch.inference_mode():
        for toks, index in ((first, 0), (second, 7)):
            want, upd = chunk_model.apply(
                {"params": tree, "cache": cache}, jnp.asarray(toks),
                train=False, mutable=["cache"])
            cache = upd["cache"]
            got = port(torch.from_numpy(toks).long(), port_cache, index,
                       chunk_attends_cache=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-4)
    want_k = np.asarray(cache["block1"]["attn"]["cached_key"])
    np.testing.assert_allclose(port_cache[1][0][:, :12].numpy(),
                               want_k[:, :12], rtol=0, atol=1e-5)


def test_paged_step_equals_the_dense_step():
    """One per-row step through block tables gives the dense step's
    logits bitwise when the arena holds the same rows: the write lands
    at (table[b, p // bs], p % bs) and the read gathers the rows back
    in position order. A position past the table's span is dropped."""
    _, tree, config = torch_parity.flax_lm("rope_gqa")
    port = torch_parity.port_lm(config, tree)
    bs, n_blk = 4, 3
    arena = port.init_paged_cache(8, bs)
    tables = torch.tensor([[5, 0, 2], [7, 7, 7]])   # row 1: all trash
    gen = torch.Generator().manual_seed(0)
    for k, v in arena:
        k.copy_(torch.randn(k.shape, generator=gen))
        v.copy_(torch.randn(v.shape, generator=gen))
    dense = [tuple(a[tables].flatten(1, 2).clone() for a in layer)
             for layer in arena]
    tok = torch.tensor([[3], [9]])
    pos = torch.tensor([6, 2])
    with torch.inference_mode():
        want = port(tok, dense, pos)
        got = port(tok, arena, pos, block_table=tables)
        assert torch.equal(got, want)
        for (k, _), (dk, _) in zip(arena, dense):
            assert torch.equal(k[0, 2], dk[0, 6])    # row 0's block 1
            assert torch.equal(k[7, 2], dk[1, 2])    # row 1 on trash
        before = [k.clone() for k, _ in arena]
        port(tok, arena, torch.tensor([n_blk * bs, 0]),
             block_table=tables)
        for b, (k, _) in zip(before, arena):
            assert torch.equal(k[:7], b[:7])          # row 0 dropped
    with pytest.raises(ValueError, match="per-row positions"):
        port(tok[:1], arena, 0, block_table=tables)


# -- tests/test_paging.py ----------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_staggered_shared_prefix_matches_jax(variant):
    """Three rows admitted at different steps, two sharing a prompt
    prefix (full blocks refcounted, the partial boundary block forked):
    the prefix index hits, and every greedy stream equals the JAX
    engine's and the port's greedy_decode."""
    pair = _paged(variant, slots=3, slot_len=16)
    base, other = _arr(5, 6, 7, 8, 9, 10), _arr(20, 21, 22, 23, 24, 25)
    s1 = pair.admit(base, 6)[0]
    pair.step(2)
    s2 = pair.admit(base, 6)[0]          # 1 full block + 1 fork
    s3 = pair.admit(other, 6)[0]
    stats = pair.got.kv_block_stats()
    assert stats["prefix_hits"] == 1 and stats["kv_blocks_shared"] >= 1
    pair.step(4)
    assert pair.out[s1] == pair.reference(base, 7)
    assert pair.out[s2] == pair.reference(base, 5)
    assert pair.out[s3] == pair.reference(other, 5)
    for s in (s1, s2, s3):
        pair.release(s)
    _clean(pair)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cow_isolation_between_forked_rows(variant):
    """Two rows forked from one shared prefix never see each other's
    writes, though the donor keeps writing into the partial block it
    donated."""
    pair = _paged(variant, slots=2, slot_len=16)
    shared = [3, 1, 4, 1, 5, 9]
    sa, sb = _arr(*shared, 11), _arr(*shared, 17)
    slot_a = pair.admit(sa, 7)[0]
    pair.step()
    slot_b = pair.admit(sb, 7)[0]        # forks the partial block
    assert pair.got.kv_block_stats()["prefix_hits"] == 1
    pair.step(4)
    assert pair.out[slot_a] == pair.reference(sa, 6)
    assert pair.out[slot_b] == pair.reference(sb, 5)
    pair.release(slot_a)
    pair.release(slot_b)
    _clean(pair)


@pytest.mark.parametrize("variant", VARIANTS)
def test_refcounts_exact_across_recycling_and_cancel(variant):
    """Retirement and mid-stream cancel (both release()) drop every
    reference exactly once, and freed-but-indexed blocks revive."""
    pair = _paged(variant, slots=2, slot_len=16)
    shared = _arr(2, 4, 6, 8, 10, 12)
    s1 = pair.admit(shared, 6)[0]
    s2 = pair.admit(shared, 6)[0]
    pair.step()
    pair.release(s1)                     # the donor retires first
    assert pair.got.kv_block_stats()["kv_blocks_free"] < (
        pair.got._pool.usable)
    pair.step()
    s3 = pair.admit(shared, 6)[0]
    pair.step()
    pair.release(s3)                     # cancel mid-stream
    pair.release(s2)
    assert pair.got.pool_leak_report() is None
    before = pair.got.kv_block_stats()["prefix_hits"]
    s4 = pair.admit(shared, 6)[0]        # revival from the free list
    assert pair.got.kv_block_stats()["prefix_hits"] == before + 1
    pair.release(s4)
    _clean(pair)


@pytest.mark.parametrize("variant", VARIANTS)
def test_exhaustion_queues_admission_without_corruption(variant):
    """A pool with one row's worth of blocks refuses the second row on
    blocks, not slots; the resident row stays exact, and the refused
    row lands after a release."""
    pair = _paged(variant, slots=2, slot_len=12, kv_blocks=4)
    pa, pb = _arr(1, 2, 3, 4), _arr(9, 8, 7, 6)
    slot_a = pair.admit(pa, 4, max_new=8)[0]
    assert pair.got.free_slots() == 1
    assert pair.got.admission_block_cause(pb, 4, 8) == "kv_blocks"
    pair.refused(pb, 4, max_new=8)
    pair.step(5)
    assert pair.release(slot_a) == pair.reference(pa, 6)
    assert pair.got.can_admit(pb, 4, 8)
    assert pair.run_to(pb, 4, 6, max_new=8) == pair.reference(pb, 6)
    _clean(pair)


def test_env_gate_selects_the_pool_and_dense_matches_paged(monkeypatch):
    """CEA_TPU_PAGED_KV: paged when unset (as in the JAX package), the
    dense pool at 0, with the same stream either way."""
    _, tree, config = torch_parity.flax_lm("rope_gqa")
    port = torch_parity.port_lm(config, tree)
    monkeypatch.setenv(decode.PAGED_KV_ENV, "0")
    dense = decode.SlotDecodeEngine(port, slots=2, slot_len=14)
    assert not dense.paged and dense.kv_block_stats() is None
    assert dense.block_pool_state() == {"paged": False}
    monkeypatch.delenv(decode.PAGED_KV_ENV)
    paged = decode.SlotDecodeEngine(port, slots=2, slot_len=14,
                                    kv_block_size=4)
    assert paged.paged
    prompt = _arr(1, 2, 3, 4)
    outs = []
    for eng in (dense, paged):
        slot, first, _, _ = eng.admit(prompt, 4)
        out = [first]
        for _ in range(5):
            out.append(int(eng.step()[0][slot]))
        eng.release(slot)
        outs.append(out)
    assert outs[0] == outs[1]
    assert outs[0] == decode.greedy_decode(
        port, torch.tensor([[1, 2, 3, 4]]), 6)[0, 4:].tolist()


@pytest.mark.parametrize("variant", VARIANTS)
def test_mixed_traffic_matches_jax(variant):
    """Greedy, penalised and prefix-shared rows crossing block
    boundaries on one pool (test_paging's program-count script): the
    tables, stats and streams follow the JAX engine's. The sampled row
    draws from its own generator, so only its validity is held."""
    pair = _paged(variant, slots=4, slot_len=16)
    shared = _arr(4, 5, 6, 7, 8, 9)
    pair.admit(shared, 6)
    pair.step()
    pair.admit(_arr(30, 31, 32), 3, repetition_penalty=1.5)
    pair.admit(shared, 6)
    pair.step(6)                         # crosses block boundaries
    for eng in (pair.want, pair.got):
        slot = eng.admit(shared, 6, temperature=0.9, top_k=7, top_p=0.9,
                         min_p=0.01, seed=3)[0]
        toks, _ = eng.step()
        assert 0 <= toks[slot] < torch_parity.TINY["vocab_size"]
        eng.release(slot)
    pair.check()
    for slot in list(pair.out):
        pair.release(slot)
    _clean(pair)


@pytest.mark.parametrize("variant", VARIANTS)
def test_pin_prefix_system_prompt_serving(variant):
    """pin_prefix keeps a system prompt's blocks resident without a
    slot; the reserve lets a worst-case row admit; a prefixed row hits
    and streams exactly; releasing leaves exactly the pinned blocks."""
    pair = _paged(variant, slots=2, slot_len=20, buckets=[4],
                  pin_reserve_tokens=6)
    prefix = _arr(7, 11, 13, 17, 19, 23)
    assert pair.got.pin_prefix(prefix) == pair.want.pin_prefix(prefix) == 2
    pair.check()
    worst = np.concatenate([prefix, _arr(1, 2, 3, 4)])
    assert pair.got.can_admit(worst, 10, pair.got.slot_len - 10)
    full = np.concatenate([prefix, _arr(1, 2, 3)])
    slot = pair.admit(full, 9)[0]
    assert pair.got.kv_block_stats()["prefix_hits"] == 1
    pair.step(4)
    assert pair.release(slot) == pair.reference(full, 5)
    assert pair.got.pool_leak_report() is None
    assert pair.got.kv_block_stats()["kv_blocks_free"] == (
        pair.got._pool.usable - 2)
    dense = decode.SlotDecodeEngine(pair.port, 1, 8, paged=False)
    with pytest.raises(ValueError, match="paged KV pool"):
        dense.pin_prefix(prefix)


@pytest.mark.parametrize("variant", VARIANTS)
def test_paged_score_and_logprobs_consume_no_blocks(variant):
    """Scoring takes no slot and no block and matches the JAX echo; an
    admission that needs its full echo (allow_prefix=False) skips the
    resident prefix and still matches."""
    pair = _paged(variant, slots=1, slot_len=14)
    prompt = _arr(2, 4, 6, 8)
    np.testing.assert_allclose(pair.got.score(prompt, 4),
                               np.asarray(pair.want.score(prompt, 4)),
                               rtol=0, atol=LP_TOL)
    pair.check()
    assert pair.got.free_slots() == 1
    assert pair.got.pool_leak_report() is None
    pair.release(pair.admit(prompt, 4)[0])
    slot, _, lp0, echo = pair.admit(prompt, 4, allow_prefix=False)
    assert pair.got.kv_block_stats()["prefix_lookups"] == 1
    want_echo = decode.SlotDecodeEngine(pair.port, 1, 14, paged=False).score(
        prompt, 4)
    np.testing.assert_allclose(echo[:4], want_echo[:4], rtol=0,
                               atol=LP_TOL)
    assert np.isfinite(lp0)
    pair.step(3)
    pair.release(slot)
    _clean(pair)


# -- tests/test_tiered_kv.py, the unquantized arena ----------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_spill_rehydrate_stream_exact_and_refcounts_exact(variant):
    """Cold registered blocks evict to the host tier when reused and
    rehydrate on a content-key hit, invisibly to the stream; with the
    tier off the same traffic re-prefills."""
    a = _arr(1, 2, 3, 4, 5, 6)
    fillers = (_arr(9, 8, 7, 6, 5, 4), _arr(11, 12, 13, 14, 15, 16))
    for spill in (True, False):
        pair = _paged(variant, slots=1, slot_len=12, kv_blocks=4,
                      kv_spill=spill)
        first = pair.run_to(a, 6, 4, max_new=4)
        for f in fillers:
            pair.run_to(f, 6, 4, max_new=4)
        again = pair.run_to(a, 6, 4, max_new=4)
        assert first == again == pair.reference(a, 4)
        stats = pair.got.kv_block_stats()
        if spill:
            assert stats["kv_spill_hits"] >= 1
            assert stats["kv_rehydrated_blocks"] >= 1
            assert stats["kv_spill_blocks"] >= 1
        else:
            assert stats["kv_spill_hits"] == 0
            assert stats["kv_spill_blocks"] == 0
        _clean(pair)


@pytest.mark.parametrize("variant", VARIANTS)
def test_rehydrate_events_drain(variant):
    """Each rehydrating admission leaves one latency sample, drained
    once."""
    pair = _paged(variant, slots=1, slot_len=12, kv_blocks=4)
    a = _arr(1, 2, 3, 4, 5, 6)
    for row in (a, _arr(9, 8, 7, 6, 5, 4), _arr(11, 12, 13, 14, 15, 16), a):
        pair.got.release(pair.got.admit(row, 6, max_new=4)[0])
    events = pair.got.drain_rehydrate_events()
    assert len(events) == 1 and events[0] >= 0.0
    assert pair.got.drain_rehydrate_events() == []


@pytest.mark.parametrize("variant", VARIANTS)
def test_cow_isolation_across_evict_rehydrate_fork(variant):
    """A prefix whose partial boundary block was spilled and rehydrated
    forks like a resident one, and a later fork taken straight from the
    host tier (the upload is the copy) is exact too."""
    shared = [3, 1, 4, 1, 5, 9]
    sa, sb, sc = _arr(*shared, 11), _arr(*shared, 17), _arr(*shared, 29)
    fillers = (_arr(40, 41, 42, 43, 44, 45, 46),
               _arr(30, 31, 32, 33, 34, 35, 36))
    pair = _paged(variant, slots=2, slot_len=16, kv_blocks=9,
                  kv_spill=True)
    pair.run_to(sa, 7, 3, max_new=3)
    for f in fillers:
        pair.run_to(f, 7, 3, max_new=3)
    assert pair.got.kv_block_stats()["kv_spill_blocks"] >= 1
    slot_a = pair.admit(sa, 7, max_new=6)[0]
    pair.step()
    slot_b = pair.admit(sb, 7, max_new=5)[0]
    pair.step(4)
    assert pair.release(slot_a) == pair.reference(sa, 6)
    assert pair.release(slot_b) == pair.reference(sb, 5)
    for f in fillers:
        pair.run_to(f, 7, 3, max_new=3)
    assert pair.run_to(sc, 7, 5, max_new=5) == pair.reference(sc, 5)
    _clean(pair)


@pytest.mark.parametrize("variant", VARIANTS)
def test_exhaustion_with_full_spill_tier_queues_cleanly(variant):
    """A spill budget below one block's bytes evicts every capture at
    once; block exhaustion still queues admissions cleanly."""
    pair = _paged(variant, slots=2, slot_len=12, kv_blocks=4,
                  kv_spill=True, kv_spill_bytes=64)
    pa, pb = _arr(1, 2, 3, 4), _arr(9, 8, 7, 6)
    pair.run_to(pb, 4, 3, max_new=4)
    slot_a = pair.admit(pa, 4, max_new=8)[0]
    pair.refused(pb, 4, max_new=8)
    pair.step(5)
    assert pair.got._pool.spill_captures >= 1
    assert pair.got._pool.spill_evictions >= 1
    assert pair.got.kv_block_stats()["kv_spill_blocks"] == 0
    assert pair.release(slot_a) == pair.reference(pa, 6)
    assert pair.run_to(pb, 4, 6, max_new=8) == pair.reference(pb, 6)
    _clean(pair)


@pytest.mark.parametrize("variant", VARIANTS)
def test_failed_admission_rolls_back_pool_state(variant, monkeypatch):
    """A failure inside the admission prefill (here raised by a patched
    prefill on both sides) leaves the pool exactly as it found it, and
    the next admission of the same prompt streams exactly."""
    pair = _paged(variant, slots=2, slot_len=12, kv_blocks=7,
                  kv_spill=True)
    a = _arr(1, 2, 3, 4, 5, 6)
    pair.run_to(a, 6, 3, max_new=3)      # registers the prefix

    def boom(*args, **kwargs):
        raise RuntimeError("synthetic device failure")

    with monkeypatch.context() as patch:
        patch.setattr(jax_decode, "_paged_prefill_impl", boom)
        patch.setattr(decode, "_paged_prefill_impl", boom)
        for eng in (pair.want, pair.got):
            with pytest.raises(RuntimeError, match="synthetic"):
                eng.admit(a, 6, max_new=3)   # revival + fork path
    pair.check()
    assert pair.got.pool_leak_report() is None
    assert pair.got.free_slots() == 2
    assert pair.run_to(a, 6, 4, max_new=4) == pair.reference(a, 4)
    _clean(pair)


@pytest.mark.parametrize("variant", VARIANTS)
def test_spill_tier_lru_evicts_at_byte_budget(variant):
    """A budget of two blocks' bytes holds the LRU at or below it while
    distinct prefixes churn; an evicted prefix re-prefills exactly."""
    rows = (_arr(1, 2, 3, 4, 5, 6), _arr(9, 8, 7, 6, 5, 4),
            _arr(11, 12, 13, 14, 15, 16))
    pair = _paged(variant, slots=1, slot_len=12, kv_blocks=4,
                  kv_spill=True)
    pair.run_to(rows[0], 6, 3, max_new=3)
    pair.run_to(rows[1], 6, 3, max_new=3)
    pool = pair.got._pool
    per_block = pool.spill_bytes_used // pool.spill_block_count()
    layers = torch_parity.TINY["num_layers"]
    assert per_block == 2 * layers * 4 * pair.got._cache[0][0][0, 0].numel(
    ) * 4
    pair = _paged(variant, slots=1, slot_len=12, kv_blocks=4,
                  kv_spill=True, kv_spill_bytes=int(2 * per_block))
    for row in rows + rows:
        assert pair.run_to(row, 6, 4, max_new=4) == pair.reference(row, 4)
        assert pair.got._pool.spill_bytes_used <= 2 * per_block
    assert pair.got._pool.spill_evictions >= 1
    _clean(pair)


# -- affinity keys ---------------------------------------------------------


def test_affinity_keys_are_byte_equal_to_jax():
    """The port's chain keys equal the JAX package's, function by
    function and as a pool indexes them, so the JAX router steers to
    torch engines unchanged."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 32000, 70).astype(np.int32)
    for bs in (1, 4, 16):
        assert (affinity.full_block_keys(tokens, bs)
                == jax_affinity.full_block_keys(tokens, bs))
        chain = affinity.full_block_keys(tokens, bs)[-1]
        assert (affinity.partial_key(chain, tokens[:3])
                == jax_affinity.partial_key(chain, tokens[:3]))
        for cap in (None, 2):
            assert (affinity.affinity_key(tokens, bs, cap)
                    == jax_affinity.affinity_key(tokens, bs, cap))
    assert affinity.affinity_key(tokens[:3], 4) is None
    assert affinity.chain_digest(None, (1, 2)) == (
        jax_affinity.chain_digest(None, (1, 2)))
    assert (affinity.KV_BLOCK_ENV, affinity.DEFAULT_BLOCK_SIZE) == (
        jax_affinity.KV_BLOCK_ENV, jax_affinity.DEFAULT_BLOCK_SIZE)
    assert affinity.default_block_size() == jax_affinity.default_block_size()
    pool, jax_pool = decode._BlockPool(32, 4), jax_decode._BlockPool(32, 4)
    blocks = list(range(18))
    pool.register(tokens, 70, blocks)
    jax_pool.register(tokens, 70, blocks)
    assert pool._index == jax_pool._index
    keys = affinity.full_block_keys(tokens, 4)
    assert all(pool._index[k] == i for i, k in enumerate(keys))
    assert pool.lookup(tokens[:50]) == jax_pool.lookup(tokens[:50])


# -- ledger replays (PERF_LEDGER.json) --------------------------------------


def _bench_args(**overrides):
    """bench_serving_occupancy's defaults."""
    args = dict(slots=4, prompt_len=8, max_new=16, server_max_new=32,
                requests=24, arrival_rate=0.6, vocab_size=64, embed_dim=32,
                num_layers=2, num_heads=4, seed=0, shared_prefix_len=24,
                shared_frac=0.8, paging_requests=40, paging_arrival_rate=4.0,
                paged_slots=16, kv_block_size=4)
    args.update(overrides)
    return argparse.Namespace(**args)


def _bench_model(args, max_len):
    """The bench's model (f32, PRNGKey(1)) and the port's copy."""
    config = dict(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                  num_layers=args.num_layers, num_heads=args.num_heads,
                  max_seq_len=max_len)
    model = TransformerLM(**config, dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(1),
                        jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    return model, tree, torch_parity.port_lm(config, tree)


def _replay(eng, trace, prompt_len=None):
    """The bench's replay loop on one engine: FIFO admission gated by
    ``can_admit`` with per-request reservations (``replay_pool``), or,
    with ``prompt_len``, by free slots on rows padded into the one
    bucket (``run_engine``). Time counts device calls. Returns
    (outputs, latencies, peak rows)."""
    t = 0.0
    queue = list(range(len(trace)))
    outputs = [[] for _ in trace]
    latency = [None] * len(trace)
    slot_req = {}
    peak = 0
    while queue or slot_req:
        while queue:
            r = trace[queue[0]]
            if r["arrival"] > t:
                break
            if prompt_len is None:
                if not eng.can_admit(r["prompt"], r["p_len"], r["new"]):
                    break
                row, max_new = r["prompt"], r["new"]
            else:
                if not eng.free_slots():
                    break
                row = np.zeros((prompt_len,), np.int32)
                row[:r["p_len"]] = r["prompt"]
                max_new = None
            i = queue.pop(0)
            slot, first, _, _ = eng.admit(row, r["p_len"], max_new=max_new)
            t += 1.0                     # the prefill device call
            outputs[i].append(first)
            if r["new"] == 1:
                latency[i] = t - r["arrival"]
                eng.release(slot)
            else:
                slot_req[slot] = i
            peak = max(peak, eng.active_count())
        if not slot_req:
            if queue:                    # idle until the next arrival
                t = max(t, trace[queue[0]]["arrival"])
            continue
        toks, _ = eng.step()
        t += 1.0
        for slot, i in list(slot_req.items()):
            outputs[i].append(int(toks[slot]))
            if len(outputs[i]) >= trace[i]["new"]:
                latency[i] = t - trace[i]["arrival"]
                eng.release(slot)
                del slot_req[slot]
    assert eng.pool_leak_report() is None
    return outputs, latency, peak


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_occupancy_check_ledger_row(paged):
    """PERF_LEDGER.json's occupancy_check row on the port's pools:
    goodput_ratio 3.545, rows_per_step 3.358, goodput_tokens_per_step
    2.623, p50 25.9 and p99 43.1 steps; every greedy stream equals JAX
    decode()."""
    args = _bench_args()
    model, tree, port = _bench_model(args,
                                     args.prompt_len + args.server_max_new)
    trace = occupancy.build_trace(args, np.random.default_rng(args.seed))
    eng = decode.SlotDecodeEngine(port, args.slots,
                                  args.prompt_len + args.server_max_new,
                                  paged=paged, kv_spill=False)
    outputs, latency, _ = _replay(eng, trace, prompt_len=args.prompt_len)
    tokens = sum(r["new"] for r in trace)
    goodput = round(tokens / (eng.steps + eng.prefills), 3)
    baseline = occupancy.run_baseline(trace, args)
    got = {
        "goodput_ratio": round(goodput
                               / baseline["goodput_tokens_per_step"], 3),
        "rows_per_step": round(eng.row_steps / eng.steps, 3),
        "goodput_tokens_per_step": goodput,
        "p50_latency_steps": round(float(np.percentile(latency, 50)), 1),
        "p99_latency_steps": round(float(np.percentile(latency, 99)), 1),
    }
    assert got == {"goodput_ratio": 3.545, "rows_per_step": 3.358,
                   "goodput_tokens_per_step": 2.623,
                   "p50_latency_steps": 25.9, "p99_latency_steps": 43.1}
    assert occupancy.verify_greedy(model, tree, trace, outputs, args) == (
        True, None)


def test_paging_check_ledger_row():
    """PERF_LEDGER.json's paging_check row: the shared-prefix trace on
    the dense pool (4 slots) and the paged pool (16 slots, block 4, 64
    usable blocks, the dense pool's bytes, no spill): prefix_hit_rate
    0.825, paged rows_per_step 9.364, sustained_rows_ratio 2.485; every
    greedy stream on both pools equals JAX decode()."""
    args = _bench_args()
    bs = args.kv_block_size
    slot_len = -(-(args.shared_prefix_len + args.prompt_len
                   + args.server_max_new) // bs) * bs
    model, tree, port = _bench_model(args, slot_len)
    trace = occupancy.build_shared_trace(
        args, np.random.default_rng(args.seed + 1))
    usable = args.slots * (slot_len // bs)
    rows = {}
    for kind in ("dense", "paged"):
        if kind == "dense":
            eng = decode.SlotDecodeEngine(port, args.slots, slot_len,
                                          paged=False)
        else:
            eng = decode.SlotDecodeEngine(
                port, args.paged_slots, slot_len, paged=True,
                kv_block_size=bs, kv_blocks=usable + 1, kv_spill=False)
        outputs, _, _ = _replay(eng, trace)
        rows[kind] = round(eng.row_steps / max(eng.steps, 1), 3)
        assert occupancy.verify_greedy(model, tree, trace, outputs,
                                       args) == (True, None)
    assert usable == 64
    assert eng.kv_block_stats()["prefix_hit_rate"] == 0.825
    assert rows["paged"] == 9.364
    assert round(rows["paged"] / max(rows["dense"], 1e-9), 3) == 2.485

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

"""The MoE family on the port's decode paths against the JAX package,
in f32 on the CPU.

A dropping router (capacity factor 1.25, 4 experts, top-2) makes a
token's output depend on every token of its forward call, so these
tests hold the port to the JAX package's call grouping: greedy_decode
and decode() (one-shot and stepwise prefill) on a batch of 2; the slot
engine on both pools with free slots (their scratch tokens route in
every step), mixed buckets (the padding routes in every admission),
prefix hits (the suffix chunk alone routes) and an int8 KV cache,
token for token beside the JAX ``SlotDecodeEngine`` after every
operation. Every row is greedy: a sampled row's tokens come from the
port's own generator and would route differently, moving the other
rows' capacity. Speculation takes drop-free routing only
(capacity_factor = E / top_k): the counterparts of the MoE cases of
tests/test_speculative.py on the JAX loop's own draws, the engine's
draft arena with a drop-free MoE self-draft beside the JAX engine, and
the refusals of a dropping model. Last, ``serve.py --model moe`` on
the JAX server's model and weights: the same streams.
"""

import importlib.util
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import MoETransformerLM
from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu_torch.models import (
    convert,
    decode,
    moe,
    speculative,
)
from container_engine_accelerators_tpu_torch.serving import serve
from tests import torch_parity
from tests.conftest import REPO_ROOT
from tests.test_torch_speculative import (
    _draft,
    _greedy_matches,
    _make,
    _prompt,
    _sampled_matches,
)

LP_TOL = 1e-4
POOLS = ["dense", "paged"]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _dropping(variant="rope_gqa", seed=1, **options):
    """(flax model, tree, the port's model): 4 experts, top-2, capacity
    factor 1.25."""
    model, tree, config = torch_parity.flax_moe(variant, seed=seed,
                                                **options)
    return model, tree, torch_parity.port_lm(config, tree)


def _moe(vocab=64, experts=4, seed=0, **kw):
    """tests/test_speculative.py's ``_moe``: drop-free routing
    (capacity_factor = experts / top_k), 2 heads, max_seq_len 96."""
    options = dict(vocab_size=vocab, embed_dim=kw.pop("embed", 32),
                   num_layers=kw.pop("layers", 2),
                   num_heads=kw.pop("heads", 2),
                   max_seq_len=kw.pop("seq", 96), num_experts=experts,
                   capacity_factor=experts / 2, **kw)
    model, tree, config = torch_parity.flax_moe("learned_mha", seed=seed,
                                                **options)
    return model, tree, torch_parity.port_lm(config, tree)


# -- single-request decoding ----------------------------------------------


@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_decode_paths_match_jax_with_a_dropping_router(variant):
    """greedy_decode and decode() (one-shot and stepwise prefill, with
    logprobs) on 2 rows: the prefill routes 2 x 7 tokens together, each
    step 2."""
    model, tree, port = _dropping(variant)
    prompt = torch_parity.tokens(9, (2, 7))
    want = np.asarray(jax_decode.decode(model, tree, jnp.asarray(prompt), 8))
    got = decode.greedy_decode(port, torch.from_numpy(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    for fast in (True, False):
        w_seq, w_lp = jax_decode.decode(model, tree, jnp.asarray(prompt), 8,
                                        fast_prefill=fast,
                                        return_logprobs=True)
        g_seq, g_lp = decode.decode(port, torch.from_numpy(prompt), 8,
                                    fast_prefill=fast, return_logprobs=True)
        np.testing.assert_array_equal(g_seq.numpy(), np.asarray(w_seq))
        np.testing.assert_allclose(g_lp.numpy(), np.asarray(w_lp), rtol=0,
                                   atol=LP_TOL)


def test_a_dropping_router_groups_by_call():
    """Why the call grouping matters: the same token routes differently
    alone and beside others. Row 0's logits from a batch-1 forward
    differ from the same row's in a batch of 3 (capacity drops), and
    equal them once routing is drop-free."""
    _, tree, config = torch_parity.flax_moe("learned_mha")
    toks = torch.from_numpy(torch_parity.tokens(4, (3, 10))).long()
    for factor, differ in ((1.25, True), (2.0, False)):
        port = torch_parity.port_lm(dict(config, capacity_factor=factor),
                                    tree)
        alone, _ = port(toks[:1])
        together, _ = port(toks)
        gap = float((alone[0] - together[0]).abs().max())
        assert (gap > 1e-3) == differ, (factor, gap)


# -- the slot engine ------------------------------------------------------


class EnginePair:
    """A JAX engine and a port engine over the same MoE weights, built
    alike and driven alike; after every operation the pools agree."""

    def __init__(self, jax_model, tree, port, draft=None, **kwargs):
        if draft is not None:
            kwargs.update(draft_model=draft[0], draft_params=draft[1])
        self.want = jax_decode.SlotDecodeEngine(jax_model, tree, **kwargs)
        if draft is not None:
            del kwargs["draft_params"]
            kwargs["draft_model"] = draft[2]
        self.got = decode.SlotDecodeEngine(port, **kwargs)
        self.spec = draft is not None
        self.out = {}
        self.check()

    def check(self):
        got, want = self.got, self.want
        assert got.free_slots() == want.free_slots()
        assert got.kv_block_stats() == want.kv_block_stats()
        if got.paged:
            np.testing.assert_array_equal(got._tables, want._tables)
            np.testing.assert_array_equal(got._pool.ref, want._pool.ref)
            assert got._pool.committed == want._pool.committed
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
        return g[0]

    def step(self, n=1):
        for _ in range(n):
            want = [np.asarray(a) for a in self.want.step()]
            got = self.got.step()
            for slot, seq in self.out.items():
                if self.spec:
                    count = int(got[2][slot])
                    assert count == int(want[2][slot]), slot
                    toks = got[0][slot, :count]
                    np.testing.assert_array_equal(toks,
                                                  want[0][slot, :count])
                    np.testing.assert_allclose(got[1][slot, :count],
                                               want[1][slot, :count],
                                               rtol=0, atol=LP_TOL)
                    seq.extend(int(t) for t in toks)
                    continue
                assert got[0][slot] == want[0][slot], slot
                np.testing.assert_allclose(got[1][slot], want[1][slot],
                                           rtol=0, atol=LP_TOL)
                seq.append(int(got[0][slot]))
            self.check()

    def release(self, slot):
        self.want.release(slot)
        self.got.release(slot)
        self.check()
        return self.out.pop(slot)


def test_dense_engine_matches_jax_with_a_dropping_router():
    """3 slots of 24 at buckets 8 and 16: free rows step beside the
    active ones, a ragged row routes its bucket's padding, a penalised
    row, rows joining and leaving mid-stream."""
    model, tree, port = _dropping("rope_gqa")
    pair = EnginePair(model, tree, port, slots=3, slot_len=24,
                      paged=False, buckets=[8, 16])
    a = pair.admit(torch_parity.tokens(10, (8,)), 5)
    pair.step(2)
    b = pair.admit(torch_parity.tokens(11, (16,)), 11,
                   repetition_penalty=1.3)
    pair.step(3)
    pair.release(a)
    c = pair.admit(torch_parity.tokens(12, (8,)), 3)
    pair.step(4)
    pair.release(b)
    pair.step(2)
    pair.release(c)
    assert pair.got.prefill_widths == {8: 2, 16: 1}


@pytest.mark.parametrize("kv_quant", ["bf16", "int8"])
def test_paged_engine_matches_jax_with_a_dropping_router(kv_quant):
    """The paged pool (block 4): a shared prompt admitted twice (the
    second admission's chunk is its suffix bucket alone), a cold row,
    steps across block boundaries, free rows on the trash block; in the
    model's cache dtype and in an int8 cache."""
    model, tree, port = _dropping("learned_mha")
    pair = EnginePair(model, tree, port, slots=3, slot_len=16, paged=True,
                      kv_block_size=4, kv_spill=False, kv_quant=kv_quant)
    shared = np.array([4, 5, 6, 7, 8, 9], np.int32)
    s1 = pair.admit(shared, 6)
    pair.step()
    s2 = pair.admit(np.array([30, 31, 32], np.int32), 3)
    s3 = pair.admit(shared, 6)
    assert pair.got.kv_block_stats()["prefix_hits"] == 1
    pair.step(5)
    pair.release(s2)
    pair.step(2)
    for slot in (s1, s3):
        pair.release(slot)
    assert pair.got.pool_leak_report() is None


@pytest.mark.parametrize("pool", POOLS)
def test_spec_engine_with_a_drop_free_moe_self_draft_matches_jax(pool):
    """Speculation in the engine with the drop-free MoE as its own
    draft (k 3): the draft arena, the width-3 verify and the commits
    follow the JAX engine's, counters included."""
    model, tree, port = _moe(seed=0)
    kwargs = dict(slots=2, slot_len=24, paged=pool == "paged", spec_k=3)
    if pool == "paged":
        kwargs.update(kv_block_size=4, kv_spill=False)
    pair = EnginePair(model, tree, port, draft=(model, tree, port),
                      **kwargs)
    a = pair.admit(_prompt(1, 8)[0], 8)
    b = pair.admit(_prompt(1, 5, seed=3)[0], 5)
    pair.step(4)
    for name in ("spec_steps", "spec_proposed", "spec_accepted",
                 "draft_prefills"):
        assert getattr(pair.got, name) == getattr(pair.want, name), name
    # The engine's draft holes (the newest proposal of a fully accepted
    # step is never keyed) keep its acceptance below 1.
    assert 2 * pair.got.spec_accepted >= pair.got.spec_proposed > 0
    for slot in (a, b):
        seq = pair.release(slot)
        assert len(seq) >= 5


# -- speculative_decode: tests/test_speculative.py's MoE cases -------------


def test_spec_refuses_a_dropping_moe():
    """tests/test_speculative.py:136-143, on real MoE models: a
    dropping router (capacity 1.25 x top-2 < 8 experts) is refused as
    the target and as the draft; the engine refuses it too."""
    _, _, target = _make(seed=0)
    _, _, dropping = _moe(experts=8, seed=0)
    dropping.capacity_factor = 1.25
    prompt = _prompt(1, 8)
    with pytest.raises(ValueError, match="drop-free"):
        speculative.speculative_decode(dropping, target, prompt, 4)
    with pytest.raises(ValueError, match="drop-free"):
        speculative.speculative_decode(target, dropping, prompt, 4)
    with pytest.raises(ValueError, match="can drop tokens"):
        decode.SlotDecodeEngine(dropping, 2, 16, draft_model=target,
                                spec_k=2)
    with pytest.raises(ValueError, match="can drop tokens"):
        decode.SlotDecodeEngine(target, 2, 16, draft_model=dropping,
                                spec_k=2)


def test_spec_equals_greedy_moe_target():
    """:441: a drop-free MoE target beside a dense draft."""
    _greedy_matches(_moe(seed=0), _draft(), _prompt(2, 8), 12, k=4)


def test_spec_equals_greedy_moe_draft():
    """:451: a dense target beside a drop-free MoE draft."""
    _greedy_matches(_make(seed=0), _moe(embed=16, layers=1, experts=2,
                                        seed=99), _prompt(2, 8), 12, k=3)


def test_spec_moe_self_draft_full_acceptance():
    """:461: the drop-free MoE scores its own proposals exactly."""
    target = _moe(seed=0)
    st = _greedy_matches(target, target, _prompt(1, 8), 12, k=4)
    assert st["accepted_drafts"] == 3 * st["rounds"], st


def test_spec_moe_sampling_on_jax_draws_and_greedy_limit():
    """:475: sampling on the JAX loop's draws, twice alike, and the
    T -> 0 limit equal to decode()."""
    target = _moe(vocab=16, seed=0)
    draft = _make(vocab=16, embed=16, layers=1, heads=2, seed=99)
    prompt = _prompt(2, 6, vocab=16)
    key = jax.random.PRNGKey(5)
    a, _ = _sampled_matches(target, draft, prompt, 8, key, 3,
                            temperature=1.0)
    b, _ = _sampled_matches(target, draft, prompt, 8, key, 3,
                            temperature=1.0)
    np.testing.assert_array_equal(a, b)
    _sampled_matches(target, draft, prompt, 8, jax.random.PRNGKey(0), 3,
                     temperature=1e-5)


def test_spec_windowed_moe_target_equals_windowed_greedy():
    """:879: a drop-free windowed MoE target, its ring wrapped several
    times."""
    _greedy_matches(_moe(seed=0, attention_window=8), _draft(),
                    _prompt(2, 8), 24, k=4)


# -- the launcher ---------------------------------------------------------

FLAGS = ["--model", "moe", "--num-experts", "4", "--vocab-size", "64",
         "--embed-dim", "32", "--num-layers", "2", "--num-heads", "4",
         "--num-kv-heads", "2", "--pos-embedding", "rope",
         "--max-seq-len", "48", "--max-new-tokens", "6", "--max-batch",
         "3", "--port", "0", "--device", "cpu"]


@pytest.mark.parametrize("pool", POOLS)
def test_launcher_serves_moe_like_the_jax_server(pool, monkeypatch):
    """``serve.py --model moe --num-experts 4`` builds the port's
    MoETransformerLM (experts native under --quantize-weights int8);
    its greedy streams equal the JAX GenerationServer's on the JAX
    MoETransformerLM with the same weights, request for request (one
    row, then two rows together); --speculative-k refuses the dropping
    router at startup, as the JAX engine does."""
    monkeypatch.setenv(decode.PAGED_KV_ENV, "1" if pool == "paged" else "0")
    args = serve.parse_args(FLAGS)
    config = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=48,
                  num_experts=4)
    tree = convert.init_flax_layout_params(config, args.seed)
    jax_model = MoETransformerLM(dtype=jnp.bfloat16, **config)
    want_srv = jax_server.GenerationServer("moe", jax_model, tree, port=0,
                                           max_new_tokens=6, max_batch=3)
    got_srv = serve.build_server(args)
    try:
        assert isinstance(got_srv.engine._model, moe.MoETransformerLM)
        assert got_srv.engine.paged == (pool == "paged")
        for prompts in (torch_parity.tokens(30, (1, 5)).tolist(),
                        torch_parity.tokens(31, (2, 12)).tolist(),
                        torch_parity.tokens(32, (1, 3)).tolist()):
            payload = {"prompts": prompts, "max_new_tokens": 6}
            w_code, w_body = want_srv._handle_post(payload)
            g_code, g_body = got_srv._handle_post(payload)
            assert g_code == w_code == 200, (g_body, w_body)
            assert g_body["sequences"] == w_body["sequences"]
    finally:
        got_srv.stop()
        want_srv.stop()
    q = serve.build_server(serve.parse_args(FLAGS + ["--quantize-weights",
                                                     "int8"]))
    try:
        routed = q.engine._model.blocks[1]
        assert routed.moe.w_in.dtype == torch.bfloat16
        assert routed.attn.q.weight.dtype == torch.int8
    finally:
        q.stop()
    with pytest.raises(ValueError, match="drop"):
        serve.build_server(serve.parse_args(FLAGS + ["--speculative-k",
                                                     "4"]))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_registers_the_moe_phase():
    """Phase 13 is driven from main after the fleet phase, its launch
    records are the moe_* paths, training must launch all five kernels
    and dense and speculative serving kernel #1; it serves through the
    launcher at the demo's MoE defaults and replays the engine's calls
    on the plain routing form."""
    cs = _chip_smoke()
    assert cs.PATH_KERNELS["moe_training"] == (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "xent_fwd",
        "xent_bwd")
    assert cs.PATH_KERNELS["moe_dense_serving"] == ("flash_fwd",)
    assert cs.PATH_KERNELS["moe_spec_serving"] == ("flash_fwd",)
    main = inspect.getsource(cs.main)
    assert "drive_moe(" in main and "moe_launches.items()" in main
    assert main.index("drive_fleet(") < main.index("drive_moe(")
    assert cs.MOE["num_experts"] == 8 and "capacity_factor" not in cs.MOE
    args = serve.parse_args(cs.moe_argv())
    assert (args.model, args.num_experts, args.device) == ("moe", 8, "cuda")
    serving = inspect.getsource(cs.moe_serving)
    assert "serve.build_server(" in serving and "moe_replay(" in serving
    replay = inspect.getsource(cs.moe_replay)
    assert "expert.dense_moe_reference" in replay
    assert "_engine_factory()" in replay
    plain = inspect.getsource(cs.check_plain_step)
    assert "expert.dense_moe_reference" in plain

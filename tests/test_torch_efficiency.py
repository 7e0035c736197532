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
"""The port's efficiency tooling against the JAX package's, case for
case with tests/test_efficiency.py: the MFU and goodput ledgers and
their offline replay, the peak table, the FLOP counter (the port's
counterpart of XLA's cost analysis), the engine's active parameter
count, the memory monitor, the profiler capture, and the serving
surface (TTFT/TPOT, decode MFU, the HBM fields, /debug/profile) on a
port server. Where both packages compute a number, both get the same
inputs and must give the same answer."""

import json
import os
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.models import decode as jax_decode
from container_engine_accelerators_tpu.obs import efficiency as jax_eff
from container_engine_accelerators_tpu.obs import memory as jax_memory
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import transformer
from container_engine_accelerators_tpu_torch.obs import efficiency
from container_engine_accelerators_tpu_torch.obs import memory
from container_engine_accelerators_tpu_torch.obs import postmortem
from container_engine_accelerators_tpu_torch.obs import profiler
from container_engine_accelerators_tpu_torch.ops import attention, xent
from container_engine_accelerators_tpu_torch.parallel import train as ptrain
from container_engine_accelerators_tpu_torch.parallel import Sgd, Trainer
from tests import torch_parity

LM = dict(vocab_size=48, embed_dim=32, num_layers=2, num_heads=4,
          max_seq_len=32)


@pytest.fixture(autouse=True)
def clean_tracers():
    obs.TRACER.reset()
    jax_obs.TRACER.reset()
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
    obs.TRACER.reset()
    jax_obs.TRACER.reset()


def _gauges(tracer):
    return {key: v for key, v in tracer.gauges().items()}


# -- peak FLOPs and numerators ------------------------------------------

def test_peak_flops_table_and_override(monkeypatch):
    monkeypatch.delenv(efficiency.PEAK_FLOPS_ENV, raising=False)
    for kind in ("TPU v4", "TPU v5 lite", "TPU v5", "TPU v6e", "cpu", None):
        assert (efficiency.peak_flops_per_chip(kind)
                == jax_eff.peak_flops_per_chip(kind))
    assert efficiency.peak_flops_per_chip("TPU v5 lite") == 197e12
    # The card's name as torch reports it; the TPU rows do not match it.
    assert efficiency.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert jax_eff.peak_flops_per_chip("NVIDIA H100 80GB HBM3") is None
    assert efficiency.device_kind("cpu") == "cpu"
    monkeypatch.setenv(efficiency.PEAK_FLOPS_ENV, "123.5e12")
    assert efficiency.peak_flops_per_chip("cpu") == 123.5e12
    monkeypatch.setenv(efficiency.PEAK_FLOPS_ENV, "junk")
    assert efficiency.peak_flops_per_chip("NVIDIA H100 PCIe") == 989e12


def test_analytic_flops_formulas():
    for n, t in ((100, 32), (7, 1)):
        assert (efficiency.transformer_train_flops(n, t)
                == jax_eff.transformer_train_flops(n, t) == 6 * n * t)
        assert (efficiency.transformer_decode_flops(n, t)
                == jax_eff.transformer_decode_flops(n, t) == 2 * n * t)


def test_decode_flops_count_attention_over_live_keys():
    """The serving loop's decode FLOPs add 4·D per attended key per
    query head per layer over each active row's live context (what the
    benchmark's decode_mfu counts): a row at position p of a window-W
    model attends min(p + 1, W) keys."""
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM)

    torch.manual_seed(0)
    model = TransformerLM(vocab_size=64, embed_dim=32, num_layers=2,
                          num_heads=4, max_seq_len=64, attention_window=8,
                          dtype=torch.float32, device="cpu")
    eng = decode.SlotDecodeEngine(model, 3, 32, paged=False)
    for plen in (5, 9):
        row = np.zeros((16,), np.int64)
        row[:plen] = np.arange(1, plen + 1)
        eng.admit(row, plen)
    keys = eng.live_keys()
    assert keys == min(5 + 1, 8) + min(9 + 1, 8)
    assert eng.key_flops == 4 * (32 // 4) * 4 * 2
    n = eng.active_param_count
    assert efficiency.transformer_decode_flops(
        n, 2, keys, eng.key_flops) == 2 * n * 2 + 4 * 8 * 4 * 2 * 14


@pytest.mark.parametrize("causal, window", [(False, 0), (True, 0),
                                            (True, 5)])
def test_count_flops_counts_kernels_by_their_kept_pairs(causal, window):
    """A flash forward and backward on the CPU: FlopCounterMode alone
    counts the plain versions' products over every pair (4, 6 and 8
    D a pair); under count_flops the wrappers declare the kept pairs
    instead, the count the card gives the kernels."""
    from torch.utils.flop_counter import FlopCounterMode

    b, s, h, d = 2, 12, 3, 8
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, requires_grad=True)
               for _ in range(3))

    def fwd_bwd():
        o = attention.flash_attention(q, k, v, causal=causal, window=window)
        o.sum().backward()
        return o

    plain = FlopCounterMode(display=False)
    with plain:
        fwd_bwd()
    assert plain.get_total_flops() == 18 * d * s * s * b * h
    _, counted = efficiency.count_flops(fwd_bwd)
    kept = attention.kept_pairs(s, causal, window)
    assert counted == 18 * d * kept * b * h
    assert kept == sum(min(i + 1, window or s) if causal else s
                       for i in range(s))
    assert not efficiency._COUNTS


def _linear_weights(model):
    return sum(m.weight.numel() for m in model.modules()
               if isinstance(m, torch.nn.Linear))


def test_train_step_flops_auto_and_analytic():
    """mfu_source="auto" counts the first step: 6·N·T over the linear
    weights (the embedding lookup multiplies nothing) plus the flash
    kernels' 18·D FLOPs a kept pair a layer; "analytic" is the JAX
    Trainer's 6·N·B·S over every parameter, N equal to the flax
    tree's."""
    _, tree, config = torch_parity.flax_lm_of(seed=1, **LM)
    batch, seq = 2, 16
    tokens = torch.as_tensor(torch_parity.tokens(3, (batch, seq),
                                                 LM["vocab_size"]))
    flops = {}
    for source in ("auto", "analytic", 12345.0):
        model = torch_parity.port_lm(config, tree).train()
        for p in model.parameters():
            p.requires_grad_(True)
        loss = transformer.next_token_loss_fn(xent.mean_cross_entropy_loss)
        trainer = Trainer(model, loss, Sgd(0.1), mfu_source=source)
        state = trainer.init_state()
        assert trainer.flops_per_step() is None
        trainer.train_step(state, (tokens, tokens))
        flops[source] = trainer.flops_per_step()
    d = LM["embed_dim"] // LM["num_heads"]
    attn = (18 * d * attention.kept_pairs(seq, True, 0) * batch
            * LM["num_heads"] * LM["num_layers"])
    assert flops["auto"] == 6 * _linear_weights(model) * batch * seq + attn
    n_flax = sum(int(x.size) for x in jax.tree_util.tree_leaves(tree))
    assert flops["analytic"] == jax_eff.transformer_train_flops(
        n_flax, batch * seq)
    assert flops[12345.0] == 12345.0
    off = Trainer(model, loss, Sgd(0.1), mfu_source="off")
    off.train_step(off.init_state(), (tokens, tokens))
    assert off.flops_per_step() is None
    with pytest.raises(ValueError, match="mfu_source"):
        Trainer(model, loss, Sgd(0.1), mfu_source="xla")


def test_flops_ledger_publishes_gauge():
    ours = efficiency.FlopsLedger(gauge="test_mfu", peak_flops=1000.0,
                                  chips=2, publish_every=4)
    theirs = jax_eff.FlopsLedger(gauge="test_mfu", peak_flops=1000.0,
                                 chips=2, publish_every=4)
    for ledger in (ours, theirs):
        ledger.observe(100.0, 0.1)
        assert ledger.mfu() == pytest.approx(0.5)
        assert ledger.achieved_flops() == pytest.approx(1000.0)
        for f, s in ((100.0, 0.2), (None, 0.1), (100.0, 0.0), (50, 0.1),
                     (300.0, 0.3)):
            ledger.observe(f, s)
    assert ours.mfu() == theirs.mfu()
    assert ours.achieved_flops() == theirs.achieved_flops()
    assert _gauges(obs.TRACER) == _gauges(jax_obs.TRACER)
    nop = efficiency.FlopsLedger(gauge="test_mfu2", peak_flops=None)
    nop.observe(100.0, 0.1)
    assert nop.mfu() is None and nop.achieved_flops() == pytest.approx(
        1000.0)
    nop.reset()
    assert nop.achieved_flops() is None


# -- goodput ledger -------------------------------------------------------

def _books(module, records, wall):
    t = [0.0]
    ledger = module.GoodputLedger(clock=lambda: t[0])
    for bucket, seconds in records:
        ledger.record(bucket, seconds)
    t[0] = wall
    return ledger


@pytest.mark.parametrize("records, wall", [
    ([("compile", 2.0), ("productive", 5.0), ("data_wait", 1.0)], 10.0),
    ([("productive", 6.0), ("checkpoint", 2.0)], 4.0),   # overlap
])
def test_goodput_ledger_books_balance(records, wall):
    ours = _books(efficiency, records, wall)
    theirs = _books(jax_eff, records, wall)
    assert ours.summary() == theirs.summary()
    s = ours.publish()
    theirs.publish()
    assert s["wall_s"] == wall
    assert sum(s["buckets"].values()) == pytest.approx(wall)
    assert _gauges(obs.TRACER) == _gauges(jax_obs.TRACER)
    assert (efficiency.GOODPUT_BUCKETS, efficiency.SPAN_BUCKETS) == (
        jax_eff.GOODPUT_BUCKETS, jax_eff.SPAN_BUCKETS)


def test_goodput_ledger_rejects_unknown_bucket():
    with pytest.raises(ValueError, match="unknown goodput bucket"):
        efficiency.GoodputLedger().record("coffee", 1.0)


T0 = 500.0
SNAPSHOTS = {
    "known_timings": {
        "identity": {"role": "train", "host": "h0", "pid": 7},
        "spans": [
            {"name": "train.step_compile", "start_unix": T0,
             "duration_s": 1.0},
            {"name": "train.step_run", "start_unix": T0 + 1.0,
             "duration_s": 2.0},
            {"name": "train.data_wait", "start_unix": T0 + 3.0,
             "duration_s": 0.5},
            {"name": "train.checkpoint", "start_unix": T0 + 3.5,
             "duration_s": 0.5},
            {"name": "unrelated.span", "start_unix": T0 + 4.0,
             "duration_s": 1.0},
        ],
        "events": [{"name": "train.restart", "unix": T0,
                    "fields": {"recovery_s": 0.25}}],
    },
    "straggler_episode": {
        "identity": {"role": "train", "host": "h1", "pid": 8},
        "spans": [{"name": "train.step_run", "start_unix": T0,
                   "duration_s": 8.0}],
        "events": [
            {"name": "straggler.detected", "unix": T0 + 2.0,
             "fields": {"host": "h1", "skew_ratio": 2.0}},
            {"name": "straggler.recovered", "unix": T0 + 6.0,
             "fields": {"host": "h1"}}],
    },
    "stall_clamped": {
        "identity": {"role": "train", "host": "h1", "pid": 9},
        "spans": [{"name": "train.step_run", "start_unix": T0,
                   "duration_s": 1.0}],
        "events": [
            {"name": "straggler.detected", "unix": T0,
             "fields": {"host": "h1", "skew_ratio": 10.0}},
            {"name": "straggler.recovered", "unix": T0 + 100.0,
             "fields": {"host": "h1"}}],
    },
}
WANT = {
    "known_timings": dict(compile=1.0, productive=2.0, data_wait=0.5,
                          checkpoint=0.5, restart=0.25, other=0.75),
    "straggler_episode": dict(straggler_stall=2.0, productive=6.0),
    "stall_clamped": dict(straggler_stall=1.0, productive=0.0),
}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_replay_matches_the_jax_replay(name):
    snap = SNAPSHOTS[name]
    s = efficiency.ledger_from_snapshot(snap).summary()
    assert s == jax_eff.ledger_from_snapshot(snap).summary()
    for bucket, seconds in WANT[name].items():
        assert s["buckets"][bucket] == pytest.approx(seconds)
    assert sum(s["buckets"].values()) == pytest.approx(s["wall_s"])


def test_report_combines_processes():
    snap = {"identity": {"role": "train", "host": "h", "pid": 1},
            "spans": [{"name": "train.step_run", "start_unix": 0.0,
                       "duration_s": 1.0}], "events": []}
    other = dict(snap, identity={"role": "serving", "host": "h", "pid": 2})
    report = efficiency.report_from_snapshots([snap, other])
    assert report == jax_eff.report_from_snapshots([snap, other])
    assert report["combined"]["goodput_ratio"] == pytest.approx(1.0)


def test_trainer_books_match_the_jax_ledgers():
    """A port Trainer on a scripted clock (each read advances 0.5 s):
    its goodput books and MFU equal the JAX ledgers' fed the same
    timings (compile, then productive steps; MFU over the gaps between
    step boundaries, the first boundary only anchoring)."""
    clock = [0.0]

    def tick():
        clock[0] += 0.5
        return clock[0]

    wall = [0.0]
    model = torch.nn.Linear(4, 3)
    trainer = Trainer(model, torch.nn.functional.cross_entropy, Sgd(0.1),
                      mfu_source=1e6, summary_every=2,
                      goodput=efficiency.GoodputLedger(clock=lambda: wall[0]))
    trainer._mfu_ledger = efficiency.FlopsLedger(peak_flops=1e7,
                                                 publish_every=2)
    real_time = ptrain.time
    ptrain.time = types.SimpleNamespace(perf_counter=tick)
    try:
        state = trainer.init_state()
        batch = (torch.ones(2, 4), torch.tensor([0, 1]))
        for _ in range(5):
            trainer.train_step(state, batch)
    finally:
        ptrain.time = real_time
    jax_wall = [0.0]
    theirs = jax_eff.GoodputLedger(clock=lambda: jax_wall[0])
    theirs.record("compile", 0.5)
    mfu = jax_eff.FlopsLedger(peak_flops=1e7, publish_every=2)
    for _ in range(4):
        theirs.record("productive", 0.5)
    for _ in range(3):   # 4 recorded steps: 3 gaps of 3 reads each
        mfu.observe(1e6, 1.5)
    wall[0] = jax_wall[0] = 20.0
    assert trainer.goodput.summary() == theirs.summary()
    assert trainer._mfu().mfu() == mfu.mfu() == pytest.approx(1e6 / 1.5 / 1e7)
    # summary_every 2: the 2nd and 4th recorded steps published the
    # goodput gauges and a step summary event.
    summaries = [e for e in obs.TRACER.snapshot()["events"]
                 if e["name"] == "train.step_summary"]
    assert [e["fields"]["step"] for e in summaries] == [2, 4]
    assert (efficiency.GOODPUT_GAUGE, ()) in obs.TRACER.gauges()


# -- the engine's parameter counts ----------------------------------------

def test_engine_active_param_count_discounts_unrouted_experts():
    """The MFU numerator's N: every parameter for a dense model; the
    MoE's expert-stacked leaves at top_k/num_experts. Equal to the JAX
    engine's on the same weights."""
    dense, tree, config = torch_parity.flax_lm_of(seed=0, **LM)
    port = torch_parity.port_lm(config, tree)
    eng = decode.SlotDecodeEngine(port, 1, 14, paged=False)
    theirs = jax_decode.SlotDecodeEngine(dense, tree, slots=1, slot_len=14)
    assert eng.active_param_count == eng.param_count == theirs.param_count
    moe, moe_tree, moe_config = torch_parity.flax_moe(top_k=1)
    port = torch_parity.port_lm(moe_config, moe_tree)
    eng = decode.SlotDecodeEngine(port, 1, 14, paged=False)
    theirs = jax_decode.SlotDecodeEngine(moe, moe_tree, slots=1, slot_len=14)
    assert eng.param_count == theirs.param_count
    assert eng.active_param_count == theirs.active_param_count
    assert eng.active_param_count < eng.param_count


# -- device memory ----------------------------------------------------------

class _FakeDev:
    def __init__(self, name, in_use, limit, peak=None, stats=True):
        self._name = name
        self._stats = ({"bytes_in_use": in_use,
                        "peak_bytes_in_use": peak or in_use,
                        "bytes_limit": limit} if stats else None)

    def memory_stats(self):
        return self._stats

    def __str__(self):
        return self._name


def _both_monitors():
    return (memory.MemoryMonitor(soft_limit=0.9),
            jax_memory.MemoryMonitor(soft_limit=0.9))


def test_memory_monitor_gauges_and_watermark():
    ours, theirs = _both_monitors()
    for devs in ([_FakeDev("cuda:0", 400, 1000, peak=450),
                  _FakeDev("cpu", 0, 0, stats=False)],
                 [_FakeDev("cuda:0", 300, 1000)],
                 [_FakeDev("cuda:0", 700, 1000)]):
        assert ours.sample(devices=devs) == theirs.sample(devices=devs)
        assert ours.watermarks() == theirs.watermarks()
    assert ours.totals() == theirs.totals() == {
        "hbm_in_use_bytes": 700, "hbm_peak_bytes": 700}
    assert _gauges(obs.TRACER) == _gauges(jax_obs.TRACER)


def test_memory_watermark_survives_an_allocator_peak_reset():
    """torch.cuda.reset_peak_memory_stats() between two samples drops
    the allocator's peak; the monitor's watermark stays."""
    mon = memory.MemoryMonitor(soft_limit=0.9)
    mon.sample(devices=[_FakeDev("cuda:0", 200, 1000, peak=900)])
    mon.sample(devices=[_FakeDev("cuda:0", 200, 1000, peak=200)])
    assert mon.watermarks() == {"cuda:0": 900}
    assert mon.totals()["hbm_peak_bytes"] == 900


def test_memory_pressure_exactly_one_event_per_episode():
    ours, theirs = _both_monitors()
    for in_use in (950, 960, 870, 800, 990):
        for mon in (ours, theirs):
            mon.sample(devices=[_FakeDev("cuda:0", in_use, 1000)])

    def names(tracer):
        return [(e["name"], e["fields"]) for e in
                tracer.snapshot()["events"]
                if e["name"].startswith("memory.")]

    assert names(obs.TRACER) == names(jax_obs.TRACER)
    assert [n for n, _ in names(obs.TRACER)] == [
        memory.PRESSURE_EVENT, memory.RECOVERED_EVENT,
        memory.PRESSURE_EVENT]


def test_memory_monitor_throttles_inside_interval():
    mon = memory.MemoryMonitor(soft_limit=0.9)
    mon.sample(devices=[_FakeDev("cuda:0", 100, 1000)])
    cached = mon.sample(devices=[_FakeDev("cuda:0", 999, 1000)],
                        min_interval_s=60.0)
    assert cached["cuda:0"]["bytes_in_use"] == 100


def test_memory_postmortem_provider_carries_watermarks(tmp_path):
    mon = memory.MemoryMonitor(soft_limit=0.9)
    mon.sample(devices=[_FakeDev("cuda:0", 640, 1000)])
    memory.install_postmortem_provider(mon)
    try:
        out = postmortem.capture("test", path=str(tmp_path / "pm.json"))
        doc = json.loads((tmp_path / "pm.json").read_text())
        state = doc["postmortem_state"][memory.STATE_PROVIDER_NAME]
        assert state["watermarks"] == {"cuda:0": 640}
        assert state["soft_limit"] == 0.9
        assert out == str(tmp_path / "pm.json")
    finally:
        postmortem.unregister_state_provider(memory.STATE_PROVIDER_NAME)


def test_device_memory_stats_without_a_card_degrades():
    """No allocator statistics off the card: an empty dict, as the JAX
    module answers on its CPU backend."""
    assert memory.device_memory_stats([torch.device("cpu")]) == {}
    assert memory.device_memory_stats() == {}
    assert jax_memory.device_memory_stats(jax.local_devices()) == {}


# -- profiler ---------------------------------------------------------------

def test_profiler_capture_produces_artifact(tmp_path, monkeypatch):
    monkeypatch.setenv(profiler.OUT_DIR_ENV, str(tmp_path))
    cap = profiler.ProfileCapture()
    result = cap.capture(seconds=0.05)
    assert result["artifact"].startswith(str(tmp_path))
    with open(result["trace"]) as f:
        assert "traceEvents" in json.load(f)
    events = [e for e in obs.TRACER.snapshot()["events"]
              if e["name"] == profiler.CAPTURE_EVENT]
    assert events and events[0]["fields"]["artifact"] == result["artifact"]
    assert cap.last() == result
    assert obs.TRACER.counters()[(profiler.PROFILE_CAPTURES, ())] == 1


def test_profiler_serialized_second_caller_busy():
    cap = profiler.ProfileCapture()
    entered, release = threading.Event(), threading.Event()

    def hold():
        with cap._lock:
            entered.set()
            release.wait(timeout=10)

    t = threading.Thread(target=hold)
    t.start()
    entered.wait(timeout=10)
    try:
        assert cap.busy()
        with pytest.raises(profiler.ProfilerBusy):
            cap.capture(seconds=0.01)
    finally:
        release.set()
        t.join(timeout=10)
    assert not cap.busy()


def test_profile_response_status_codes(monkeypatch, tmp_path):
    assert profiler.profile_response("/debug/varz") is None
    assert profiler.profile_response("/debug/profile", "seconds=abc")[0] \
        == 400
    monkeypatch.setattr(profiler, "CAPTURE", profiler.ProfileCapture())
    assert profiler.CAPTURE._lock.acquire(blocking=False)
    try:
        status, _, body = profiler.profile_response(
            "/debug/profile", "seconds=0.01")
        assert status == 409 and json.loads(body)["busy"] is True
    finally:
        profiler.CAPTURE._lock.release()

    class Broken:
        def __init__(self, activities, **kwargs):
            pass

        def start(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    status, _, body = profiler.profile_response(
        "/debug/profile", "seconds=0.01")
    doc = json.loads(body)
    assert status == 501 and doc["available"] is False and "error" in doc
    monkeypatch.undo()
    monkeypatch.setenv(profiler.OUT_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(profiler, "CAPTURE", profiler.ProfileCapture())
    status, _, body = profiler.profile_response(
        "/debug/profile", "seconds=0.02")
    doc = json.loads(body)
    assert status == 200 and doc["ok"] and os.path.isfile(doc["trace"])


# -- the serving surface --------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_engine_request_populates_slo_metrics(monkeypatch, tmp_path):
    """One greedy request on a port server: TTFT/TPOT histograms, the
    SLO burn counter against impossible thresholds, decode_mfu on a
    rated CPU, the HBM fields (None: no card), /debug/profile (200
    free, 409 held), and tokens equal to the JAX package's decode()."""
    from container_engine_accelerators_tpu_torch.serving.server import (
        SLO_COUNTER,
        TPOT_HISTOGRAM,
        TTFT_HISTOGRAM,
        GenerationServer,
    )

    monkeypatch.setenv("CEA_TPU_SLO_TTFT_MS", "0.0001")
    monkeypatch.setenv("CEA_TPU_SLO_TPOT_MS", "0.0001")
    monkeypatch.setenv("CEA_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv(profiler.OUT_DIR_ENV, str(tmp_path))
    monkeypatch.setattr(profiler, "CAPTURE", profiler.ProfileCapture())
    jmodel, tree, config = torch_parity.flax_lm_of(seed=1, **LM)
    srv = GenerationServer("lm", torch_parity.port_lm(config, tree),
                           port=0, host="127.0.0.1", max_new_tokens=8,
                           max_batch=2, buckets=[8])
    srv.start()
    try:
        prompts, new = [[1, 2, 3, 4], [5, 6, 7, 8]], 6
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/models/lm:generate",
            data=json.dumps({"prompts": prompts,
                             "max_new_tokens": new}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        ref = np.asarray(jax_decode.decode(
            jmodel, tree, jnp.asarray(prompts, jnp.int32), new,
            prompt_len=np.array([4, 4]), fast_prefill=False))
        assert out["sequences"] == ref[:, :4 + new].tolist()
        _, stats = _get(srv.port, "/stats")
        assert stats["slo"]["violations"] == {"ttft": 2,
                                              "tpot": 2 * (new - 1)}
        assert stats["ttft_p99_ms"] is not None
        assert stats["decode_mfu"] is not None and stats["decode_mfu"] > 0
        assert stats["hbm_in_use_bytes"] is None
        assert stats["hbm_peak_bytes"] is None
        hists = {h.name: h for h in obs.TRACER.histograms()}
        assert hists[TTFT_HISTOGRAM].count == 2
        assert hists[TPOT_HISTOGRAM].count == 2 * (new - 1)
        text = obs.prometheus_text(obs.TRACER)
        assert f'{SLO_COUNTER}{{slo="ttft"}} 2' in text
        assert "tpu_decode_mfu" in text
        status, doc = _get(srv.port, "/debug/profile?seconds=0.02")
        assert status == 200 and os.path.isfile(doc["trace"])
        assert profiler.CAPTURE._lock.acquire(blocking=False)
        try:
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(srv.port, "/debug/profile?seconds=0.02")
            assert err.value.code == 409
        finally:
            profiler.CAPTURE._lock.release()
    finally:
        srv.stop()

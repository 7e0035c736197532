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
"""The port's straggler detector against the JAX package's, case for
case with tests/test_straggler.py: the same step times give the same
skews, gauges and episode events on both; the journal replay; and four
port Trainers feeding one detector, one of them slow."""


import pytest
import torch

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.obs import straggler as jax_straggler
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.obs.straggler import (
    SKEW_GAUGE,
    StragglerDetector,
    scan_events,
)
from container_engine_accelerators_tpu_torch.parallel import (
    Sgd,
    Trainer,
    cross_entropy_loss,
)
from container_engine_accelerators_tpu_torch.parallel import (
    train as train_mod,
)


@pytest.fixture(autouse=True)
def clean_tracer():
    obs.TRACER.reset()
    yield
    obs.TRACER.reset()


def _pair(**kw):
    """(port detector, JAX detector), each on its own enabled tracer."""
    ours, theirs = obs.Tracer(enabled=True), jax_obs.Tracer(enabled=True)
    return (StragglerDetector(tracer=ours, **kw),
            jax_straggler.StragglerDetector(tracer=theirs, **kw))


def _drive(dets, steps, times_by_host):
    for _ in range(steps):
        for host, t in times_by_host.items():
            for det in dets:
                det.observe(host, t)


def _same(dets):
    ours, theirs = dets
    assert ours.skews() == theirs.skews()
    assert ours.flagged() == theirs.flagged()
    assert ours.event_count() == theirs.event_count()
    assert ours._tracer.gauges() == theirs._tracer.gauges()
    strip = [[(e["name"], e["fields"]) for e in d._tracer.snapshot()[
        "events"]] for d in dets]
    assert strip[0] == strip[1]


def test_detects_one_slow_host_exactly_once():
    dets = _pair(window=16, factor=1.5, min_samples=4)
    _drive(dets, 50, {"host0": 0.10, "host1": 0.10, "host2": 0.10,
                      "host3": 0.25})
    _same(dets)
    events = [e for e in dets[0]._tracer.snapshot()["events"]
              if e["name"] == "straggler.detected"]
    assert len(events) == 1 and events[0]["fields"]["host"] == "host3"
    assert events[0]["fields"]["skew_ratio"] == pytest.approx(2.5,
                                                              rel=0.05)
    gauges = {labels: v for (name, labels), v
              in dets[0]._tracer.gauges().items() if name == SKEW_GAUGE}
    assert gauges[(("host", "host3"),)] > 1.5


def test_recovery_emits_event_and_rearms():
    dets = _pair(window=8, factor=1.5, min_samples=4)
    _drive(dets, 20, {"h0": 0.1, "h1": 0.1, "h2": 0.3})
    _drive(dets, 20, {"h0": 0.1, "h1": 0.1, "h2": 0.1})
    assert dets[0].flagged() == []
    _drive(dets, 20, {"h0": 0.1, "h1": 0.1, "h2": 0.3})
    _same(dets)
    assert dets[0].event_count() == 2
    names = [e["name"] for e in dets[0]._tracer.snapshot()["events"]]
    assert names.count("straggler.recovered") == 1


def test_no_detection_below_min_samples_or_single_host():
    dets = _pair(window=16, factor=1.5, min_samples=8)
    _drive(dets, 3, {"h0": 0.1, "h1": 0.9})
    assert dets[0].skews() == dets[1].skews() == {}
    solo = _pair(window=16, factor=1.5, min_samples=2)
    _drive(solo, 20, {"only": 0.5})
    _same(solo)
    assert solo[0].skews() == {} and solo[0].event_count() == 0
    with pytest.raises(ValueError, match="factor"):
        StragglerDetector(factor=1.0)


def test_scan_events_replays_merged_journals():
    events = []
    for step in range(1, 13):
        for host, p50 in (("host0", 100.0), ("host1", 102.0),
                          ("host2", 240.0)):
            events.append({"name": "train.step_summary",
                           "unix": 1000.0 + step,
                           "fields": {"host": host, "step": step,
                                      "step_time_p50_ms": p50,
                                      "data_wait_p50_ms": 1.0}})
    events.append({"name": "health.transition", "unix": 999.0,
                   "fields": {"device": "accel0"}})
    det = scan_events(events, window=8, factor=1.5, min_samples=4,
                      tracer=obs.Tracer(enabled=False))
    theirs = jax_straggler.scan_events(
        events, window=8, factor=1.5, min_samples=4,
        tracer=jax_obs.Tracer(enabled=False))
    assert det.flagged() == theirs.flagged() == ["host2"]
    assert det.skews() == theirs.skews()
    assert det.skews()["host2"] == pytest.approx(240 / 102, rel=0.05)


class _FakeClock:
    """The Trainer's ``time`` module stand-in: ``perf_counter`` reads
    a counter that only ``advance`` moves, so each step's measured
    time is exactly its synthetic cost whatever the host's load."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    def advance(self, seconds):
        self.now += seconds


def test_synthetic_slow_host_in_a_four_trainer_loop(monkeypatch):
    """Four port Trainers (host0..host3, one model each) feed one
    detector; host3's step carries 3x the others' synthetic device
    cost: exactly one straggler.detected event names it, its skew
    gauge is above 1.5, and every host's train.step_summary events
    reach the journal. The Trainer's clock is a fake that the stalled
    step advances by its cost, so the skew the detector sees does not
    depend on how loaded the CPU is."""
    clock = _FakeClock()
    monkeypatch.setattr(train_mod, "time", clock)
    detector = StragglerDetector(window=8, factor=1.5, min_samples=4)
    batch = (torch.ones(2, 4), torch.zeros(2, dtype=torch.long))
    hosts = []
    for idx in range(4):
        trainer = Trainer(torch.nn.Linear(4, 2), cross_entropy_loss,
                          Sgd(0.1), host_id=f"host{idx}", summary_every=4,
                          mfu_source="off")
        state = trainer.init_state()
        trainer.train_step(state, batch)   # the compile step
        trainer._straggler = detector

        def stalled(state, batch, step=trainer._step,
                    cost=0.03 if idx == 3 else 0.01):
            out = step(state, batch)
            clock.advance(cost)
            return out

        trainer._step = stalled
        hosts.append((trainer, state))
    for _ in range(16):
        for trainer, state in hosts:
            trainer.train_step(state, batch)
    events = [e for e in obs.TRACER.snapshot()["events"]
              if e["name"] == "straggler.detected"]
    assert len(events) == 1, events
    assert events[0]["fields"]["host"] == "host3"
    gauges = {labels: v for (name, labels), v
              in obs.TRACER.gauges().items() if name == SKEW_GAUGE}
    assert gauges[(("host", "host3"),)] > 1.5
    summaries = [e for e in obs.TRACER.snapshot()["events"]
                 if e["name"] == "train.step_summary"]
    assert {e["fields"]["host"] for e in summaries} == {
        f"host{i}" for i in range(4)}

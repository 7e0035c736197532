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
"""The port tracer's journal tooling against the JAX package's:
drop_gauges, open_span_count and reset behave alike on the same calls;
write_journal and the CEA_TPU_TRACE_FILE atexit writer produce the JAX
journal's shape; and report_from_snapshots reads a port journal (a
port Trainer's run) and a JAX journal alike, in either package."""

import json
import subprocess
import sys

import pytest
import torch

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.obs import efficiency as jax_eff
from container_engine_accelerators_tpu.obs import trace as jax_trace
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.obs import efficiency
from container_engine_accelerators_tpu_torch.obs import trace
from container_engine_accelerators_tpu_torch.parallel import (
    Sgd,
    Trainer,
    cross_entropy_loss,
)
from tests.conftest import REPO_ROOT


@pytest.fixture(autouse=True)
def clean_tracers():
    obs.TRACER.reset()
    jax_obs.TRACER.reset()
    yield
    obs.TRACER.reset()
    jax_obs.TRACER.reset()


def _both(fn):
    """Run ``fn(tracer)`` on a fresh port tracer and a fresh JAX
    tracer; returns both."""
    tracers = (trace.Tracer(enabled=True), jax_trace.Tracer(enabled=True))
    for t in tracers:
        fn(t)
    return tracers


def test_drop_gauges_matches_the_jax_tracer():
    def publish(t):
        t.gauge("shape_free", 4, shape="2x2", node="a")
        t.gauge("shape_free", 1, shape="4x4", node="a")
        t.gauge("shape_free", 3, shape="2x2", node="b")
        t.gauge("other", 7)
        t.drop_gauges(["shape_free"], keep_labels={"node": "a"})

    ours, theirs = _both(publish)
    assert ours.gauges() == theirs.gauges()
    assert sorted(k[1] for k in ours.gauges() if k[0] == "shape_free") == [
        (("node", "a"), ("shape", "2x2")), (("node", "a"), ("shape", "4x4"))]
    for t in (ours, theirs):
        t.drop_gauges(["shape_free"])
    assert ours.gauges() == theirs.gauges() == {("other", ()): 7.0}


def test_open_span_count_and_reset():
    hist = obs.TRACER.histogram("test_reset_seconds")
    hist.observe(0.5)
    obs.counter("test_total")
    obs.gauge("test_gauge", 2.0)
    obs.event("test.event")
    with obs.span("outer"):
        with obs.span("inner"):
            assert obs.TRACER.open_span_count() == 2
        assert obs.TRACER.open_span_count() == 1
        obs.TRACER.reset()
        assert obs.TRACER.open_span_count() == 0
        assert obs.TRACER.current() is None
    snap = obs.TRACER.snapshot()
    assert snap["events"] == [] and snap["dropped_spans"] == 0
    assert obs.TRACER.counters() == {} and obs.TRACER.gauges() == {}
    # Zeroed in place: the holder's reference stays on the surface.
    assert hist.count == 0
    assert obs.TRACER.histogram("test_reset_seconds") is hist


def test_write_journal_shape_and_final_flag(tmp_path, monkeypatch):
    monkeypatch.delenv("CEA_TPU_TRACE_FILE", raising=False)
    monkeypatch.setattr(trace, "_final_written", False)
    assert trace.write_journal(reason="x") is None
    with obs.span("open.one"):
        path = trace.write_journal(path=str(tmp_path / "j.json"),
                                   reason="manual", state={"k": 1})
        with jax_obs.span("open.one"):
            jax_trace.write_journal(path=str(tmp_path / "jax.json"),
                                    reason="manual", state={"k": 1})
    doc = json.loads((tmp_path / "j.json").read_text())
    jax_doc = json.loads((tmp_path / "jax.json").read_text())
    assert path == str(tmp_path / "j.json")
    # The port's journal adds its clock's anchor and the device spans'
    # drop count to the JAX package's shape.
    assert set(doc) == set(jax_doc) | {"anchor", "dropped_device"}
    assert doc["exit_reason"] == "manual"
    assert doc["postmortem_state"] == {"k": 1}
    assert [s["name"] for s in doc["open_spans"]] == ["open.one"]
    # A final capture to another path leaves the atexit writer armed.
    trace.write_journal(path=str(tmp_path / "k.json"), final=True)
    assert trace._final_written is False


def test_trace_file_written_at_exit(tmp_path):
    """CEA_TPU_TRACE_FILE: a port process's journal lands at exit."""
    path = tmp_path / "exit.json"
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO_ROOT!r})\n"
            "from container_engine_accelerators_tpu_torch import obs\n"
            "with obs.span('train.step_run'):\n"
            "    pass\n"
            "obs.event('train.restart', recovery_s=0.5)\n")
    env = {"CEA_TPU_TRACE_FILE": str(path), "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=60)
    doc = json.loads(path.read_text())
    assert doc["exit_reason"] == "atexit"
    assert [s["name"] for s in doc["spans"]] == ["train.step_run"]
    assert doc["events"][0]["fields"] == {"recovery_s": 0.5}


def test_report_reads_port_and_jax_journals_alike(monkeypatch):
    """A port Trainer's journal (its compile and run spans) and a JAX
    journal with the same span names: each package's replay gives the
    same report over both, and the port journal's productive and
    compile seconds are the spans the Trainer recorded."""
    monkeypatch.setenv("CEA_TPU_ROLE", "train")
    trainer = Trainer(torch.nn.Linear(4, 2), cross_entropy_loss, Sgd(0.1),
                      mfu_source="off")
    state = trainer.init_state()
    batch = (torch.ones(2, 4), torch.zeros(2, dtype=torch.long))
    for _ in range(4):
        trainer.train_step(state, batch)
    port_journal = json.loads(json.dumps(obs.TRACER.snapshot()))
    with jax_obs.span("train.step_compile"):
        pass
    for _ in range(3):
        with jax_obs.span("train.step_run"):
            pass
    jax_journal = json.loads(json.dumps(jax_obs.TRACER.snapshot()))
    both = [port_journal, jax_journal]
    report = efficiency.report_from_snapshots(both)
    assert report == jax_eff.report_from_snapshots(both)
    assert [p["identity"]["role"] for p in report["processes"]][0] == "train"
    spans = {}
    for span in port_journal["spans"]:
        spans[span["name"]] = spans.get(span["name"], 0.0) + span[
            "duration_s"]
    ours = report["processes"][0]["buckets"]
    assert ours["productive"] == pytest.approx(spans["train.step_run"],
                                               abs=1e-5)
    assert ours["compile"] == pytest.approx(spans["train.step_compile"],
                                            abs=1e-5)
    live = trainer.goodput.summary()["buckets"]
    assert live["productive"] == pytest.approx(ours["productive"], rel=0.05,
                                               abs=1e-4)

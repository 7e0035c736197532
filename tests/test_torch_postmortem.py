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
"""The port's postmortem capture against the JAX package's, case for
case with tests/test_postmortem.py: open spans and provider state in
the journal (the JAX journal's shape), first death wins, signal
chaining, drain-then-capture on the port's engine service, and the
port launcher SIGTERM'd mid-stream: the stream finishes, the process
exits 0, and CEA_TPU_TRACE_FILE holds the serving_requests,
serving_kv_blocks and hbm_memory state."""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.obs import postmortem as jax_pm
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.obs import postmortem, trace
from container_engine_accelerators_tpu_torch.serving.server import (
    _Admission,
    _EngineService,
    _EngineWork,
)
from tests import torch_parity
from tests.conftest import REPO_ROOT


@pytest.fixture(autouse=True)
def clean_tracer():
    obs.TRACER.reset()
    jax_obs.TRACER.reset()
    yield
    obs.TRACER.reset()
    jax_obs.TRACER.reset()


def test_capture_writes_open_spans_and_state(tmp_path):
    path, theirs = tmp_path / "pm.json", tmp_path / "jax_pm.json"
    for pm in (postmortem, jax_pm):
        pm.register_state_provider("device_health",
                                   lambda: {"cuda:0": "Healthy"})
        pm.register_state_provider("broken", lambda: 1 / 0)
    try:
        with obs.span("rpc.inflight", device="cuda:0"):
            out = postmortem.capture("manual", path=str(path))
        with jax_obs.span("rpc.inflight", device="cuda:0"):
            jax_pm.capture("manual", path=str(theirs))
    finally:
        for pm in (postmortem, jax_pm):
            pm.unregister_state_provider("device_health")
            pm.unregister_state_provider("broken")
    assert out == str(path)
    doc = json.loads(path.read_text())
    jax_doc = json.loads(theirs.read_text())
    # The port's journal adds its clock's anchor and the device spans'
    # drop count to the JAX package's shape.
    assert set(doc) == set(jax_doc) | {"anchor", "dropped_device"}
    assert set(doc["open_spans"][0]) == set(jax_doc["open_spans"][0])
    assert doc["exit_reason"] == "manual"
    assert [s["name"] for s in doc["open_spans"]] == ["rpc.inflight"]
    state = doc["postmortem_state"]
    assert state["device_health"] == {"cuda:0": "Healthy"}
    assert "ZeroDivisionError" in state["broken"]["provider_error"]
    assert doc["identity"]["pid"] == os.getpid()


def test_first_death_capture_wins(tmp_path, monkeypatch):
    death = tmp_path / "death.json"
    monkeypatch.setenv("CEA_TPU_TRACE_FILE", str(death))
    # The capture stands the process's atexit writer down; put it back.
    monkeypatch.setattr(trace, "_final_written", False)
    try:
        assert postmortem.capture("signal:TERM") == str(death)
        assert postmortem.capture("unhandled:Boom") is None
        assert postmortem.captured()
        assert json.loads(death.read_text())["exit_reason"] == "signal:TERM"
        side = tmp_path / "side.json"
        assert postmortem.capture("manual", path=str(side)) == str(side)
        assert json.loads(side.read_text())["exit_reason"] == "manual"
        assert postmortem.capture("forced", force=True) == str(death)
        assert json.loads(death.read_text())["exit_reason"] == "forced"
    finally:
        postmortem.uninstall()
    assert not postmortem.captured()


def test_install_chains_previous_handler_and_uninstalls():
    seen = []
    prev = signal.getsignal(signal.SIGUSR1)
    signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        postmortem.install(signals=(signal.SIGUSR1,), fatal_errors=False)
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert seen == [signal.SIGUSR1]
    finally:
        postmortem.uninstall()
        signal.signal(signal.SIGUSR1, prev)
    assert signal.getsignal(signal.SIGUSR1) is not postmortem._signal_handler


def test_drain_then_capture_attributes_inflight_request(tmp_path):
    """A request in flight when the drain starts retires inside the
    grace window; the capture after the drain holds its record, fully
    attributed (buckets summing to its wall time), and the live pool."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    _, tree, config = torch_parity.flax_lm_of(
        seed=1, vocab_size=48, embed_dim=32, num_layers=2, num_heads=4,
        max_seq_len=32)
    model = torch_parity.port_lm(config, tree)

    def factory():
        return decode.SlotDecodeEngine(model, 2, 20, paged=True,
                                       kv_block_size=4, buckets=[8],
                                       kv_quant="bf16", kv_spill=False)

    svc = _EngineService(factory(), _Admission(0), engine_factory=factory)
    try:
        row = np.zeros((8,), np.int32)
        row[:4] = [5, 6, 7, 8]
        work = _EngineWork(row, 4, 6, 0.0, 0, 1.0, 0.0, 1.0, -1, False, 0,
                           None)
        assert svc.submit_many([work]) is not None
        assert svc.drain(grace_s=120) is True
        status, out = work.done.get(timeout=10)
        assert status == "ok", out
        path = tmp_path / "drain_pm.json"
        assert postmortem.capture("signal:SIGTERM", path=str(path)) \
            == str(path)
        state = json.loads(path.read_text())["postmortem_state"]
        rec = state["serving_requests"]["records"][0]
        assert state["serving_requests"]["retired_total"] >= 1
        assert rec["outcome"] == "completed" and rec["tokens"] == 6
        assert abs(sum(rec["buckets"].values()) - rec["wall_s"]) <= max(
            0.01 * rec["wall_s"], 2e-5), rec
        assert state["serving_kv_blocks"]["paged"] is True
    finally:
        svc.stop()
        torch.set_num_threads(prev)
        postmortem.unregister_state_provider("serving_requests")
        postmortem.unregister_state_provider("serving_kv_blocks")


def test_sigterm_mid_stream_writes_postmortem_journal(tmp_path):
    """The port launcher as a process, SIGTERM'd with a stream in
    flight: the stream ends with its done line, the process exits 0,
    and the journal's flight record holds the drained request, the
    paged pool and the memory watermarks (none on the CPU)."""
    journal = tmp_path / "journal.json"
    new = 60
    argv = [sys.executable, "-m",
            "container_engine_accelerators_tpu_torch.serving.serve",
            "--model", "transformer", "--model-name", "lm", "--port", "0",
            "--device", "cpu", "--vocab-size", "48", "--embed-dim", "32",
            "--num-layers", "2", "--num-heads", "4", "--max-seq-len",
            "128", "--max-new-tokens", str(new), "--max-batch", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               CEA_TPU_TRACE_FILE=str(journal))
    proc = subprocess.Popen(argv, cwd=REPO_ROOT, env=env, text=True,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        port = None
        while port is None:
            line = proc.stderr.readline()
            assert line, "launcher exited before serving"
            m = re.search(r"on port (\d+)", line)
            port = int(m.group(1)) if m else None
        conn = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/lm:generate",
            data=json.dumps({"prompts": [[1, 2, 3]],
                             "max_new_tokens": new,
                             "stream": True}).encode()), timeout=120)
        first = json.loads(conn.readline())
        assert first.get("tokens")
        proc.send_signal(signal.SIGTERM)
        lines = [first] + [json.loads(x) for x in conn.read().splitlines()]
        conn.close()
        assert lines[-1] == {"done": True}
        assert sum(len(x.get("tokens", [])) for x in lines) == new
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    doc = json.loads(journal.read_text())
    assert doc["exit_reason"] == "signal:SIGTERM"
    assert doc["identity"]["role"] == "serving"
    state = doc["postmortem_state"]
    requests = state["serving_requests"]
    assert requests["retired_total"] == 1
    assert requests["records"][0]["outcome"] == "completed"
    assert requests["records"][0]["tokens"] == new
    assert state["serving_kv_blocks"]["paged"] is True
    assert state["hbm_memory"]["watermarks"] == {}

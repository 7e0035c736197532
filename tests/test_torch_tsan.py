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
"""The port's lock-order sanitizer (``analysis/tsan.py``), case for
case with the JAX package's tsan tests (tests/test_analysis.py), each
run alone and nested inside a JAX sanitizer session (what
tests/conftest.py installs process-wide under CEA_TPU_TSAN=1): the
port's copy must wrap the interpreter's own locks, never the JAX
wrapper, and hand the JAX constructors back when it uninstalls. Then
one session over the port's serving and checkpoint threads: a tiny
paged engine behind the port server with two concurrent streams, a
quarantine and an async checkpoint save comes out clean."""

import json
import queue as queue_mod
import threading
import urllib.request

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.analysis import tsan as jax_tsan
from container_engine_accelerators_tpu_torch.analysis import tsan
from container_engine_accelerators_tpu_torch.parallel.checkpoint import (
    CheckpointManager,
)
from container_engine_accelerators_tpu_torch.serving.server import (
    GenerationServer,
)
from container_engine_accelerators_tpu_torch.utils import faults
from tests import torch_parity


@pytest.fixture(params=["alone", "inside_jax_session"])
def outer(request):
    """Run the case alone, or inside a JAX sanitizer session; either
    way the port's sessions hand back the constructors they found (the
    JAX sanitizer's own uninstall makes fresh ones, so after a JAX
    session what is checked is the kind of lock they make)."""
    before = (threading.Lock, threading.RLock)
    kinds = (type(threading.Lock()), type(threading.RLock()))
    if request.param == "alone":
        yield None
        assert (threading.Lock, threading.RLock) == before
    else:
        with jax_tsan.session(force=True) as jax_state:
            inside = (threading.Lock, threading.RLock)
            yield jax_state
            assert not tsan.enabled()
            # The port's sessions handed the JAX wrapper back.
            assert (threading.Lock, threading.RLock) == inside
            assert type(threading.Lock()).__module__ == jax_tsan.__name__
        assert (type(threading.Lock()), type(threading.RLock())) == kinds


def _run_serialized(*targets):
    """Each target to completion on its own thread, one after another:
    a deterministic interleaving with no real deadlock risk."""
    for target in targets:
        t = threading.Thread(target=target)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()


def _wraps_a_real_lock(lock):
    real = getattr(lock, "_real", None)
    return type(real).__module__ == "_thread"


def test_tsan_flags_inverted_lock_order(outer):
    """Two threads taking (a, b) and (b, a): one cycle, both creation
    sites named (in this file)."""
    with tsan.session(force=True) as state:
        lock_a = threading.Lock()
        lock_b = threading.Lock()
        assert _wraps_a_real_lock(lock_a)

        def a_then_b():
            with lock_a:
                with lock_b:
                    pass

        def b_then_a():
            with lock_b:
                with lock_a:
                    pass

        _run_serialized(a_then_b, b_then_a)
        rep = state.report()
    assert len(rep["cycles"]) == 1
    assert all("test_torch_tsan.py" in s for s in rep["cycles"][0]["sites"])
    assert not tsan.is_clean(rep)
    assert not tsan.enabled()
    if outer is not None:
        # The JAX session saw none of the port session's locks.
        assert outer.report()["cycles"] == []


def test_tsan_clean_on_consistent_order(outer):
    with tsan.session(force=True) as state:
        lock_a = threading.Lock()
        lock_b = threading.Lock()

        def ordered():
            with lock_a:
                with lock_b:
                    pass

        _run_serialized(ordered, ordered)
        rep = state.report()
    assert rep["cycles"] == []
    assert rep["edges"] == 1
    assert tsan.is_clean(rep)


def test_tsan_unguarded_write_is_flagged_guarded_is_not(outer):
    class Owner:
        pass

    bad, good = Owner(), Owner()
    with tsan.session(force=True) as state:
        guard_lock = threading.Lock()

        def unguarded():
            tsan.note_write("fixture.table", bad)

        def guarded():
            with guard_lock:
                tsan.note_write("fixture.table", good)

        _run_serialized(unguarded, unguarded, guarded, guarded)
        rep = state.report()
    assert [w["name"] for w in rep["unguarded_writes"]] == ["fixture.table"]
    with tsan.session(force=True) as state:
        guard_lock = threading.Lock()
        owner = Owner()

        def guarded2():
            with guard_lock:
                tsan.note_write("fixture.table2", owner)

        _run_serialized(guarded2, guarded2)
        assert state.report()["unguarded_writes"] == []


def test_tsan_per_instance_write_scoping(outer):
    class Owner:
        pass

    first, second = Owner(), Owner()
    with tsan.session(force=True) as state:
        def t1():
            tsan.note_write("fixture.pool", first)

        def t2():
            tsan.note_write("fixture.pool", second)

        _run_serialized(t1, t2)
        assert state.report()["unguarded_writes"] == []


def test_tsan_recursive_lock_acquire_raises(outer):
    with tsan.session(force=True) as state:
        lock = threading.Lock()
        with lock:
            with pytest.raises(RuntimeError, match="re-acquire"):
                lock.acquire()
        rep = state.report()
    assert len(rep["recursive_acquires"]) == 1
    with tsan.session(force=True) as state:
        rlock = threading.RLock()
        assert _wraps_a_real_lock(rlock)
        with rlock:
            with rlock:
                pass
        assert state.report()["recursive_acquires"] == []


def test_tsan_uninstall_restores_real_primitives(outer):
    before = threading.Lock
    with tsan.session(force=True):
        lock = threading.Lock()
        assert type(lock).__name__ == "_SanLock"
        assert type(lock).__module__ == tsan.__name__
    assert threading.Lock is before
    assert not tsan.enabled()


def test_tsan_condition_on_rlock_wait_notify(outer):
    """Condition() with no lock allocates an RLock, wrapped, and still
    waits and notifies through the Condition protocol, at depth 2
    too."""
    with tsan.session(force=True):
        cond = threading.Condition()
        assert type(cond._lock).__name__ == "_SanRLock"
        fired = []

        def waiter():
            with cond:
                while not fired:
                    cond.wait(timeout=1)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            fired.append(1)
            cond.notify_all()
        t.join(timeout=2)
        assert not t.is_alive()
        with cond:
            with cond._lock:
                assert not cond.wait(timeout=0.05)
            assert cond._lock._is_owned()


def test_tsan_timed_reacquire_is_not_flagged(outer):
    with tsan.session(force=True) as state:
        lock = threading.Lock()
        with lock:
            assert lock.acquire(timeout=0.05) is False
        assert state.report()["recursive_acquires"] == []


def test_tsan_condition_and_queue_still_work(outer):
    with tsan.session(force=True):
        lock = threading.Lock()
        cond = threading.Condition(lock)
        fired = []

        def waiter():
            with cond:
                while not fired:
                    cond.wait(timeout=1)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            fired.append(1)
            cond.notify_all()
        t.join(timeout=2)
        assert not t.is_alive()
        q = queue_mod.Queue()
        q.put(1)
        assert q.get(timeout=1) == 1


LM = dict(vocab_size=48, embed_dim=32, num_layers=2, num_heads=4,
          max_seq_len=32)


def _stream(port, prompt, new, out):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps({"prompts": [prompt], "max_new_tokens": new,
                         "stream": True}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        out.extend(json.loads(line) for line in resp if line.strip())


def test_serving_and_checkpoint_threads_are_clean(tmp_path, monkeypatch):
    """The port's serving loop, its HTTP handler threads, a quarantine
    rebuild and the checkpoint writer thread under one session: the
    report is clean, and the registered structures were written (the
    session saw the traffic)."""
    monkeypatch.setenv("CEA_TPU_PAGED_KV", "1")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    _, tree, config = torch_parity.flax_lm_of(seed=1, **LM)
    model = torch_parity.port_lm(config, tree)
    faults.reset()
    try:
        with tsan.session(force=True) as state:
            server = GenerationServer("lm", model, port=0, host="127.0.0.1",
                                      max_new_tokens=8, max_batch=2,
                                      buckets=[8])
            server.start()
            try:
                assert server.engine.paged
                # The third step fails: the engine is quarantined,
                # rebuilt and both streams replay.
                faults.install({"step": [2]})
                outs = [[], []]
                streams = [threading.Thread(
                    target=_stream, args=(server.port, p, 6, out))
                    for p, out in zip(([1, 2, 3, 4], [5, 6, 7]), outs)]
                for t in streams:
                    t.start()
                mgr = CheckpointManager(str(tmp_path))
                payload = {"w": np.arange(16, dtype=np.float32),
                           "step": np.int32(1)}
                mgr.save(payload, step=1)
                mgr.save(payload, step=2)
                mgr.wait_until_finished(timeout=60)
                mgr.close()
                for t in streams:
                    t.join(timeout=120)
                    assert not t.is_alive()
                stats = server.stats()
            finally:
                server.stop()
            rep = state.report()
    finally:
        faults.reset()
        torch.set_num_threads(prev)
    for out in outs:
        assert out[-1] == {"done": True}
        assert sum(len(line.get("tokens", ())) for line in out) == 6
    assert stats["quarantine_episodes"] == 1
    assert stats["engine_rebuilds"] == 1
    written = {name for name, _ in state.writes}
    assert {"engine.block_pool", "engine.slot_tables", "serving.slot_work",
            "checkpoint.queue"} <= written
    assert rep["locks_created"] > 0 and rep["edges"] >= 0
    assert tsan.is_clean(rep), tsan.format_report(rep)

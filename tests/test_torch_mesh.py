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

"""The port's meshes (parallel/mesh.py) on four gloo ranks against the
JAX package's on four CPU devices, the mesh cases of
tests/test_parallel.py; and the multi-host start-up
(parallel/distributed.py) against the JAX package's on the env
contract the plugin's TpuManager composes for a two-host slice on a
fake node, as tests/test_multihost.py builds it (its _initialize seams
capture the call; nothing connects), plus the barrier's deadline on
the ranks. Exact comparisons: these are layouts and arguments."""

import jax
import numpy as np
import pytest

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.chip.pyfake import PyChipBackend
from container_engine_accelerators_tpu.parallel import build_mesh as jax_mesh
from container_engine_accelerators_tpu.parallel import (
    chips_from_env as jax_chips_from_env,
)
from container_engine_accelerators_tpu.parallel import (
    distributed as jax_distributed,
)
from container_engine_accelerators_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec,
)
from container_engine_accelerators_tpu.parallel.mesh import (
    host_grid_mesh as jax_host_grid_mesh,
)
from container_engine_accelerators_tpu.plugin.envs import (
    parse_process_bounds,
)
from container_engine_accelerators_tpu.plugin.manager import TpuManager
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.obs.metric_names import (
    TRAIN_RECOVERY,
)
from container_engine_accelerators_tpu_torch.parallel import (
    chips_from_env,
    distributed,
)
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    MeshSpec,
    build_mesh,
    default_spec,
    reshape_spec,
)
from tests import torch_dist_cases as cases
from tests.torch_dist_pool import RankPool

N = 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


def _jax_facts(data, model):
    """(shape, {device id: (coordinate, data peers, model peers)}) of
    the JAX mesh on the first N devices: the port's ranks are the
    device ids."""
    mesh = jax_mesh(JaxMeshSpec(data=data, model=model),
                    devices=jax.devices()[:N])
    grid = np.vectorize(lambda d: d.id)(mesh.devices)
    facts = {}
    for i in range(grid.shape[0]):
        for j in range(grid.shape[1]):
            facts[int(grid[i, j])] = ((i, j), sorted(grid[:, j].tolist()),
                                      sorted(grid[i, :].tolist()))
    return dict(mesh.shape), facts


def test_four_ranks(pool):
    assert pool.run(cases.world_size) == [(N, "gloo")] * N


def test_build_mesh_default_pure_dp(pool):
    for rank, (shape, coord, data, model) in enumerate(
            pool.run(cases.mesh_facts)):
        assert shape == {"data": N, "model": 1}
        assert coord == (rank, 0)
        assert data == list(range(N)) and model == [rank]


@pytest.mark.parametrize("data,model", [(2, 2), (1, 4), (4, 1)])
def test_build_mesh_dp_tp_matches_the_jax_grid(pool, data, model):
    want_shape, want = _jax_facts(data, model)
    for rank, (shape, coord, dpeers, mpeers) in enumerate(
            pool.run(cases.mesh_facts, data, model)):
        assert shape == want_shape == {"data": data, "model": model}
        assert (coord, dpeers, mpeers) == want[rank]


def test_build_mesh_oversubscribed(pool):
    assert pool.run(cases.mesh_error, 3, 3) == ["ValueError"] * N
    with pytest.raises(ValueError):
        jax_mesh(JaxMeshSpec(data=3, model=3), devices=jax.devices()[:N])


def test_build_mesh_rejects_nonpositive_factors(pool):
    for data, model in ((0, 2), (-2, 2), (2, 0), (2, -2)):
        assert pool.run(cases.mesh_error, data, model) == ["ValueError"] * N


def test_build_mesh_explicit_submesh(pool):
    """Explicit factors may use the leading ranks: a 1x3 mesh of four
    ranks; the fourth holds no coordinate, as the JAX mesh leaves the
    fourth device out."""
    got = pool.run(cases.mesh_facts, 1, 3)
    want_shape, want = _jax_facts(1, 3)
    for rank in range(3):
        shape, coord, dpeers, mpeers = got[rank]
        assert shape == want_shape == {"data": 1, "model": 3}
        assert (coord, dpeers, mpeers) == want[rank]
    assert got[3][1] is None and 3 not in want


def test_spec_helpers_match():
    from container_engine_accelerators_tpu.parallel.mesh import (
        default_spec as jax_default_spec,
        reshape_spec as jax_reshape_spec,
    )
    for n, m in ((8, 1), (8, 2), (6, 3), (8, 4)):
        assert vars(default_spec(n, m)) == vars(jax_default_spec(n, m))
    for n, m in ((6, 2), (3, 2), (5, 1), (1, 4)):
        assert vars(reshape_spec(n, m)) == vars(jax_reshape_spec(n, m))
    with pytest.raises(ValueError):
        default_spec(6, 4)
    with pytest.raises(ValueError):
        reshape_spec(0, 1)


def test_chips_from_env(monkeypatch):
    for raw, want in (("0,1,4,5", [0, 1, 4, 5]), ("", None),
                      ("a,b", None)):
        monkeypatch.setenv("TPU_VISIBLE_DEVICES", raw)
        assert chips_from_env() == jax_chips_from_env() == want
    monkeypatch.delenv("TPU_VISIBLE_DEVICES")
    assert chips_from_env() is None


def test_host_grid_mesh_from_process_bounds(pool):
    """TPU_PROCESS_BOUNDS "1,1,2" over four ranks: two hosts of two
    ranks, host-major, the layout the JAX mesh gives four devices."""
    bounds = parse_process_bounds("1,1,2")
    want = jax_host_grid_mesh(bounds, devices=jax.devices()[:N])
    grid = np.vectorize(lambda d: d.id)(want.devices)
    for rank, (shape, coord) in enumerate(pool.run(cases.host_grid,
                                                   bounds)):
        assert shape == dict(want.shape)
        assert grid[coord] == rank


# -- the plugin's env contract -> the process group -----------------------


def _host_envs(fake_node, hostnames=("host0", "host1")):
    """The Allocate env contract of each host of a two-host x four-chip
    slice (tests/test_multihost.py's _two_host_envs)."""
    for i in range(4):
        fake_node.add_chip(i)
    fake_node.set_topology("2x2x1")
    out = []
    for wid in range(len(hostnames)):
        mgr = TpuManager(dev_dir=fake_node.dev_dir,
                         state_dir=fake_node.state_dir,
                         backend=PyChipBackend(), worker_id=wid,
                         worker_hostnames=hostnames)
        mgr.start()
        out.append(mgr.allocate_envs([f"accel{i}" for i in range(4)]))
    return out


def _both(monkeypatch, envs, **kwargs):
    """(port call kwargs, JAX call kwargs) of one host's start-up from
    ``envs``."""
    for key, value in envs.items():
        monkeypatch.setenv(key, value)
    port, jax_calls = [], []
    assert distributed.initialize_from_plugin_env(
        device="cpu", _initialize=lambda **kw: port.append(kw),
        **kwargs) is True
    assert jax_distributed.initialize_from_plugin_env(
        _initialize=lambda **kw: jax_calls.append(kw), **kwargs) is True
    return port[0], jax_calls[0]


def test_env_contract_two_hosts_starts_each_rank(fake_node, monkeypatch):
    for name in ("CEA_COORDINATOR_ADDRESS", "CEA_COORDINATOR_PORT"):
        monkeypatch.delenv(name, raising=False)
    for wid, envs in enumerate(_host_envs(fake_node)):
        assert envs["TPU_WORKER_ID"] == str(wid)
        port, want = _both(monkeypatch, envs)
        assert port["backend"] == "gloo"
        assert port["init_method"] == "tcp://" + want["coordinator_address"]
        assert want["coordinator_address"] == "host0:8476"
        assert port["world_size"] == want["num_processes"] == 2
        assert port["rank"] == want["process_id"] == wid
        assert port["timeout"].total_seconds() == \
            want["initialization_timeout"] == 60
        assert chips_from_env() == jax_chips_from_env() == [0, 1, 2, 3]


def test_env_contract_coordinator_overrides(fake_node, monkeypatch):
    envs = _host_envs(fake_node)[1]
    monkeypatch.setenv("CEA_COORDINATOR_PORT", "9911")
    port, want = _both(monkeypatch, envs)
    assert port["init_method"] == "tcp://host0:9911"
    assert want["coordinator_address"] == "host0:9911"
    monkeypatch.setenv("CEA_COORDINATOR_ADDRESS", "coord.svc:1234")
    port, want = _both(monkeypatch, envs)
    assert port["init_method"] == "tcp://coord.svc:1234"
    assert want["coordinator_address"] == "coord.svc:1234"
    port, want = _both(monkeypatch, envs, timeout_ms=5000)
    assert port["timeout"].total_seconds() == 5
    assert want["initialization_timeout"] == 5


def test_env_contract_refuses_a_bad_worker_id(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host0,host1")
    monkeypatch.delenv("TPU_WORKER_ID", raising=False)
    for fn in (distributed.initialize_from_plugin_env,
               jax_distributed.initialize_from_plugin_env):
        with pytest.raises(ValueError, match="TPU_WORKER_ID"):
            fn(_initialize=lambda **kw: None)
    monkeypatch.setenv("TPU_WORKER_ID", "2")
    for fn in (distributed.initialize_from_plugin_env,
               jax_distributed.initialize_from_plugin_env):
        with pytest.raises(ValueError, match="out of range"):
            fn(_initialize=lambda **kw: None)


def test_bounded_retries_then_deadline(monkeypatch):
    """Every failed attempt but the last sleeps the doubling backoff
    and counts a coordinator_retry; the last raises DeadlineExceeded
    and counts a coordinator_timeout, in both packages."""
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "host0,host1")
    monkeypatch.setenv("TPU_WORKER_ID", "1")
    monkeypatch.setenv("CEA_TPU_COORD_RETRIES", "2")
    monkeypatch.setenv("CEA_TPU_COORD_BACKOFF_MS", "1")
    results = {}
    for label, module, tracer_mod in (("port", distributed, obs),
                                      ("jax", jax_distributed, jax_obs)):
        tracer = tracer_mod.Tracer(enabled=True)
        monkeypatch.setattr(tracer_mod, "TRACER", tracer)
        attempts = []

        def fail(**kwargs):
            attempts.append(kwargs)
            raise ConnectionError("coordinator unreachable")

        with pytest.raises(module.DeadlineExceeded,
                           match="3 attempt") as err:
            module.initialize_from_plugin_env(_initialize=fail)
        assert isinstance(err.value, TimeoutError)
        counters = {labels: v for (name, labels), v
                    in tracer.counters().items()
                    if name == TRAIN_RECOVERY}
        results[label] = (len(attempts), counters)
    assert results["port"] == results["jax"]
    assert results["port"][0] == 3
    assert results["port"][1] == {(("reason", "coordinator_retry"),): 2,
                                  (("reason", "coordinator_timeout"),): 1}


def test_a_collective_may_wait_past_the_rendezvous_deadline():
    """CEA_TPU_COORD_TIMEOUT_MS bounds the start-up only, as the JAX
    module's initialization_timeout: two hosts assemble within a 1 s
    deadline, then one comes 2.5 s late to an all-reduce, which still
    completes on both."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = str(distributed.free_local_port())
    conns, procs = [], []
    for rank in range(2):
        parent, child = ctx.Pipe()
        proc = ctx.Process(target=cases.late_collective,
                           args=(rank, port, child), daemon=True)
        proc.start()
        conns.append(parent)
        procs.append(proc)
    try:
        out = [conn.recv() if conn.poll(120) else ("error", "no answer")
               for conn in conns]
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    assert out == [("ok", [3.0, 3.0])] * 2


def test_barrier_and_shutdown_without_a_group():
    assert distributed.barrier("solo") is False
    assert distributed.shutdown() is False


def test_barrier_assembles_and_times_out(pool):
    assert pool.run(cases.barrier_all, "b1") == [True] * N
    assert pool.run(cases.barrier_all, "b1") == [True] * N
    out = pool.run(cases.barrier_missing_peer, "lonely")
    assert "did not assemble" in out[0]
    assert out[1:] == [None] * (N - 1)

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

"""The port's elastic training (parallel/elastic.py, the shard helpers
of parallel/data.py, Trainer.remesh and state_shardings, the resharded
restore) and its DCN-granule mesh (mesh.build_hybrid_mesh, the
driver's --dcn-granules) against the JAX package: the cases of
tests/test_elastic.py that concern them (the eviction policy and its
env knobs, down hosts from health events, the supervisor's one event
per failure, the 1-D fallback, the recovery accounting and its offline
replay, shard assignment and reassignment, the resharded restore
across mesh shapes, the in-process rebuild against the uninterrupted
run, the rebuild before the first checkpoint), each run through both
packages on the same inputs; and tests/test_parallel.py's hybrid-mesh
cases (layout, errors, training). The multi-rank cases run on four
gloo ranks, the JAX side on a CPU submesh of the same layout. Models
are f32; tolerances are stated at each assertion."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from container_engine_accelerators_tpu import obs as jax_obs
from container_engine_accelerators_tpu.models import MnistMLP as JaxMLP
from container_engine_accelerators_tpu.models import mlp as jax_mlp
from container_engine_accelerators_tpu.obs.efficiency import (
    GoodputLedger as JaxLedger,
)
from container_engine_accelerators_tpu.parallel import (
    CheckpointManager as JaxCheckpointManager,
)
from container_engine_accelerators_tpu.parallel import MeshSpec as JaxSpec
from container_engine_accelerators_tpu.parallel import Trainer as JaxTrainer
from container_engine_accelerators_tpu.parallel import (
    batch_sharding as jax_batch_sharding,
)
from container_engine_accelerators_tpu.parallel import build_mesh as jax_mesh
from container_engine_accelerators_tpu.parallel import data as jax_data
from container_engine_accelerators_tpu.parallel import elastic as jax_el
from container_engine_accelerators_tpu.parallel import (
    state_payload as jax_state_payload,
)
from container_engine_accelerators_tpu.parallel.mesh import (
    build_hybrid_mesh as jax_hybrid,
)
from container_engine_accelerators_tpu.parallel.train import (
    cross_entropy_loss as jax_xent,
)
from container_engine_accelerators_tpu_torch import obs
from container_engine_accelerators_tpu_torch.obs.efficiency import (
    GoodputLedger,
    ledger_from_snapshot,
)
from container_engine_accelerators_tpu_torch.parallel import (
    EvictionPolicy,
    FleetExhausted,
    MeshSpec,
    build_hybrid_mesh,
    reassign_shards,
    shard_assignment,
)
from container_engine_accelerators_tpu_torch.parallel import elastic
from tests import torch_dist_cases as cases
from tests.torch_dist_pool import RankPool

N = 4
HIDDEN = 512   # wide enough for the model axis to shard the kernels


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


# -- the policy, the events, the supervisor's books --------------------------

POLICY_ROUNDS = [
    ((1.5, 3, 5), [{"skews": {"h1": 2.0}}] * 3 + [
        {"skews": {"h1": 1.0}}, {"skews": {"h1": 2.0}}]),
    ((2.0, 3, 5), [{"down": ["h2"]}, {"stale": {"h3": 6.0, "h4": 1.0}}]),
    ((2.0, 1, 5), [{"skews": {"h0": 3.0, "h1": 1.0}, "down": ["h0"]},
                   {"stale": {"h1": 9.0}, "skews": {"h1": 5.0}}]),
]


@pytest.mark.parametrize("knobs,rounds", POLICY_ROUNDS)
def test_policy_rounds_match_jax(knobs, rounds):
    """The verdicts of each round, the port's against JAX's: a skew
    needs consecutive breached windows and a recovery resets the count;
    down and stale hosts are immediate; health outranks staleness and
    skew for one host."""
    mine = EvictionPolicy(*knobs)
    theirs = jax_el.EvictionPolicy(*knobs)
    got = [mine.evaluate(**r) for r in rounds]
    assert got == [theirs.evaluate(**r) for r in rounds]
    if knobs == (1.5, 3, 5):
        assert got == [[], [], [("h1", "straggler")], [], []]


def test_policy_env_knobs(monkeypatch):
    monkeypatch.setenv("CEA_TPU_EVICT_SKEW", "3.5")
    monkeypatch.setenv("CEA_TPU_EVICT_WINDOWS", "1")
    monkeypatch.setenv("CEA_TPU_EVICT_STALE_S", "2")
    policy = EvictionPolicy()
    assert (policy.skew_factor, policy.skew_windows,
            policy.stale_after_s) == (3.5, 1, 2.0)
    assert policy.evaluate(skews={"h0": 4.0}) == [("h0", "straggler")]
    monkeypatch.setenv("CEA_TPU_EVICT_WINDOWS", "junk")
    assert EvictionPolicy().skew_windows == (
        jax_el.EvictionPolicy().skew_windows)
    for bad in ({"skew_factor": 1.0}, {"skew_windows": 0}):
        with pytest.raises(ValueError) as want:
            jax_el.EvictionPolicy(**bad)
        with pytest.raises(ValueError) as got:
            EvictionPolicy(**bad)
        assert str(got.value) == str(want.value)


HEALTH = [
    ([{"name": "health.transition", "unix": 1.0,
       "fields": {"device": "accel0", "to": "Unhealthy"}},
      {"name": "health.transition", "unix": 2.0,
       "fields": {"device": "accel1", "to": "Unhealthy"}},
      {"name": "health.transition", "unix": 3.0,
       "fields": {"device": "accel0", "to": "Healthy"}},
      {"name": "other.event", "unix": 4.0, "fields": {}}],
     {"accel0": "h0", "accel1": "h1"}, ["h1"]),
    ([{"name": "health.transition", "unix": 1.0,
       "fields": {"device": "accel2", "to": "Unhealthy"}},
      {"name": "health.transition", "unix": 2.0,
       "fields": {"device": "accel3", "to": "Unhealthy"}},
      {"name": "health.transition", "unix": 3.0,
       "fields": {"device": "accel3", "to": "Healthy"}}],
     {"accel2": "h1", "accel3": "h1"}, ["h1"]),
]


@pytest.mark.parametrize("events,mapping,want", HEALTH)
def test_down_hosts_from_events_matches_jax(events, mapping, want):
    """The last transition of a device wins, and a sibling recovering
    does not mask a host still down."""
    got = elastic.down_hosts_from_events(events, mapping)
    assert got == want == jax_el.down_hosts_from_events(events, mapping)


def _events(tracer, name):
    return [e for e in tracer.snapshot()["events"] if e["name"] == name]


def _story(mod, tracer_cls, spec_cls):
    """tests/test_elastic.py's one-event-per-failure story through
    ``mod``'s supervisor; returns what it observed."""
    tracer = tracer_cls(enabled=True)
    sup = mod.ElasticSupervisor(
        hosts=["h0", "h1", "h2", "h3"], chips_per_host=2, model_parallel=2,
        policy=mod.EvictionPolicy(skew_factor=1.5, skew_windows=2,
                                  stale_after_s=5),
        tracer=tracer)
    seen = {"spec": sup.mesh_spec == spec_cls(data=4, model=2)}
    seen["first"] = sup.observe(skews={"h2": 2.0})
    plan = sup.observe(skews={"h2": 2.0})
    seen["plan"] = (plan.evicted, plan.survivors,
                    (plan.mesh_spec.data, plan.mesh_spec.model),
                    plan.worker_ids, plan.assignment)
    seen["inert"] = (sup.observe(skews={"h2": 9.9}),
                     sup.observe(down=["h2"]))
    ev = _events(tracer, mod.EVICTION_EVENT)
    re = _events(tracer, mod.RESHAPE_EVENT)
    seen["events"] = ([e["fields"] for e in ev], [e["fields"] for e in re])
    seen["counter"] = tracer.counters()[
        (mod.RECOVERY_COUNTER, (("reason", "straggler"),))]
    plan2 = sup.observe(down=["h0"])
    seen["plan2"] = (plan2.evicted,
                     (plan2.mesh_spec.data, plan2.mesh_spec.model))
    seen["counts"] = (len(_events(tracer, mod.EVICTION_EVENT)),
                      len(_events(tracer, mod.RESHAPE_EVENT)))
    with pytest.raises(mod.FleetExhausted) as e:
        sup.evict([("h1", "health_down"), ("h3", "health_down")])
    seen["exhausted"] = str(e.value)
    seen["evicted"] = sup.evicted()
    return seen


def test_supervisor_exactly_one_event_per_failure():
    """One noisy window evicts nobody; the second evicts h2 (one
    train.eviction, one train.reshape 4x2 -> 3x2, one recovery count);
    a signal that keeps firing is inert; a second failure adds one pair;
    exhausting the fleet raises. Field for field as JAX's."""
    mine = _story(elastic, obs.Tracer, MeshSpec)
    theirs = _story(jax_el, jax_obs.Tracer, JaxSpec)
    assert mine == theirs
    assert mine["first"] is None and mine["spec"]
    evicted, survivors, shape, ids, assignment = mine["plan"]
    assert evicted == [("h2", "straggler")]
    assert survivors == ["h0", "h1", "h3"] and shape == (3, 2)
    assert ids == {"h0": 0, "h1": 1, "h3": 2}
    assert sorted(s for ss in assignment.values() for s in ss) == [0, 1,
                                                                   2, 3]
    assert mine["events"][1][0]["old_shape"] == "4x2"
    assert mine["events"][1][0]["new_shape"] == "3x2"
    assert mine["counter"] == 1 and mine["counts"] == (2, 2)
    assert issubclass(FleetExhausted, RuntimeError)


def test_supervisor_model_axis_fallback_to_1d():
    for mod in (elastic, jax_el):
        sup = mod.ElasticSupervisor(hosts=["h0", "h1", "h2"],
                                    chips_per_host=1, model_parallel=3,
                                    tracer=obs.Tracer(enabled=False))
        assert (sup.mesh_spec.data, sup.mesh_spec.model) == (1, 3)
        plan = sup.evict([("h1", "health_down")])
        assert (plan.mesh_spec.data, plan.mesh_spec.model) == (2, 1)


def test_supervisor_recovery_accounting():
    """complete_recovery puts the seconds into the ledger's restart
    bucket and on a train.recovered event, which the offline replay
    attributes the same way (both packages' ledgers and replays)."""
    results = []
    for mod, tracer_cls, ledger_cls in (
            (elastic, obs.Tracer, GoodputLedger),
            (jax_el, jax_obs.Tracer, JaxLedger)):
        tracer = tracer_cls(enabled=True)
        ledger = ledger_cls()
        ledger.set_wall(10.0)
        sup = mod.ElasticSupervisor(hosts=["h0", "h1"], goodput=ledger,
                                    tracer=tracer)
        plan = sup.evict([("h1", "health_down")])
        sup.complete_recovery(plan, 1.25, resume_step=40)
        assert plan.resume_step == 40
        assert ledger.summary()["buckets"]["restart"] == pytest.approx(
            1.25, abs=1e-6)
        (event,) = _events(tracer, "train.recovered")
        results.append(event["fields"])
    assert results[0] == results[1]
    assert results[0]["recovery_s"] == pytest.approx(1.25)
    snap = {"spans": [{"name": "train.step_run", "start_unix": 100.0,
                       "duration_s": 8.0}],
            "events": [{"name": "train.recovered", "unix": 109.25,
                        "fields": dict(results[0])}]}
    replayed = ledger_from_snapshot(snap).summary()
    assert replayed["buckets"]["restart"] == pytest.approx(1.25, rel=1e-3)
    assert replayed["buckets"]["productive"] == pytest.approx(8.0,
                                                              rel=1e-3)


@pytest.mark.parametrize("shards,hosts,departed", [
    (8, ["h0", "h1", "h2", "h3"], ["h2"]),
    (5, ["h0", "h1"], ["h1"]),
    (7, ["h0", "h1", "h2"], ["h0", "h2"]),
])
def test_shard_assignment_and_reassign_match_jax(shards, hosts, departed):
    """Contiguous blocks with the remainder up front; survivors keep
    their shards in order and the orphans spread least-loaded first,
    within one shard of each other; the same as JAX's, and the same
    errors."""
    assignment = shard_assignment(shards, hosts)
    assert assignment == jax_data.shard_assignment(shards, hosts)
    after = reassign_shards(assignment, departed)
    assert after == jax_data.reassign_shards(assignment, departed)
    for host, own in assignment.items():
        if host not in departed:
            assert after[host][:len(own)] == own
    assert sorted(s for ss in after.values() for s in ss) == list(
        range(shards))
    sizes = sorted(len(s) for s in after.values())
    assert sizes[-1] - sizes[0] <= 1
    for fn, args in ((reassign_shards, (assignment, hosts)),
                     (shard_assignment, (len(hosts) - 1, hosts)),
                     (shard_assignment, (3, []))):
        jax_fn = getattr(jax_data, fn.__name__)
        with pytest.raises(ValueError) as want:
            jax_fn(*args)
        with pytest.raises(ValueError) as got:
            fn(*args)
        assert str(got.value) == str(want.value)


# -- resharded restore and the in-process rebuild -----------------------------


def test_manager_restore_lays_leaves_out(tmp_path):
    """CheckpointManager.restore(shardings=) hands each whole leaf to its
    callable (None keeps it whole), as the JAX manager places each leaf
    with its NamedSharding."""
    from container_engine_accelerators_tpu_torch.parallel import (
        CheckpointManager,
    )
    mgr = CheckpointManager(tmp_path)
    tree = {"w": np.arange(8, dtype=np.float32).reshape(4, 2),
            "b": np.ones(3, np.float32)}
    mgr.save(tree, step=1, blocking=True)
    got = mgr.restore(tree, shardings={"w": lambda a: a[2:], "b": None})
    np.testing.assert_array_equal(got["w"], tree["w"][2:])
    np.testing.assert_array_equal(got["b"], tree["b"])


def test_resharded_restore_across_meshes(pool, tmp_path):
    """Saved under a 2 x 2 (data, model) mesh, restored through
    restore_state(shardings=) onto 1 x 2 (ranks 0-1) and 4 x 1:
    parameter- and momentum-exact once made whole, the sharded kernels
    in the restoring mesh's layout (half the out-features on a model
    axis of 2, whole on 4 x 1), at the saved step, and a step trains
    on."""
    tree = cases.init_tree("mlp", hidden=HIDDEN)
    out = pool.run(cases.elastic_restore, tree, HIDDEN, str(tmp_path),
                   [(1, 2), (4, 1)])
    saved_params, saved_moms = out[0]["saved"]
    for rank, result in enumerate(out):
        for target, (data, model) in zip(result["targets"],
                                         [(1, 2), (4, 1)]):
            if data * model <= rank:
                assert target is None
                continue
            params, moms = target["whole"]
            for name in saved_params:
                np.testing.assert_array_equal(params[name],
                                              saved_params[name], name)
                np.testing.assert_array_equal(moms[name], saved_moms[name],
                                              name)
            assert target["step"] == 2
            assert target["shapes"]["Dense_0.weight"] == (
                (HIDDEN // model, 784))
            assert np.isfinite(target["loss"])


def _jax_trainer(tree, data, model, devices):
    mesh = jax_mesh(JaxSpec(data=data, model=model), devices=devices)
    net = JaxMLP(hidden=HIDDEN, dtype=jnp.float32)
    trainer = JaxTrainer(jax_mlp.make_apply_fn(net), jax_xent,
                         optax.sgd(0.1, momentum=0.9), mesh=mesh)
    return trainer, mesh


def _jax_batch(step, mesh):
    images, labels = jax_data.synthetic_step_batch(step, 24, (28, 28, 1),
                                                   10, seed=7)
    sh = jax_batch_sharding(mesh)
    return jax.device_put(images, sh), jax.device_put(labels, sh)


def _jax_rebuild(tree, hosts, model, evict, directory, checkpoint=True):
    """The JAX side of cases.elastic_rebuild on a submesh of N devices
    laid out as the ranks."""
    devices = jax.devices()[:N]
    per = N // len(hosts)
    variables = jax.tree_util.tree_map(jnp.asarray, tree)
    trainer, mesh = _jax_trainer(tree, N // model, model, devices)
    state = trainer.init_state(variables)
    mgr = JaxCheckpointManager(directory, goodput=trainer.goodput)
    first, ref = [], []
    for step in range(3):
        state, loss = trainer.train_step(state, _jax_batch(step, mesh))
        first.append(float(loss))
    if checkpoint:
        mgr.save(jax_state_payload(state), step=int(state.step))
    for step in range(3, 6):
        state, loss = trainer.train_step(state, _jax_batch(step, mesh))
        ref.append(float(loss))
    sup = jax_el.ElasticSupervisor(
        hosts=hosts, chips_per_host=per, model_parallel=model,
        goodput=trainer.goodput, tracer=jax_obs.Tracer(enabled=False),
        host_devices={h: devices[i * per:(i + 1) * per]
                      for i, h in enumerate(hosts)})
    plan = sup.observe(down=[evict])
    mgr.wait_until_finished()
    new_trainer, new_state, new_mesh = sup.rebuild(
        plan, trainer, mgr, init_state=lambda t: t.init_state(variables))
    losses = []
    for step in range(int(new_state.step), int(new_state.step) + 3):
        new_state, loss = new_trainer.train_step(new_state,
                                                 _jax_batch(step, new_mesh))
        losses.append(float(loss))
    return first, ref, losses, dict(new_mesh.shape)


@pytest.mark.parametrize("hosts,model,evict,shape", [
    (["h0", "h1"], 2, "h1", {"data": 1, "model": 2}),
    (["h0", "h1", "h2", "h3"], 1, "h3", {"data": 3, "model": 1}),
])
def test_rebuild_matches_uninterrupted(pool, tmp_path, hosts, model, evict,
                                       shape):
    """Train 3 steps, checkpoint, 3 more uninterrupted; evict a host and
    rebuild on every rank (2 hosts x 2 ranks: 2 x 2 -> 1 x 2; 4 hosts x
    1: 4 x 1 -> 3 x 1): the survivors resume at step 3 and land on the
    uninterrupted run's losses (rtol 1e-5: the same global batches,
    another reduction order), as the JAX Trainer does on the same
    submesh layouts (rtol 1e-4 between the packages); the departed
    ranks build the mesh with the survivors and hold no coordinate; the
    recovery lands in the carried-over ledger's restart bucket."""
    tree = cases.init_tree("mlp", hidden=HIDDEN)
    out = pool.run(cases.elastic_rebuild, tree, HIDDEN,
                   str(tmp_path / "port"), hosts, model, evict)
    per = N // len(hosts)
    departed = range(hosts.index(evict) * per, (hosts.index(evict) + 1) * per)
    jfirst, jref, jlosses, jshape = _jax_rebuild(
        tree, hosts, model, evict, str(tmp_path / "jax"))
    assert jshape == shape
    for rank, r in enumerate(out):
        assert r["mesh"] == shape
        assert r["survivors"] == [h for h in hosts if h != evict]
        if rank in departed:
            assert r["losses"] is None
            continue
        assert r["resume_step"] == 3 and r["state_step"] == 3
        np.testing.assert_allclose(r["losses"], r["ref"], rtol=1e-5)
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)
        np.testing.assert_allclose(r["ref"], jref, rtol=1e-4)
        assert r["restart_s"] > 0 and r["same_ledger"]


def test_rebuild_before_first_checkpoint(pool, tmp_path):
    """An eviction before any checkpoint has landed resumes from the
    init template at step 0 instead of failing: the survivors' first
    steps repeat the full fleet's (rtol 1e-5), as JAX's do."""
    tree = cases.init_tree("mlp", hidden=HIDDEN)
    hosts = ["h0", "h1", "h2", "h3"]
    out = pool.run(cases.elastic_rebuild, tree, HIDDEN, str(tmp_path),
                   hosts, 1, "h1", checkpoint=False)
    jfirst, _, jlosses, _ = _jax_rebuild(tree, hosts, 1, "h1",
                                         str(tmp_path / "jax"),
                                         checkpoint=False)
    for rank, r in enumerate(out):
        if rank == 1:
            assert r["losses"] is None
            continue
        assert r["resume_step"] == 0 and r["state_step"] == 0
        np.testing.assert_allclose(r["losses"], r["first"], rtol=1e-5)
        np.testing.assert_allclose(r["losses"], jlosses, rtol=1e-4)


# -- DCN granules ------------------------------------------------------------


def test_hybrid_mesh_layout_matches_jax(pool):
    """build_hybrid_mesh(model=2, num_granules=2) over the four ranks:
    model groups never cross a granule, the data axis is granule-major,
    the grid the JAX function lays out over four devices (rank i for
    device i)."""
    got = pool.run(cases.hybrid_mesh, 2, 2)
    want = jax_hybrid(model=2, num_granules=2, devices=jax.devices()[:4])
    grid = [[d.id for d in row] for row in want.devices]
    assert got == [({"data": 2, "model": 2}, grid)] * N
    assert grid == [[0, 1], [2, 3]]
    got = pool.run(cases.hybrid_mesh, 1, 4)
    assert got[0][0] == {"data": 4, "model": 1}


@pytest.mark.parametrize("kwargs", [
    dict(model=2), dict(model=8, num_granules=2),
    dict(model=1, num_granules=3), dict(model=4, num_granules=2)])
def test_hybrid_mesh_errors_match_jax(kwargs):
    """No split given, a model axis wider than a granule, granules that
    do not divide the devices: JAX's errors, letter for letter (no
    process group needed: they come before the mesh)."""
    with pytest.raises(ValueError) as want:
        jax_hybrid(devices=jax.devices()[:4], **kwargs)
    with pytest.raises(ValueError) as got:
        build_hybrid_mesh(devices=list(range(4)), **kwargs)
    assert str(got.value) == str(want.value)


def test_hybrid_mesh_host_granules():
    """``hosts`` groups ranks by granule key when it tells them apart
    (host order, then rank order inside a host), and a count that
    disagrees is refused; one key for all falls back to num_granules."""
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        _granules,
    )
    assert _granules([0, 1, 2, 3], None, ["b", "a", "b", "a"]) == [
        [1, 3], [0, 2]]
    with pytest.raises(ValueError, match="found 2 host granules, "
                                         "expected 4"):
        _granules([0, 1, 2, 3], 4, ["b", "a", "b", "a"])
    assert _granules([0, 1, 2, 3], 2, ["x"] * 4) == [[0, 1], [2, 3]]


def test_driver_dcn_granules_trains(pool):
    """--dcn-granules 2 --model-parallelism 2 on four ranks trains on a
    2 x 2 hybrid mesh, with the losses of the same flags without
    granules (that layout is the same grid)."""
    base = ["--device", "cpu", "--model", "mnist", "--batch-size", "16",
            "--steps", "3", "--warmup-steps", "1", "--model-parallelism",
            "2"]
    dcn = pool.run(cases.pipe_driver, base + ["--dcn-granules", "2"])
    plain = pool.run(cases.pipe_driver, base)
    assert dcn[0]["result"]["mesh"] == {"data": 2, "model": 2}
    assert all(np.isfinite(r["losses"]).all() for r in dcn)
    assert dcn[0]["losses"] == plain[0]["losses"]

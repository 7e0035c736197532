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

"""The port's multichip dryrun (parallel/dryrun.py) on four gloo ranks
against the JAX dryrun's stages (``__graft_entry__._dryrun_body``),
each built here from the JAX package's functions as that body builds
it, on a 4-device CPU submesh, with the same init and batch: stage 1
(ResNet-50 on 2 x 2), 1b (FSDP on 4 x 1), 2 (the MoE LM on the (1, 2,
2) ("data", "context", "expert") mesh, and its gradients, the clip's
norm and the router's aux term alone), 3 (the GPipe toy and the
circular PipelinedLM on 2 x 2) and 4 (the 2 x 2 x 1 host grid); then
``dryrun_multichip(4, device="cpu")`` end to end, the mesh helper, the
token layout of the routed layers, and the flag rules. Losses to rtol
1e-5, parameters and gradients to rtol 1e-4 / atol 1e-6 (the
tolerances of the context and expert steps in test_torch_context.py
and test_torch_expert.py). The (2, 2, 2) mesh runs in
tests/test_torch_dryrun_wide.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from container_engine_accelerators_tpu.models import (
    MoETransformerLM as JaxMoE,
)
from container_engine_accelerators_tpu.models import moe as jax_moe
from container_engine_accelerators_tpu.models import resnet as jax_resnet
from container_engine_accelerators_tpu.models.resnet import (
    make_apply_fn as jax_resnet_apply,
)
from container_engine_accelerators_tpu.models.transformer import (
    next_token_loss_fn as jax_next_token,
)
from container_engine_accelerators_tpu.parallel import (
    HOST_AXES,
    MeshSpec,
    PipelinedLM as JaxPipelinedLM,
    Trainer as JaxTrainer,
    batch_sharding,
    build_mesh,
    build_pipeline_mesh,
    host_grid_mesh,
    pipeline_apply,
    ring_attention,
    stack_stage_params,
    stage_sharding,
)
from container_engine_accelerators_tpu.parallel.context import (
    CONTEXT_AXIS,
)
from container_engine_accelerators_tpu.parallel.data import (
    SyntheticLoader,
    SyntheticTokenLoader,
)
from container_engine_accelerators_tpu.parallel.expert import EXPERT_AXIS
from container_engine_accelerators_tpu.parallel.mesh import DATA_AXIS
from container_engine_accelerators_tpu.parallel.train import (
    cross_entropy_loss as jax_xent,
)
from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.parallel import dryrun
from container_engine_accelerators_tpu_torch.parallel import expert
from tests import torch_dist_cases as cases
from tests import torch_drivers
from tests.torch_dist_pool import RankPool

N = 4
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_close(got, want, **tol):
    got, want = dict(torch_drivers.flat(got)), dict(torch_drivers.flat(want))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for name, value in want.items():
        np.testing.assert_allclose(got[name], value, err_msg=name,
                                   **(tol or PARAM_TOL))


# -- the JAX stages, as _dryrun_body builds them ----------------------------


def jax_stage1(n, fsdp=False):
    """(variables, batch, loss, variables after the step) of the JAX
    dryrun's stage 1 (1b with ``fsdp``) on the first ``n`` devices."""
    devices = jax.devices()[:n]
    if fsdp:
        mesh = build_mesh(MeshSpec(data=n, model=1), devices=devices)
    else:
        model_par = 2 if n % 2 == 0 else 1
        mesh = build_mesh(MeshSpec(data=n // model_par, model=model_par),
                          devices=devices)
    model = jax_resnet(depth=50, num_classes=16, dtype=jnp.float32,
                       width=16)
    trainer = JaxTrainer(jax_resnet_apply(model), jax_xent,
                         optax.sgd(0.1, momentum=0.9), mesh=mesh, fsdp=fsdp)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, 32, 3)), train=False)
    init = _np(variables)
    state = trainer.init_state(variables)
    loader = SyntheticLoader(2 * n, (32, 32, 3), 16,
                             sharding=batch_sharding(mesh), pool=1)
    batch = next(loader)
    state, loss = trainer.train_step(state, batch)
    assert int(state.step) == 1
    return (init, _np(batch), float(loss),
            {"params": _np(state.params),
             "batch_stats": _np(state.batch_stats)})


def jax_combined_mesh(d, c, e):
    devices = jax.devices()[:d * c * e]
    return Mesh(np.array(devices).reshape(d, c, e),
                (DATA_AXIS, CONTEXT_AXIS, EXPERT_AXIS))


def jax_moe_lm(mesh3):
    attn = functools.partial(ring_attention, mesh3, axis_name=CONTEXT_AXIS,
                             batch_axis=DATA_AXIS)
    return JaxMoE(vocab_size=32, embed_dim=32, num_layers=2, num_heads=4,
                  num_experts=4, max_seq_len=16, dtype=jnp.float32,
                  attention_fn=attn, mesh=mesh3)


def jax_stage2(d, c, e):
    """(params, tokens, loss, params after the step) of the JAX dryrun's
    stage 2 on a (d, c, e) mesh."""
    mesh3 = jax_combined_mesh(d, c, e)
    lm = jax_moe_lm(mesh3)
    trainer = JaxTrainer(
        jax_moe.make_apply_fn(lm),
        jax_moe.with_router_loss(jax_next_token(jax_xent)),
        optax.adam(1e-3), mesh=mesh3)
    tokens0 = jnp.zeros((4 * d, 16), jnp.int32)
    lm_vars = lm.init(jax.random.PRNGKey(1), tokens0)
    init = _np(lm_vars["params"])
    state = trainer.init_state(lm_vars)
    assert state.params["block1"]["moe"]["w_in"].sharding.spec[0] == (
        EXPERT_AXIS)
    loader = SyntheticTokenLoader(4 * d, 16, 32,
                                  sharding=batch_sharding(mesh3), pool=1)
    batch = next(loader)
    state, loss = trainer.train_step(state, batch)
    assert int(state.step) == 1
    return init, np.asarray(batch[0]), float(loss), _np(state.params)


def jax_stage2_grads(d, c, e, params, tokens, aux_only=False):
    """(loss, gradients, global norm) of the stage-2 objective (or 0.01
    aux alone) by jax.grad on the (d, c, e) mesh."""
    mesh3 = jax_combined_mesh(d, c, e)
    lm = jax_moe_lm(mesh3)
    objective = jax_moe.with_router_loss(jax_next_token(jax_xent))

    def loss_fn(p, t):
        out = lm.apply({"params": p}, t)
        return 0.01 * out[1] if aux_only else objective(out, t)

    t = jax.device_put(jnp.asarray(tokens),
                       NamedSharding(mesh3, P(DATA_AXIS)))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params), t)
    return float(loss), _np(grads), float(optax.global_norm(grads))


def jax_stage3(n):
    """The JAX dryrun's stage 3: its inputs, the toy's loss and stacked
    params after the step, the PipelinedLM's init, tokens, loss and
    params after the step."""
    devices = jax.devices()[:n]
    d_par = 2 if n % 4 == 0 else 1
    stages = n // d_par
    pmesh = build_pipeline_mesh(stages, data=d_par, devices=devices)
    dim = 8
    ks = jax.random.split(jax.random.PRNGKey(2), stages)
    params = stack_stage_params([
        {"w": jax.random.normal(k, (dim, dim)) * 0.5,
         "b": jnp.zeros((dim,))} for k in ks])
    toy = _np(params)
    params = jax.device_put(params, stage_sharding(pmesh, params))
    b_shard = NamedSharding(pmesh, P(DATA_AXIS))
    x = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(3), (4 * d_par, dim)), b_shard)
    y = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(4), (4 * d_par, dim)), b_shard)

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    @jax.jit
    def pipe_step(params, x, y):
        def loss_fn(params):
            out = pipeline_apply(pmesh, stage_fn, params, x,
                                 num_microbatches=2)
            return jnp.mean((out - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params = jax.tree_util.tree_map(lambda p, g: p - 0.1 * g, params,
                                        grads)
        return params, loss

    params, ploss = pipe_step(params, x, y)
    plm = JaxPipelinedLM(vocab_size=32, embed_dim=16,
                         num_layers=2 * stages, num_heads=4, max_seq_len=16,
                         pipe=stages, dtype=jnp.float32)
    plm_params = plm.init(jax.random.PRNGKey(7))
    lm_init = _np(plm_params)
    plm_params = jax.device_put(plm_params, plm.shardings(pmesh, plm_params))
    ptokens = jax.device_put(
        jax.random.randint(jax.random.PRNGKey(8), (4 * d_par, 12), 0, 32),
        NamedSharding(pmesh, P(DATA_AXIS)))

    @jax.jit
    def plm_step(params, tokens):
        def loss_fn(params):
            logits = plm.apply(params, tokens, mesh=pmesh,
                               num_microbatches=2)
            logp = jax.nn.log_softmax(logits[:, :-1])
            return -jnp.mean(jnp.take_along_axis(
                logp, tokens[:, 1:, None], axis=-1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params = jax.tree_util.tree_map(lambda p, g: p - 0.01 * g, params,
                                        grads)
        return params, loss

    plm_params, plm_loss = plm_step(plm_params, ptokens)
    inputs = dict(toy=toy, x=np.asarray(x), y=np.asarray(y),
                  lm_params=lm_init, tokens=np.asarray(ptokens))
    return (inputs, float(ploss), _np(params), float(plm_loss),
            _np(plm_params))


def jax_stage4(n):
    """The JAX dryrun's stage 4: (x, y, loss, w after the step)."""
    gmesh = host_grid_mesh((2, 2, 1), devices=jax.devices()[:n])
    batch_axes = HOST_AXES + ("chip",)
    gx = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(5), (2 * n, 8)),
        NamedSharding(gmesh, P(batch_axes)))
    gy = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(6), (2 * n,)),
        NamedSharding(gmesh, P(batch_axes)))
    gw = jax.device_put(jnp.zeros((8,)), NamedSharding(gmesh, P()))

    @jax.jit
    def grid_step(w, x, y):
        def loss_fn(w):
            return jnp.mean((x @ w - y) ** 2)

        loss, grad = jax.value_and_grad(loss_fn)(w)
        return w - 0.1 * grad, loss

    gw, gloss = grid_step(gw, gx, gy)
    return np.asarray(gx), np.asarray(gy), float(gloss), np.asarray(gw)


# -- the stages ---------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp_tp", "fsdp"])
def test_stage1_resnet_matches_the_jax_dryrun(pool, fsdp):
    """ResNet-50 (width 16, 16 classes, f32, 32 x 32) one SGD step on
    the 2 x 2 (data, model) mesh, and with FSDP on 4 x 1 (some kernel
    stored as a data shard): the loss, every parameter and BatchNorm
    statistic against the JAX stage."""
    init, batch, want_loss, want = jax_stage1(N, fsdp=fsdp)
    got = pool.run(cases.dryrun_stage, "fsdp" if fsdp else "dp_tp",
                   variables=init, batch=batch)
    want_mesh = {"data": 4, "model": 1} if fsdp else {"data": 2,
                                                      "model": 2}
    for r in got:
        assert r["step"] == 1 and r["mesh"] == want_mesh
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
    assert_trees_close(got[0]["params"], want)
    assert_trees_close(got[3]["params"], want)


@pytest.fixture(scope="module")
def stage2():
    return jax_stage2(1, 2, 2)


@pytest.fixture(scope="module")
def stage2_grads(stage2):
    init, tokens, _, _ = stage2
    return {aux_only: jax_stage2_grads(1, 2, 2, init, tokens,
                                       aux_only=aux_only)
            for aux_only in (False, True)}


def assert_adam_step_close(got, want, init, grads, lr=1e-3, eps=1e-8):
    """The parameters after one Adam step against the reference's, to
    PARAM_TOL, except elements whose reference gradient lies below the
    gradient check's own atol (1e-6): Adam's first step lr·g/(|g| +
    eps) turns such a gradient's rounding (a key bias's gradient is
    zero in exact arithmetic, since it shifts all of a query's scores
    alike and the softmax cancels it; a sum of cancelling terms lands
    near eps) into a step of up to lr. Such an element may differ, and
    is then held on each side to a step of at most lr; they must stay
    under 1% of the elements (the key biases alone are 64 of the
    52608)."""
    got, want = dict(torch_drivers.flat(got)), dict(torch_drivers.flat(want))
    init, grads = dict(torch_drivers.flat(init)), dict(
        torch_drivers.flat(grads))
    assert set(got) == set(want) == set(init) == set(grads)
    apart_total = total = 0
    for name, value in want.items():
        apart = ~np.isclose(got[name], value, **PARAM_TOL)
        total += value.size
        if not apart.any():
            continue
        apart_total += int(apart.sum())
        assert np.all(np.abs(grads[name][apart])
                      < PARAM_TOL["atol"]), name
        for side in (got[name], value):
            assert np.all(np.abs(side[apart] - init[name][apart])
                          <= lr * (1 + 1e-5)), name
    assert apart_total <= total // 100, (apart_total, total)


def test_stage2_combined_step_matches_the_jax_dryrun(pool, stage2,
                                                     stage2_grads):
    """The MoE LM bound to the (1, 2, 2) (data, context, expert) mesh:
    ring attention over "context", two of four experts a rank, the
    next-token loss plus 0.01 aux, one Adam step. The loss and every
    parameter against the JAX stage on a (1, 2, 2) submesh
    (``assert_adam_step_close``)."""
    init, tokens, want_loss, want = stage2
    got = pool.run(cases.dryrun_stage, "dp_sp_ep", params=init,
                   batch=tokens)
    for r in got:
        assert r["step"] == 1 and r["local_experts"] == 2
        assert r["mesh"] == {"data": 1, "context": 2, "expert": 2}
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
    for r in got:
        assert_adam_step_close(r["params"], want, init,
                               stage2_grads[False][1])


@pytest.mark.parametrize("aux_only", [False, True], ids=["loss", "aux"])
def test_stage2_gradients_match_jax(pool, stage2, stage2_grads, aux_only):
    """The gradients of one step on (1, 2, 2) before the update: the
    whole objective, and the router's 0.01 aux alone (its gradient
    reaches every parameter through the routing probabilities). The
    Trainer weighs a context rank's loss, aux included, by its share of
    the positions and sums the gradients over "context";
    ``expert_parallel_moe`` averages aux over the partial "context" and
    the replicated "expert": the gate's, the expert kernels' (gathered
    from their expert shards) and every other gradient, the clip's
    global norm and the reported loss equal jax.grad's, so aux counts
    once, neither P times nor 1/P times."""
    init, tokens, _, _ = stage2
    want_loss, want, want_norm = stage2_grads[aux_only]
    got = pool.run(cases.combined_grads, init, tokens, (1, 2, 2),
                   aux_only=aux_only)
    assert np.abs(want["block1"]["moe"]["gate"]).sum() > 0
    for r in got:
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["norm"], want_norm, rtol=1e-5)
        assert_trees_close(r["grads"], want)


def test_stage3_pipelines_match_the_jax_dryrun(pool):
    """The GPipe toy (an input outside the graph, plain SGD on the
    stacked stages) and the circular PipelinedLM over the 2 x 2 (data,
    pipe) mesh: both losses and the whole updated parameters against
    the JAX stage."""
    inputs, want_loss, want_toy, want_lm_loss, want_lm = jax_stage3(N)
    got = pool.run(cases.dryrun_stage, "pp", **inputs)
    for r in got:
        assert r["mesh"] == {"data": 2, "pipe": 2}
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["lm_loss"], want_lm_loss,
                                   rtol=LOSS_RTOL)
        assert_trees_close(r["params"], want_toy)
        assert_trees_close(r["lm_params"], want_lm)


def test_stage4_host_grid_matches_the_jax_dryrun(pool):
    """The 2 x 2 x 1 host grid, the batch over the host axes and
    "chip": the loss and the new weights of the least-squares step."""
    x, y, want_loss, want_w = jax_stage4(N)
    got = pool.run(cases.dryrun_stage, "host_grid", x=x, y=y)
    for r in got:
        assert r["mesh"] == {"host_x": 2, "host_y": 2, "host_z": 1,
                             "chip": 1}
        np.testing.assert_allclose(r["loss"], want_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["params"], want_w, **PARAM_TOL)


def test_dryrun_multichip_end_to_end(pool):
    """``dryrun_multichip(4, device="cpu")`` on the four ranks: every
    stage the JAX gates allow at n = 4 runs (all five), one step each,
    a finite loss, the same summary on every rank; a world of another
    size is refused."""
    got = pool.run(cases.dryrun_all, N)
    summary = got[0]
    assert all(r == summary for r in got)
    assert list(summary["stages"]) == list(dryrun.STAGES)
    for name, stage in summary["stages"].items():
        assert stage["ran"] and stage["step"] == 1, name
        assert np.isfinite(stage["loss"]), name
    assert summary["stages"]["dp_sp_ep"]["mesh"] == {
        "data": 1, "context": 2, "expert": 2}
    with pytest.raises(RuntimeError, match="need 8 devices"):
        pool.run(cases.dryrun_all, 8)


def test_gates_follow_the_jax_dryrun():
    assert [k for k, v in dryrun.gates(1).items() if v is None] == ["dp_tp"]
    assert [k for k, v in dryrun.gates(2).items() if v is None] == [
        "dp_tp", "fsdp", "pp"]
    assert all(v is None for v in dryrun.gates(8).values())
    assert dryrun.gates(3)["fsdp"] is not None


# -- the mesh helper and the routed layers' token layout ---------------------


def test_named_mesh_lays_ranks_out_row_major(pool):
    """named_mesh((1, 2, 2), (data, context, expert)): rank r sits at
    (0, r // 2, r % 2), its expert peers are adjacent ranks and its
    context peers two apart; axis_size/axis_index answer every axis."""
    names = (DATA_AXIS, CONTEXT_AXIS, EXPERT_AXIS)
    got = pool.run(cases.named_mesh_facts, (1, 2, 2), names)
    for rank, (shape, coord, peers, facts) in enumerate(got):
        assert shape == {"data": 1, "context": 2, "expert": 2}
        assert coord == (0, rank // 2, rank % 2)
        assert peers == {"data": [rank],
                         "context": [rank % 2, rank % 2 + 2],
                         "expert": [rank - rank % 2, rank - rank % 2 + 1]}
        assert facts == {"data": (1, 0), "context": (2, rank // 2),
                         "expert": (2, rank % 2)}


@pytest.mark.parametrize("shape,names,want", [
    ((2, 2, 2), ("data", "context", "expert"), "needs 8 devices; only 4"),
    ((2, 2), ("data", "context", "expert"), "as many distinct axis names"),
    ((2, 2), ("data", "data"), "as many distinct axis names"),
    ((0, 4), ("data", "expert"), "must be >= 1")])
def test_named_mesh_errors(pool, shape, names, want):
    for r in pool.run(cases.named_mesh_facts, shape, names):
        assert r[0] == "ValueError" and want in r[1]


def test_named_mesh_on_fewer_ranks_than_the_world(pool):
    """A (1, 1, 2) mesh takes ranks 0 and 1; ranks 2 and 3 hold no
    coordinate in it."""
    got = pool.run(cases.named_mesh_facts, (1, 1, 2),
                   (DATA_AXIS, CONTEXT_AXIS, EXPERT_AXIS))
    assert [r[1] for r in got] == [(0, 0, 0), (0, 0, 1), None, None]


class _Mesh:
    """A DeviceMesh's two attributes the token-layout rule reads."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.mesh = np.zeros(shape)


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2), (2, 1, 2),
                                   (4, 2, 1), (1, 4, 2)])
@pytest.mark.parametrize("tokens", [64, 96, 128])
def test_residual_token_spec_matches_jax(shape, tokens):
    """The routed layers' token layout on (data, context, expert)
    meshes from the global token count: the JAX model's
    ``_residual_token_spec``, axis for axis; ("context",) on (1, 2,
    2) and ("data", "context") on (2, 2, 2) at the dryrun's batches (4
    rows of 16 tokens a data rank)."""
    names = (DATA_AXIS, CONTEXT_AXIS, EXPERT_AXIS)
    n = int(np.prod(shape))
    jax_mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), names)
    want = jax_moe._residual_token_spec(jax_mesh, tokens)
    got = expert.residual_token_spec(_Mesh(shape, names), tokens)
    assert P(got if got else None) == want
    if shape == (1, 2, 2) and tokens == 64:
        assert got == ("context",)
    if shape == (2, 2, 2) and tokens == 128:
        assert got == ("data", "context")


# -- the driver ---------------------------------------------------------------


def test_driver_still_refuses_context_with_expert():
    """The combined mesh is the dryrun's alone: the port's driver
    refuses --context-parallelism with --expert-parallelism with the
    JAX driver's SystemExit message, word for word."""
    flags = ["--model", "moe", "--expert-parallelism", "2",
             "--context-parallelism", "2", "--attention", "ring"]
    args = port_train.parse_args(["--device", "cpu"] + flags)
    with pytest.raises(SystemExit) as port_exit:
        port_train.check_ported(args)
    with pytest.raises(SystemExit) as jax_exit:
        torch_drivers.demo_train().main(flags)
    assert str(port_exit.value) == str(jax_exit.value)
    assert "cannot combine" in str(port_exit.value)


def test_entry_point_has_no_cpu_fallback(monkeypatch):
    """``--device cuda`` (the default) without a card raises from the
    NCCL backend; it never drops to the CPU."""
    for var in ("TPU_WORKER_HOSTNAMES", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        dryrun.main([])


@pytest.mark.parametrize("env, want", [
    ({"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1",
      "MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "29511"},
     dict(backend="nccl", init_method="tcp://10.0.0.2:29511",
          world_size=4, rank=3, device="cuda:1")),
    ({"TPU_WORKER_HOSTNAMES": "h0,h1", "TPU_WORKER_ID": "1"},
     dict(backend="nccl", init_method="tcp://h0:8476", world_size=2,
          rank=1, device="cuda:0")),
    ({}, dict(backend="nccl", world_size=1, rank=0, device="cuda:0")),
], ids=["torchrun", "plugin-env", "one-card"])
def test_start_world_reads_torchrun_then_the_plugin_env(monkeypatch, env,
                                                         want):
    """The card entry point's world (``distributed.start_world``):
    torchrun's variables first (the card indexed by LOCAL_RANK), then
    the plugin's env contract, else a one-rank group on localhost (card
    0: NCCL binds the group to an indexed device)."""
    from container_engine_accelerators_tpu_torch.parallel import distributed

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID",
                "CEA_COORDINATOR_ADDRESS", "CEA_COORDINATOR_PORT"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    calls = []
    device = distributed.start_world("cuda", _initialize=lambda **kw:
                                     calls.append(kw))
    assert len(calls) == 1 and device == want["device"]
    for key, value in want.items():
        assert calls[0][key] == value, (key, calls[0])
    if not env:
        assert calls[0]["init_method"].startswith("tcp://127.0.0.1:")


def test_stage3_head_dim_is_refused_on_the_card_path(monkeypatch):
    """Stage 3's PipelinedLM (E 16 over 4 heads: head dim 4, the JAX
    dryrun's widths) on the card path, which refused head dim 4 until
    the flash kernels took every head dim. ``_device_type`` says cuda,
    so each flash call goes through the wrappers' route (D 4 zero-padded
    to 8, the scale 1/sqrt(4)), and each kernel (``run``, what the route
    hands over) is replaced by its plain version. The next-token loss
    on the JAX init and tokens equals the JAX PipelinedLM's within
    LOSS_RTOL, and the backward runs through the route as well."""
    import torch

    from container_engine_accelerators_tpu_torch.ops import attention
    from container_engine_accelerators_tpu_torch.parallel import (
        PipelinedLM as PortPipelinedLM,
    )

    jplm = JaxPipelinedLM(**dryrun.PIPE_LM, num_layers=2, pipe=1,
                          dtype=jnp.float32)
    params = jax.jit(jplm.init)(jax.random.PRNGKey(7))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(8), (2, dryrun.PIPE_SEQ), 0,
        dryrun.PIPE_LM["vocab_size"]))
    logp = jax.nn.log_softmax(
        jax.jit(jplm.reference_apply)(params, tokens)[:, :-1])
    want = -float(jnp.mean(jnp.take_along_axis(
        logp, jnp.asarray(tokens)[:, 1:, None], axis=-1)))

    seen = []

    def plain(fn, wrap=lambda x: x):
        def run(*args):
            seen.append((fn.__name__, args[0].shape[3], args[-1]))
            return wrap(fn(*args))
        return run

    monkeypatch.setattr(attention, "_device_type", lambda *xs: "cuda")
    monkeypatch.setattr(attention.flash_fwd, "run",
                        plain(attention.flash_attention_reference))
    monkeypatch.setattr(attention.flash_bwd_dq, "run", plain(
        attention.flash_attention_dq_reference, lambda x: (x,)))
    monkeypatch.setattr(attention.flash_bwd_dkv, "run",
                        plain(attention.flash_attention_dkv_reference))
    plm = PortPipelinedLM(**dryrun.PIPE_LM, num_layers=2, pipe=1,
                          dtype=torch.float32, stage=None, device="cpu")
    plm.load(_np(params))
    tok = torch.from_numpy(tokens.copy()).long()
    logits = plm.reference_apply(tok)
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    loss = -torch.mean(logp.gather(-1, tok[:, 1:, None]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want, rtol=LOSS_RTOL)
    assert all(torch.isfinite(p.grad).all() for p in plm.parameters())
    names = ("flash_attention_reference", "flash_attention_dq_reference",
             "flash_attention_dkv_reference")
    assert sorted(seen) == sorted(
        (name, 8, 0.5) for name in names for _ in range(2))


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

"""The port's expert parallelism and MoE on a mesh (parallel/expert.py,
models/moe.py, parallel/spmd.py) on four gloo ranks against the JAX
package on a CPU submesh: tests/test_expert.py's cases (routing,
capacity, expert_parallel_moe against the JAX function and against
dense_moe, the divisibility error, gradients, MoEMlp with a mesh, the
MoE LM's shapes, a Trainer on a 2 x 2 (data, expert) mesh against the
JAX Trainer), then a dropping router on the residual token layout
against JAX's groups, and MoE on a (data, model) mesh against the JAX
Trainer's global routing. f32 throughout; tolerances at each
assertion (JAX's 2e-5 for the layer)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from container_engine_accelerators_tpu.models import (
    MoETransformerLM as JaxMoE,
)
from container_engine_accelerators_tpu.models import moe as jax_moe
from container_engine_accelerators_tpu.models.transformer import (
    next_token_loss_fn as jax_next_token,
)
from container_engine_accelerators_tpu.parallel import Trainer as JaxTrainer
from container_engine_accelerators_tpu.parallel import (
    batch_sharding as jax_batch_sharding,
)
from container_engine_accelerators_tpu.parallel import build_mesh as jax_mesh
from container_engine_accelerators_tpu.parallel import expert as jax_expert
from container_engine_accelerators_tpu.parallel.mesh import (
    MeshSpec as JaxMeshSpec,
)
from container_engine_accelerators_tpu.parallel.train import (
    cross_entropy_loss as jax_xent,
)
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models.moe import (
    MoETransformerLM,
)
from container_engine_accelerators_tpu_torch.parallel import expert
from tests import torch_dist_cases as cases
from tests.torch_dist_pool import RankPool

N = 4
T, D, F, E = 64, 16, 32, 4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal((D, E)).astype(np.float32),
            (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32),
            (rng.standard_normal((E, F, D)) * 0.1).astype(np.float32))


def _jax_emesh(expert_size, data=1):
    return jax_expert.build_expert_mesh(
        expert=expert_size, data=data,
        devices=jax.devices()[:expert_size * data])


# -- routing ----------------------------------------------------------------


def test_routing_respects_capacity():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, E)).astype(np.float32))
    dispatch, combine, _ = expert.top_k_routing(logits, 3, top_k=2)
    assert dispatch.sum(dim=0).max() <= 1.0
    assert dispatch.sum(dim=(1, 2)).max() <= 2.0
    assert combine.sum(dim=(1, 2)).max() <= 1.0 + 1e-5
    want = jax_expert.top_k_routing(jnp.asarray(logits.numpy()), 3,
                                    top_k=2)
    for got, ref in zip((dispatch, combine), want[:2]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


def test_routing_uniform_aux_is_one():
    _, _, aux = expert.top_k_routing(torch.zeros((64, E)), 64, top_k=1)
    np.testing.assert_allclose(float(aux), 1.0, rtol=1e-5)


def test_expert_capacity_bounds():
    for args in ((64, 4, 1.0, 1), (64, 4, 1.25, 2), (1, 64, 1.0, 1)):
        assert expert.expert_capacity(*args) == (
            jax_expert.expert_capacity(*args))
    assert expert.expert_capacity(64, 4, 1.25, 2) == 40


# -- expert-parallel against the JAX function and dense_moe -----------------


def _jax_ep(weights, expert_size, data=1, spec=None, **kwargs):
    mesh = _jax_emesh(expert_size, data)
    out, aux = jax_expert.expert_parallel_moe(
        mesh, *(jnp.asarray(w) for w in weights), token_spec=spec, **kwargs)
    return np.asarray(out), float(aux)


@pytest.mark.parametrize("expert_size", [2, 4])
@pytest.mark.parametrize("top_k", [1, 2])
def test_expert_parallel_matches_dense(pool, weights, expert_size, top_k):
    """Ample capacity (no drops): the ranks' outputs, in rank order, are
    dense_moe's to 2e-5 and the JAX function's on a (data, expert)
    submesh of the same shape (each rank routes its own group, T/4
    tokens); aux equals the JAX aux (the mean of the groups')."""
    data = N // expert_size
    kwargs = dict(capacity_factor=float(E), top_k=top_k)
    res = pool.run(cases.ep_moe, *weights, expert_size, data, **kwargs)
    got = np.concatenate([r["out"] for r in res])
    want, _ = expert.dense_moe(*(torch.from_numpy(w) for w in weights),
                               **kwargs)
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-5, atol=2e-5)
    jax_out, jax_aux = _jax_ep(weights, expert_size, data, **kwargs)
    np.testing.assert_allclose(got, jax_out, rtol=2e-5, atol=2e-5)
    for r in res:
        np.testing.assert_allclose(r["aux"], jax_aux, rtol=1e-5)
        assert np.isfinite(r["aux"]) and r["aux"] >= 1.0 - 1e-5


def test_expert_count_must_divide_axis(pool, weights):
    """Six experts on a four-rank expert axis: JAX's ValueError."""
    tokens, gate, w_in, w_out = weights
    with pytest.raises(RuntimeError, match="6 experts not divisible"):
        pool.run(cases.ep_moe, tokens, gate, w_in.repeat(2, 0)[:6],
                 w_out.repeat(2, 0)[:6], N, 1, whole=True)
    with pytest.raises(ValueError, match="not divisible"):
        jax_expert.expert_parallel_moe(
            jax_expert.build_expert_mesh(expert=8),
            *(jnp.asarray(w) for w in (tokens, gate, np.concatenate(
                [w_in, w_in])[:6], np.concatenate([w_out, w_out])[:6])))


def test_expert_parallel_grads_flow(pool, weights):
    """The gradient of mean(out ** 2) + 0.01 aux (capacity factor 2, so
    some choices drop) w.r.t. w_in and the gate on four expert ranks
    against jax.grad of the JAX function: each rank's slice of w_in
    (its experts' slots came from every group), the gate summed over
    the ranks' shares; rtol 1e-4 / atol 1e-6."""
    res = pool.run(cases.ep_moe, *weights, N, 1, grads=True,
                   capacity_factor=2.0)
    got_w = np.concatenate([r["w_in_grad"] for r in res])
    got_g = sum(r["gate_grad"] for r in res)
    mesh = _jax_emesh(N)
    tokens, gate, w_in, w_out = (jnp.asarray(w) for w in weights)

    def loss(w_in, gate):
        out, aux = jax_expert.expert_parallel_moe(
            mesh, tokens, gate, w_in, w_out, capacity_factor=2.0)
        return jnp.mean(out ** 2) + 0.01 * aux

    want_w, want_g = jax.grad(loss, argnums=(0, 1))(w_in, gate)
    assert np.abs(got_w).sum() > 0 and np.isfinite(got_w).all()
    np.testing.assert_allclose(got_w, np.asarray(want_w), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(got_g, np.asarray(want_g), rtol=1e-4,
                               atol=1e-6)


def test_dropping_router_matches_jax_groups(pool, weights):
    """The residual token layout on a 2 x 2 (data, expert) mesh with a
    dropping router (capacity factor 1.0, top-2 over 4 experts): each
    expert-axis peer routes its contiguous T/4 subgroup of its data
    rank's block, as the JAX function's shard_map does, so the dropped
    tokens are the same; output to 2e-5 against the JAX function with
    token_spec P("data"), and its gradients (w_in summed over the data
    ranks, the gate over the data ranks' shares) to rtol 1e-4."""
    kwargs = dict(capacity_factor=1.0, top_k=2)
    res = pool.run(cases.ep_moe, *weights, 2, 2, residual=True, grads=True,
                   **kwargs)
    got = np.concatenate([res[0]["out"], res[2]["out"]])
    np.testing.assert_array_equal(res[0]["out"], res[1]["out"])
    jax_out, jax_aux = _jax_ep(weights, 2, 2, spec=P("data"), **kwargs)
    np.testing.assert_allclose(got, jax_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(res[0]["aux"], jax_aux, rtol=1e-5)
    dense, _ = expert.dense_moe(*(torch.from_numpy(w) for w in weights),
                                **kwargs)
    assert not np.allclose(got, dense.numpy(), atol=1e-3)
    mesh = _jax_emesh(2, 2)
    tokens, gate, w_in, w_out = (jnp.asarray(w) for w in weights)

    def loss(w_in, gate):
        out, aux = jax_expert.expert_parallel_moe(
            mesh, tokens, gate, w_in, w_out, token_spec=P("data"), **kwargs)
        return jnp.mean(out ** 2) + 0.01 * aux

    want_w, want_g = jax.grad(loss, argnums=(0, 1))(w_in, gate)
    got_w = np.concatenate([res[0]["w_in_grad"] + res[2]["w_in_grad"],
                            res[1]["w_in_grad"] + res[3]["w_in_grad"]])
    np.testing.assert_allclose(got_w, np.asarray(want_w), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(res[0]["gate_grad"] + res[2]["gate_grad"],
                               np.asarray(want_g), rtol=1e-4, atol=1e-6)


# -- the module and the model -----------------------------------------------


def test_moe_mlp_module_parallel_matches_local(pool):
    """MoEMlp bound to a four-rank expert mesh (whole weights, each rank
    its experts at use) against the same layer on one device: 2e-5."""
    from container_engine_accelerators_tpu_torch.models.moe import MoEMlp

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, D)).astype(np.float32)
    params = {"gate": rng.standard_normal((D, E)).astype(np.float32),
              "w_in": (rng.standard_normal((E, D, 2 * D)) * 0.2).astype(
                  np.float32),
              "w_out": (rng.standard_normal((E, 2 * D, D)) * 0.2).astype(
                  np.float32)}
    options = dict(mlp_ratio=2, capacity_factor=float(E))
    got = pool.run(cases.moe_mlp_mesh, x, params, N, **options)
    local = MoEMlp(D, E, dtype=torch.float32, **options)
    with torch.no_grad():
        for name, value in params.items():
            getattr(local, name).copy_(torch.from_numpy(value))
        want, _ = local(torch.from_numpy(x))
    for g in got:
        np.testing.assert_allclose(g, want.numpy(), rtol=2e-5, atol=2e-5)


def test_moe_lm_forward_shapes():
    config = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
                  num_experts=E, max_seq_len=64)
    model = convert.load_lm(config, convert.init_flax_layout_params(
        config, 0), device="cpu", dtype=torch.float32)
    assert isinstance(model, MoETransformerLM) and model.mesh is None
    logits, aux = model(torch.zeros((2, 16), dtype=torch.long))
    assert logits.shape == (2, 16, 64) and logits.dtype == torch.float32
    assert np.isfinite(float(aux))


MOE_LM = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
              num_experts=E, max_seq_len=16)


def _jax_moe_run(config, tree, batches, mesh, bind):
    model = JaxMoE(dtype=jnp.float32, mesh=mesh if bind else None,
                   **config)
    trainer = JaxTrainer(
        jax_moe.make_apply_fn(model),
        jax_moe.with_router_loss(jax_next_token(jax_xent)),
        optax.sgd(0.1, momentum=0.9), mesh=mesh)
    state = trainer.init_state(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)})
    losses = []
    for tokens in batches:
        batch = jax.device_put(jnp.asarray(tokens), jax_batch_sharding(mesh))
        state, loss = trainer.train_step(state, (batch, batch))
        losses.append(float(loss))
    return losses, state


def _moe_batches():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 64, (8, 16)).astype(np.int32)
            for _ in range(2)]


def _check_params(got, want_state, config):
    port = convert.params_to_flax(
        {n: torch.from_numpy(p) for n, p in got.items()}, config)
    want = jax.tree_util.tree_map(np.asarray, want_state.params)

    def flat(tree, prefix=()):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from flat(tree[key], prefix + (key,))
            else:
                yield "/".join(prefix + (key,)), np.asarray(tree[key])

    got_flat, want_flat = dict(flat(port)), dict(flat(want))
    assert set(got_flat) == set(want_flat)
    for name, value in want_flat.items():
        np.testing.assert_allclose(got_flat[name], value, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_moe_lm_trains_expert_parallel(pool):
    """Two SGD steps of the MoE LM bound to a 2 x 2 (data, expert) mesh
    (top-2 at capacity 1.25, a dropping router): each rank holds E/2
    experts of each routed layer, and the losses (rtol 1e-5) and the
    whole parameters (rtol 1e-4 / atol 1e-6) equal the JAX Trainer's
    with the JAX model bound to a 2 x 2 submesh; the loss falls."""
    tree = convert.init_flax_layout_params(MOE_LM, 2)
    # One batch twice, as the JAX test: the second loss is lower.
    batches = _moe_batches()[:1] * 2
    got = pool.run(cases.train_moe, MOE_LM, tree, batches, expert=2, data=2)
    assert got[0]["local_shapes"]["blocks.1.moe.w_in"][0] == E // 2
    mesh = _jax_emesh(2, 2)
    want_losses, want_state = _jax_moe_run(MOE_LM, tree, batches, mesh,
                                           bind=True)
    spec = want_state.params["block1"]["moe"]["w_in"].sharding.spec
    assert spec[0] == jax_expert.EXPERT_AXIS
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=1e-5)
    assert got[0]["losses"][1] < got[0]["losses"][0]
    _check_params(got[0]["params"], want_state, MOE_LM)


@pytest.mark.parametrize("data,model", [(4, 1), (2, 2)])
def test_moe_on_a_data_mesh_matches_the_jax_trainers_routing(pool, data,
                                                             model):
    """The MoE LM unbound on a (4, 1) data mesh and a (2, 2) (data,
    model) mesh: the gate logits gathered over "data" and the global
    batch routed alike on every rank (capacity and aux over the global
    batch, a dropping router), on the model axis the model-sharded
    expert kernels gathered at use; two steps against the JAX Trainer's
    (GSPMD's dense_moe over the global batch) on a submesh of the same
    shape: losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-6."""
    config = dict(MOE_LM, embed_dim=128, num_heads=4)
    tree = convert.init_flax_layout_params(config, 4)
    batches = _moe_batches()
    got = pool.run(cases.train_moe, config, tree, batches, data=data,
                   model=model)
    mesh = jax_mesh(JaxMeshSpec(data=data, model=model),
                    devices=jax.devices()[:4])
    want_losses, want_state = _jax_moe_run(config, tree, batches, mesh,
                                           bind=False)
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=1e-5)
    _check_params(got[0]["params"], want_state, config)

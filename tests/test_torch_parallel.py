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

"""The port's Trainer on a mesh (``mesh=``, ``fsdp=``; parallel/spmd.py)
on four gloo ranks: the trainer cases of tests/test_parallel.py (dp
loss falling, dp x tp against dp at rtol 2e-4, the ResNet step on a
2 x 2 mesh, FSDP's 1/N shards and its loss against dp at rtol 1e-5,
FSDP with tp), the BatchNorm statistics of a dp step against one
process on the global batch, grad accumulation, EMA, remat and the
eval step on a mesh, the step telemetry on a mesh, and the 2 x 2 step
against the JAX Trainer on a 2 x 2 CPU submesh from the same converted
init and the same batches. Models in f32; tolerances are stated at
each assertion."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from container_engine_accelerators_tpu.models import MnistMLP as JaxMLP
from container_engine_accelerators_tpu.models import mlp as jax_mlp
from container_engine_accelerators_tpu.models import resnet as jax_resnet
from container_engine_accelerators_tpu.models.resnet import (
    make_apply_fn as jax_resnet_apply_fn,
)
from container_engine_accelerators_tpu.parallel import (
    MeshSpec as JaxMeshSpec,
)
from container_engine_accelerators_tpu.parallel import Trainer as JaxTrainer
from container_engine_accelerators_tpu.parallel import (
    batch_sharding as jax_batch_sharding,
)
from container_engine_accelerators_tpu.parallel import build_mesh as jax_mesh
from container_engine_accelerators_tpu.parallel.train import (
    cross_entropy_loss as jax_xent,
)
from tests import torch_dist_cases as cases
from tests.torch_dist_pool import RankPool

N = 4
MLP = {"hidden": 1024}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


def _mlp_batches(steps, batch=16, seed=1, distinct=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps if distinct else 1):
        out.append((rng.standard_normal((batch, 28, 28, 1)).astype(
            np.float32), rng.integers(0, 10, batch).astype(np.int32)))
    return out if distinct else out * steps


def _image_batches(steps, batch=16, size=32, classes=8, seed=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, size, size, 3)).astype(
        np.float32), rng.integers(0, classes, batch).astype(np.int32))
        for _ in range(steps)]


def _flat(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(tree[key],
                                                         np.float32)


def _assert_trees_close(got, want, rtol, atol, what):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want), what
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {name}")


def test_trainer_dp_loss_decreases(pool):
    tree = cases.init_tree("mlp", **MLP)
    batches = _mlp_batches(30, batch=64, distinct=False)
    out = pool.run(cases.train, "mlp", tree, batches, MLP, data=N)
    losses = out[0]["losses"]
    assert losses[-1] < losses[0] * 0.5, losses[:3] + losses[-3:]
    # Every rank reports the global batch's loss.
    assert all(o["losses"] == losses for o in out)


def test_trainer_dp_tp_matches_dp(pool):
    """Same data, same init: the (4, 1) and (2, 2) runs agree to rtol
    2e-4 (tests/test_parallel.py's bound), and the (2, 2) run really
    holds half of each wide kernel's out-features."""
    tree = cases.init_tree("mlp", **MLP)
    batches = _mlp_batches(5)
    dp = pool.run(cases.train, "mlp", tree, batches, MLP, data=4)
    dptp = pool.run(cases.train, "mlp", tree, batches, MLP, data=2, model=2)
    np.testing.assert_allclose(dp[0]["losses"], dptp[0]["losses"],
                               rtol=2e-4)
    assert dptp[0]["layouts"]["Dense_0.weight"] == ((None, "model"), None,
                                                    0)
    assert dptp[0]["facts"]["Dense_0.weight"][0] == (512, 784)
    assert dptp[0]["facts"]["Dense_2.weight"][0] == (10, 1024)
    _assert_trees_close(dptp[0]["variables"], dp[0]["variables"], 2e-4,
                        1e-6, "param")


def test_trainer_resnet_step_runs_sharded(pool):
    size = {"width": 8}
    tree = cases.init_tree("resnet", **size)
    batch = _image_batches(1)[0]
    out = pool.run(cases.train, "resnet", tree, [batch, batch], size,
                   data=2, model=2, lr=0.01, momentum=0.0)
    loss1, loss2 = out[0]["losses"]
    assert loss2 < loss1


def test_fsdp_shards_params_and_matches_dp(pool):
    """fsdp=True on a (4, 1) mesh: every kernel of 2-D or more with a
    dim >= 512 that divides by 4 holds exactly 1/4 of its elements on
    each rank, and so does its momentum buffer; 1-D leaves (the 512-wide
    BN scales included) stay whole; the loss after two steps equals
    dp's to rtol 1e-5 (tests/test_parallel.py's bound)."""
    size = {"width": 64}
    tree = cases.init_tree("resnet", **size)
    batches = _image_batches(2)
    results = {}
    for fsdp in (False, True):
        results[fsdp] = pool.run(cases.train, "resnet", tree, batches, size,
                                 data=N, fsdp=fsdp)
    np.testing.assert_allclose(results[True][0]["losses"][-1],
                               results[False][0]["losses"][-1], rtol=1e-5)
    wide = 0
    for rank_out in results[True]:
        for name, (spec, data_dim, model_dim) in rank_out["layouts"].items():
            whole = results[False][0]["facts"][name][0]
            shape, momentum = rank_out["facts"][name]
            eligible = len(whole) >= 2 and any(
                d >= 512 and d % N == 0 for d in whole)
            if eligible:
                wide += 1
                assert "data" in spec and data_dim is not None, name
                assert np.prod(shape) * N == np.prod(whole), name
                assert momentum == shape, name
            else:
                assert "data" not in spec and shape == whole, name
            if len(whole) < 2:
                assert shape == whole, name
    assert wide, "model has no fsdp-eligible kernels"
    for name, (spec, _, _) in results[False][0]["layouts"].items():
        assert "data" not in spec, name


def test_fsdp_composes_with_tensor_parallelism(pool):
    """2-D layout on a (2, 2) mesh: out-features over "model", another
    dim over "data" in one kernel, each rank holding a quarter; the
    step's loss equals the (4, 1) dp step's to rtol 2e-4. At width 64
    the last stage's 3x3 convs are [3, 3, 512, 512]: O over "model",
    I over "data"."""
    size = {"width": 64}
    tree = cases.init_tree("resnet", **size)
    batches = _image_batches(1)
    both = pool.run(cases.train, "resnet", tree, batches, size, data=2,
                    model=2, fsdp=True)
    dp = pool.run(cases.train, "resnet", tree, batches, size, data=N)
    two_axis = [name for name, (spec, d, m) in both[0]["layouts"].items()
                if "data" in spec and "model" in spec]
    assert two_axis, "no kernel carries both axes"
    for name in two_axis:
        whole = dp[0]["facts"][name][0]
        assert np.prod(both[0]["facts"][name][0]) * 4 == np.prod(whole)
    np.testing.assert_allclose(both[0]["losses"], dp[0]["losses"],
                               rtol=2e-4)


def test_bn_statistics_under_dp_equal_the_global_batch_step(pool):
    """A dp=4 step's BatchNorm running statistics, parameters and loss
    equal one process's step on the whole batch (f32: rtol 1e-5 on the
    loss, statistics to 1e-5 relative to their largest magnitude)."""
    size = {"width": 8}
    tree = cases.init_tree("resnet", **size)
    batches = _image_batches(2)
    single = cases.train(0, "resnet", tree, batches, size)
    dp = pool.run(cases.train, "resnet", tree, batches, size, data=N)
    np.testing.assert_allclose(dp[0]["losses"], single["losses"],
                               rtol=1e-5)
    for name, got in _flat(dp[0]["variables"]["batch_stats"]):
        want = dict(_flat(single["variables"]["batch_stats"]))[name]
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-5, (name, err)
    _assert_trees_close(dp[0]["variables"]["params"],
                        single["variables"]["params"], 1e-4, 1e-6, "param")


def test_grad_accum_under_a_mesh(pool):
    """One grad_accum=4 step on a (2, 2) mesh equals one full-batch step
    (equal chunks cut from the global batch, then sliced per rank):
    rtol/atol 1e-6 on the parameters, 1e-5 on the loss, as
    tests/test_parallel.py holds the JAX step."""
    tree = cases.init_tree("mlp", **MLP)
    batches = _mlp_batches(1, batch=32)
    full = pool.run(cases.train, "mlp", tree, batches, MLP, data=2,
                    model=2, lr=0.5, momentum=0.0)
    accum = pool.run(cases.train, "mlp", tree, batches, MLP, data=2,
                     model=2, lr=0.5, momentum=0.0, grad_accum=4)
    _assert_trees_close(accum[0]["variables"], full[0]["variables"], 1e-6,
                        1e-6, "param")
    assert abs(accum[0]["losses"][0] - full[0]["losses"][0]) < 1e-5


def test_ema_remat_and_eval_step_on_a_mesh(pool):
    """EMA (decay 0.9), remat and FSDP with tp together on a (2, 2)
    mesh: the losses, the EMA shadow and the eval step's logits of the
    global batch (gathered over the data ranks, read on the shadow)
    equal one process's (rtol 1e-5, atol 1e-6)."""
    size = {"width": 8}
    tree = cases.init_tree("resnet", **size)
    batches = _image_batches(2)
    kw = dict(ema_decay=0.9, eval_images=batches[0][0])
    single = cases.train(0, "resnet", tree, batches, size, **kw)
    mesh = pool.run(cases.train, "resnet", tree, batches, size, data=2,
                    model=2, fsdp=True, remat=True, **kw)
    np.testing.assert_allclose(mesh[0]["losses"], single["losses"],
                               rtol=1e-5)
    _assert_trees_close(mesh[0]["ema"], single["ema"], 1e-5, 1e-6, "ema")
    assert mesh[0]["eval_logits"].shape == single["eval_logits"].shape
    np.testing.assert_allclose(mesh[0]["eval_logits"],
                               single["eval_logits"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mfu_source,data,model", [
    ("analytic", 2, 2), ("auto", 4, 1), ("auto", 2, 2)])
def test_step_telemetry_on_a_mesh(pool, mfu_source, data, model):
    """Each rank's straggler detector is fed under host<rank>, its
    goodput books hold the compile step and the productive ones, and
    the FLOPs numerator is the global batch's step on the whole
    parameters, rated across the mesh's 4 ranks, as the JAX Trainer
    rates it across its devices: exactly the one-process figure for
    the analytic form and for the data ranks' summed counts ("auto" on
    a data axis); on a model axis "auto" takes the analytic form."""
    tree = cases.init_tree("mlp", **MLP)
    batches = _mlp_batches(3)
    single = cases.train(0, "mlp", tree, batches, MLP, telemetry=True,
                         mfu_source=mfu_source)["telemetry"]
    analytic = cases.train(0, "mlp", tree, batches, MLP, telemetry=True,
                           mfu_source="analytic")["telemetry"]
    assert single["chips"] == 1
    want = (single if model == 1 else analytic)["flops_per_step"]
    out = pool.run(cases.train, "mlp", tree, batches, MLP, data=data,
                   model=model, telemetry=True, mfu_source=mfu_source)
    for rank, rank_out in enumerate(out):
        tel = rank_out["telemetry"]
        assert tel["host_id"] == f"host{rank}"
        assert tel["hosts"] == [f"host{rank}"]
        assert tel["buckets"]["compile"] > 0
        assert tel["buckets"]["productive"] > 0
        assert tel["flops_per_step"] == want > 0
        assert tel["chips"] == N


def test_lm_column_parallel_on_a_2x2_mesh(pool):
    """The TransformerLM at E 512 (8 heads, 2 KV heads, rope; one layer,
    f32) on a (2, 2) mesh with FSDP: the embedding, the attention's
    output projection and both MLP kernels are column-parallel over
    "model" (their out-features are 512 or 2048), the q and kv kernels
    stay replicated (their last flax dim is the head dim, 64), so every
    rank runs attention on all heads; three steps equal one process's
    (losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-6)."""
    from container_engine_accelerators_tpu_torch.models import convert

    config = dict(vocab_size=64, embed_dim=512, num_layers=1, num_heads=8,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=16)
    tree = convert.init_flax_layout_params(config, 3)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 64, (4, 16)).astype(np.int32)
               for _ in range(3)]
    single = cases.train_lm(0, config, tree, batches)
    mesh = pool.run(cases.train_lm, config, tree, batches, data=2, model=2,
                    fsdp=True)
    layouts = mesh[0]["layouts"]
    for name in ("tok_embed.weight", "blocks.0.attn.proj.weight",
                 "blocks.0.mlp_in.weight", "blocks.0.mlp_out.weight"):
        assert layouts[name][2] is not None, name
    for name in ("blocks.0.attn.q.weight", "blocks.0.attn.kv.weight",
                 "lm_head.weight"):
        assert layouts[name][2] is None, name
    np.testing.assert_allclose(mesh[0]["losses"], single["losses"],
                               rtol=1e-5)
    for name, want in single["params"].items():
        np.testing.assert_allclose(mesh[0]["params"][name], want,
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# -- against the JAX Trainer on a 2 x 2 CPU submesh ------------------------


def _jax_run(kind, tree, batches, size, grad_clip=0.0):
    mesh = jax_mesh(JaxMeshSpec(data=2, model=2), devices=jax.devices()[:4])
    if kind == "mlp":
        model = JaxMLP(hidden=size["hidden"], dtype=jnp.float32)
        apply_fn = jax_mlp.make_apply_fn(model)
    else:
        model = jax_resnet(depth=18, num_classes=8, dtype=jnp.float32,
                           width=size["width"])
        apply_fn = jax_resnet_apply_fn(model)
    tx = optax.sgd(0.1, momentum=0.9)
    if grad_clip:
        tx = optax.chain(optax.clip_by_global_norm(grad_clip), tx)
    trainer = JaxTrainer(apply_fn, jax_xent, tx, mesh=mesh)
    state = trainer.init_state(jax.tree_util.tree_map(jnp.asarray, tree))
    losses = []
    for images, labels in batches:
        batch = (jax.device_put(images, jax_batch_sharding(mesh)),
                 jax.device_put(labels, jax_batch_sharding(mesh)))
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    return losses, jax.tree_util.tree_map(np.asarray, variables)


# Below the MLP's global gradient norm at its first two steps (about
# 5.8 and 9.4 from this init and these batches), so both steps clip.
CLIP = 2.0


@pytest.mark.parametrize("kind,fsdp,grad_clip", [
    pytest.param("mlp", False, 0.0, id="mlp-False"),
    pytest.param("mlp", True, 0.0, id="mlp-True"),
    pytest.param("resnet", False, 0.0, id="resnet-False"),
    pytest.param("mlp", False, CLIP, id="mlp-False-clipped"),
    pytest.param("mlp", True, CLIP, id="mlp-True-clipped")])
def test_2x2_step_matches_the_jax_trainer(pool, kind, fsdp, grad_clip):
    """The port's four ranks on a (2, 2) mesh against the JAX Trainer on
    a 2 x 2 submesh of CPU devices: the MLP at hidden 1024 (its wide
    kernels column-sharded over "model", with FSDP on one case) and the
    ResNet-18 at width 8 (the BatchNorm statistics over "data"), two
    steps of SGD with momentum 0.9: losses to rtol 1e-5, parameters
    and statistics to rtol 1e-4 / atol 1e-6 (f32 sums in another
    order). The clipped cases put optax.clip_by_global_norm(CLIP)
    before the SGD, which clips both steps: the norm is the whole
    gradient's, though every rank holds shards of it."""
    size = MLP if kind == "mlp" else {"width": 8}
    tree = cases.init_tree(kind, **size)
    batches = (_mlp_batches(2) if kind == "mlp" else _image_batches(2))
    want_losses, want = _jax_run(kind, tree, batches, size, grad_clip)
    got = pool.run(cases.train, kind, tree, batches, size, data=2, model=2,
                   fsdp=fsdp, grad_clip=grad_clip)
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=1e-5)
    _assert_trees_close(got[0]["variables"], want, 1e-4, 1e-6, "variable")
    if kind == "mlp":
        assert got[0]["layouts"]["Dense_1.weight"][2] == 0


def test_a_one_rank_mesh_runs_no_collective(monkeypatch):
    """On a mesh whose axes are all one rank wide (this process's own
    gloo group), FSDP with a clipped update runs no collective in a
    step, as GSPMD does no work on a 1-wide axis, and the ResNet's
    losses and variables are bitwise those of the same steps without a
    group."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import (
        distributed,
    )

    size = {"width": 8}
    tree = cases.init_tree("resnet", **size)
    batches = _image_batches(2)
    want = cases.train(0, "resnet", tree, batches, size, grad_clip=CLIP)
    calls = []
    distributed.start_local_group("cpu")
    try:
        for name in ("all_reduce", "all_gather", "reduce_scatter_tensor",
                     "batch_isend_irecv"):
            monkeypatch.setattr(
                dist, name, lambda *a, _n=name, **k: calls.append(_n))
        got = cases.train(0, "resnet", tree, batches, size, data=1,
                          fsdp=True, grad_clip=CLIP)
    finally:
        monkeypatch.undo()
        distributed.shutdown()
    assert calls == []
    assert got["losses"] == want["losses"]
    for name, value in dict(_flat(want["variables"])).items():
        np.testing.assert_array_equal(dict(_flat(got["variables"]))[name],
                                      value, err_msg=name)

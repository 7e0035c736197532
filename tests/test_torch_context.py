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

"""The port's context parallelism (parallel/context.py) on four gloo
ranks against the JAX package's on a CPU submesh of as many devices:
tests/test_context.py's cases (ring and Ulysses against dense and
against the JAX schedules, K sub-blocking, gradients, the 2 x 2 (data,
context) layout, the indivisible-heads error, the mesh's axes, the
flash form through the kernels' plain versions, the lse contract),
then the sequence-sharded Trainer step against the JAX Trainer with
ring attention on a 2 x 2 submesh, the driver's --context-parallelism
2 as two processes against one process, and the driver's flag rules.
Tolerances are JAX's (2e-5; 1e-4 for gradients) unless an assertion
states another."""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from container_engine_accelerators_tpu.models import (
    MoETransformerLM as JaxMoE,
)
from container_engine_accelerators_tpu.models import TransformerLM as JaxLM
from container_engine_accelerators_tpu.models import moe as jax_moe
from container_engine_accelerators_tpu.models import transformer as jax_tr
from container_engine_accelerators_tpu.parallel import Trainer as JaxTrainer
from container_engine_accelerators_tpu.parallel import (
    batch_sharding as jax_batch_sharding,
)
from container_engine_accelerators_tpu.parallel import context as jax_ctx
from container_engine_accelerators_tpu.parallel.train import (
    cross_entropy_loss as jax_xent,
)
from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.parallel import context
from tests import torch_dist_cases as cases
from tests.torch_dist_pool import RankPool

N = 4
B, S, H, D = 2, 32, 4, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(7)
    return tuple(rng.standard_normal((B, S, H, D)).astype(np.float32)
                 for _ in range(3))


def _assemble(results, data, ctx):
    """The global [B, S, ...] array from the ranks' shards."""
    shard = results[0]["out"]
    b, s = shard.shape[:2]
    out = np.zeros((b * data, s * ctx) + shard.shape[2:], shard.dtype)
    for r in results:
        di, ci = r["coord"]
        out[di * b:(di + 1) * b, ci * s:(ci + 1) * s] = r["out"]
    return out


def _assemble_grads(results, data, ctx):
    return [_assemble([dict(r, out=r["grads"][i]) for r in results],
                      data, ctx) for i in range(3)]


def _jax_mesh(context, data=1):
    return jax_ctx.build_context_mesh(
        context=context, data=data, devices=jax.devices()[:context * data])


def _jax_run(kind, q, k, v, context, data=1, causal=False, **kw):
    mesh = _jax_mesh(context, data)
    fn = jax_ctx.ring_attention if kind == "ring" else (
        jax_ctx.ulysses_attention)
    if data > 1:
        kw["batch_axis"] = "data"
    return np.asarray(fn(mesh, *(jnp.asarray(x) for x in (q, k, v)),
                         causal=causal, **kw))


def _jax_grads(kind, q, k, v, context, data=1, causal=False, **kw):
    mesh = _jax_mesh(context, data)
    fn = jax_ctx.ring_attention if kind == "ring" else (
        jax_ctx.ulysses_attention)

    def loss(t):
        return jnp.sum(fn(mesh, *t, causal=causal, **kw) ** 2)

    return [np.asarray(g) for g in jax.grad(loss)(
        tuple(jnp.asarray(x) for x in (q, k, v)))]


@pytest.mark.parametrize("context_size", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense(pool, qkv, context_size, causal):
    """The ring over 2 (on a 2 x 2 mesh: two rings, one a data rank) and
    4 ranks against the port's dense attention and the JAX ring on as
    many devices."""
    data = N // context_size
    got = _assemble(pool.run(cases.ctx_attention, "ring", *qkv,
                             context_size, data, causal), data,
                    context_size)
    want = context.dot_product_attention(
        *(torch.from_numpy(x) for x in qkv), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    jax_want = _jax_run("ring", *qkv, context_size, causal=causal)
    np.testing.assert_allclose(got, jax_want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_kv_subblocking_exact(pool, monkeypatch, causal):
    """_KV_BLOCK 8 on both sides: S/P = 32 keys a hop in 4 sub-blocks;
    the output and dQ against the JAX ring, and Ulysses' local
    attention through the same sub-blocks."""
    monkeypatch.setattr(jax_ctx, "_KV_BLOCK", 8)
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
               for _ in range(3))
    # A (2, 2) mesh: one ring of two context ranks a batch row.
    res = pool.run(cases.ctx_attention, "ring", q, k, v, 2, 2, causal,
                   False, 8, True)
    got = _assemble(res, 2, 2)
    np.testing.assert_allclose(got, _jax_run("ring", q, k, v, 2,
                                             causal=causal),
                               rtol=2e-5, atol=2e-5)
    g_q = _assemble_grads(res, 2, 2)[0]
    want_g = _jax_grads("ring", q, k, v, 2, causal=causal)[0]
    np.testing.assert_allclose(g_q, want_g, rtol=1e-4, atol=1e-4)
    res_u = pool.run(cases.ctx_attention, "ulysses", q, k, v, 2, 2, causal,
                     False, 8)
    np.testing.assert_allclose(
        _assemble(res_u, 2, 2),
        _jax_run("ulysses", q, k, v, 2, causal=causal),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_dense(pool, qkv, causal):
    got = _assemble(pool.run(cases.ctx_attention, "ulysses", *qkv, N, 1,
                             causal), 1, N)
    want = context.dot_product_attention(
        *(torch.from_numpy(x) for x in qkv), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _jax_run("ulysses", *qkv, N,
                                             causal=causal),
                               rtol=2e-5, atol=2e-5)


def test_ulysses_rejects_indivisible_heads(pool):
    """Two heads on a four-rank context axis: JAX's ValueError."""
    out = pool.run(cases.ctx_error, N, (B, S, 2, D))
    assert all(o[0] == "ValueError" and "heads not divisible" in o[1]
               for o in out), out
    mesh = _jax_mesh(N)
    with pytest.raises(ValueError, match="heads not divisible"):
        jax_ctx.ulysses_attention(mesh, *(jnp.zeros((B, S, 2, D)),) * 3)


def test_ring_gradients_match_dense(pool, qkv):
    """dQ, dK and dV of sum(out ** 2) through the causal ring on four
    ranks (K/V gradients come back round the reverse ring) against the
    JAX ring's and the port's dense attention's."""
    res = pool.run(cases.ctx_attention, "ring", *qkv, N, 1, True, None,
                   None, True)
    got = _assemble_grads(res, 1, N)
    want = _jax_grads("ring", *qkv, N, causal=True)
    ts = [torch.from_numpy(x).requires_grad_() for x in qkv]
    (context.dot_product_attention(*ts, causal=True) ** 2).sum().backward()
    for g, w, t in zip(got, want, ts):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-4, atol=1e-4)


def test_ring_with_data_axis(pool, qkv):
    """The deployment layout: a 2 x 2 (data, context) mesh, the batch
    over data and the sequence over context, against the JAX ring with
    batch_axis="data" on a 2 x 2 submesh."""
    got = _assemble(pool.run(cases.ctx_attention, "ring", *qkv, 2, 2,
                             True), 2, 2)
    np.testing.assert_allclose(
        got, _jax_run("ring", *qkv, 2, data=2, causal=True),
        rtol=2e-5, atol=2e-5)


def test_context_mesh_axes(pool):
    out = pool.run(cases.ctx_mesh_facts, 2)
    assert out[0][0] == {"data": 2, "context": 2}
    assert [o[1] for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    err = pool.run(cases.ctx_mesh_facts, 3)
    assert err[0][0] == "ValueError" and "do not factor" in err[0][1]
    assert jax_ctx.CONTEXT_AXIS == context.CONTEXT_AXIS == "context"


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_hops_match_dense(pool, qkv, causal):
    """use_flash=True on the CPU: each hop is flash_attention_lse's
    plain version, hops merge by logsumexp, later blocks skip their
    launch with an lse of -inf; output and gradients against the JAX
    flash ring (interpret-mode Pallas) and the dense attention."""
    res = pool.run(cases.ctx_attention, "ring", *qkv, N, 1, causal, True,
                   None, True)
    got = _assemble(res, 1, N)
    want = _jax_run("ring", *qkv, N, causal=causal, use_flash=True)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    dense = context.dot_product_attention(
        *(torch.from_numpy(x) for x in qkv), causal=causal).numpy()
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)
    want_g = _jax_grads("ring", *qkv, N, causal=causal, use_flash=True)
    for g, w in zip(_assemble_grads(res, 1, N), want_g):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_flash_matches_dense(pool, qkv, causal):
    got = _assemble(pool.run(cases.ctx_attention, "ulysses", *qkv, N, 1,
                             causal, True), 1, N)
    want = _jax_run("ulysses", *qkv, N, causal=causal, use_flash=True)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_lse_matches_logsumexp():
    """flash_attention_lse's lse is the row logsumexp of the scaled,
    masked scores (the merge's contract), as the JAX function's."""
    from container_engine_accelerators_tpu.ops import (
        flash_attention_lse as jax_lse,
    )
    from container_engine_accelerators_tpu_torch.ops.attention import (
        flash_attention_lse,
    )

    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 40, 2, 8)).astype(np.float32)
               for _ in range(3))
    _, lse = flash_attention_lse(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=True, block=128)
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    keep = np.tril(np.ones((40, 40), bool))
    scores = np.where(keep, scores, -1e9)
    top = scores.max(-1, keepdims=True)
    want = (np.log(np.exp(scores - top).sum(-1)) + top[..., 0]).transpose(
        0, 2, 1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    _, jlse = jax_lse(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                      block=128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_reference_matches_dense(qkv, causal):
    """The chunked f32 oracle (one query chunk at a time, online softmax
    over key chunks) against the dense attention and the JAX oracle, at
    chunk 8 of S 32: 2e-5."""
    ts = [torch.from_numpy(x) for x in qkv]
    got = context.chunked_reference_attention(*ts, causal=causal, chunk=8)
    want = context.dot_product_attention(*ts, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    jax_want = jax_ctx.chunked_reference_attention(
        *(jnp.asarray(x) for x in qkv), causal=causal, chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_want),
                               rtol=2e-5, atol=2e-5)


# -- the sequence-sharded Trainer step ---------------------------------------


LM = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
          num_kv_heads=2, max_seq_len=32)


def _jax_lm_run(config, tree, batches, schedule="ring"):
    mesh = _jax_mesh(2, 2)
    fn = jax_ctx.ring_attention if schedule == "ring" else (
        jax_ctx.ulysses_attention)
    attention_fn = functools.partial(
        fn, mesh, axis_name=jax_ctx.CONTEXT_AXIS, batch_axis="data")
    loss = jax_tr.next_token_loss_fn(jax_xent)
    if config.get("num_experts"):
        model = JaxMoE(dtype=jnp.float32, attention_fn=attention_fn,
                       **config)
        apply_fn = jax_moe.make_apply_fn(model)
        loss = jax_moe.with_router_loss(loss)
    else:
        model = JaxLM(dtype=jnp.float32, attention_fn=attention_fn,
                      **config)
        apply_fn = jax_tr.make_apply_fn(model)
    trainer = JaxTrainer(apply_fn, loss, optax.sgd(0.1, momentum=0.9),
                         mesh=mesh)
    state = trainer.init_state(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)})
    losses = []
    for tokens in batches:
        batch = jax.device_put(jnp.asarray(tokens), jax_batch_sharding(mesh))
        state, loss = trainer.train_step(state, (batch, batch))
        losses.append(float(loss))
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


@pytest.mark.parametrize("pos", ["rope", "learned", "moe"])
def test_2x2_context_step_matches_the_jax_trainer(pool, pos):
    """Two SGD steps (momentum 0.9) of a two-layer GQA LM on a 2 x 2
    (data, context) mesh with ring attention against the JAX Trainer
    with ring_attention on a 2 x 2 submesh, from the same converted init
    and batches: the global positions (RoPE, or the learned table), the
    shift-by-one label across the context boundary, the mean over the
    B (S - 1) global positions and the gradients summed over context.
    Losses to rtol 1e-5, parameters to rtol 1e-4 / atol 1e-6. Each
    context rank's blocks saw only its S/P = 16 positions, and the eval
    step's gathered logits equal one process's forward. The "moe"
    case is the MoE LM (rope, 4 experts, a dropping router): its
    routing takes the global batch's gate logits over "data" and
    "context", as GSPMD's dense_moe does, and its aux loss counts once
    across the context ranks' shares."""
    config = dict(LM, pos_embedding="rope" if pos == "moe" else pos)
    if pos == "moe":
        config["num_experts"] = 4
    tree = convert.init_flax_layout_params(config, 3)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 64, (4, 32)).astype(np.int32)
               for _ in range(2)]
    want_losses, want = _jax_lm_run(config, tree, batches)
    got = pool.run(cases.train_lm_context, config, tree, batches, 2, 2)
    np.testing.assert_allclose(got[0]["losses"], want_losses, rtol=1e-5)
    assert all(g["losses"] == got[0]["losses"] for g in got)
    assert {s for g in got for s in g["seen"]} == {(2, 16, 32)}
    port = convert.params_to_flax(
        {n: torch.from_numpy(p) for n, p in got[0]["params"].items()},
        config)
    _assert_trees_close(port, want, 1e-4, 1e-6)
    # The eval step on the mesh: every rank's logits of the global batch
    # (gathered over context and data) are one process's forward of the
    # trained weights, to 1e-4.
    net = convert.load_lm(config, port, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        one = net(torch.from_numpy(batches[0].astype(np.int64)))
    one = (one[0] if isinstance(one, tuple) else one).numpy()
    for g in got:
        np.testing.assert_allclose(g["eval_logits"], one, rtol=1e-4,
                                   atol=1e-4)


def _flat(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(tree[key],
                                                         np.float32)


def _assert_trees_close(got, want, rtol, atol):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def _driver_argv(extra):
    return ["--device", "cpu", "--model", "transformer", "--vocab-size",
            "64", "--embed-dim", "32", "--num-layers", "2", "--num-heads",
            "4", "--num-kv-heads", "2", "--pos-embedding", "rope",
            "--seq-len", "16", "--batch-size", "2", "--steps", "3",
            "--warmup-steps", "1", "--lr", "0.05"] + extra


_DRIVER = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
from container_engine_accelerators_tpu_torch import train
losses = []
result = train.main(json.loads(sys.argv[2]),
                    on_step=lambda step, loss: losses.append(float(loss)))
print("LOSSES", json.dumps({"losses": losses, "mesh": result.get("mesh")},
                           separators=(",", ":")))
'''


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_driver_context_parallelism_two_processes(attention):
    """The port's driver with --context-parallelism 2 --attention
    ``attention`` as two processes (the plugin's env contract on
    localhost) against the same flags without them in one process: the
    first loss to rtol 1e-5, the three to rtol 1e-3, the card's bound
    for the same comparison (chip_smoke's STEP_LOSS_TOL): the driver
    computes in bf16, and the ring rounds each hop's output to bf16
    before its f32 merge where one kernel call rounds once (a CPU run
    measured 5.3e-4 at the second step)."""
    from container_engine_accelerators_tpu_torch.parallel.distributed \
        import free_local_port

    single = []
    port_train.main(_driver_argv([]),
                    on_step=lambda step, loss: single.append(float(loss)))
    port = free_local_port()
    argv = json.dumps(_driver_argv(["--context-parallelism", "2",
                                    "--attention", attention]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DRIVER, REPO, argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                 TPU_WORKER_ID=str(r), CEA_COORDINATOR_PORT=str(port),
                 OMP_NUM_THREADS="1"))
        for r in range(2)]
    outs = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=240)
        assert proc.returncode == 0, stderr[-3000:]
        line = next(ln for ln in stdout.splitlines()
                    if ln.startswith("LOSSES "))
        outs.append(json.loads(line[len("LOSSES "):]))
    losses = [o["losses"] for o in outs]
    assert losses[0] == losses[1]
    assert outs[0]["mesh"] == {"data": 1, "context": 2}
    np.testing.assert_allclose(losses[0][0], single[0], rtol=1e-5)
    np.testing.assert_allclose(losses[0], single, rtol=1e-3)


@pytest.mark.parametrize("flags,message", [
    (["--model", "mnist", "--context-parallelism", "2", "--attention",
      "ring"], "only applies to the LM models"),
    (["--expert-parallelism", "2"], "only applies to --model moe"),
    (["--attention", "ring"], "go together"),
    (["--context-parallelism", "2"], "go together"),
    (["--model", "moe", "--expert-parallelism", "2",
      "--context-parallelism", "2", "--attention", "ring"],
     "cannot combine"),
    (["--context-parallelism", "2", "--attention", "ulysses",
      "--dcn-granules", "2"], "cannot combine"),
    (["--context-parallelism", "2", "--attention", "ring",
      "--model-parallelism", "2"], "has no 'model' axis"),
    (["--model", "moe", "--expert-parallelism", "2",
      "--model-parallelism", "2"], "has no 'model' axis")])
def test_driver_flag_rules(flags, message):
    """The JAX driver's rules, verbatim (demo/tpu-training/train.py):
    its SystemExit messages before any model is built."""
    args = port_train.parse_args(["--device", "cpu", "--model",
                                  "transformer"] + flags)
    with pytest.raises(SystemExit, match=message):
        port_train.check_ported(args)

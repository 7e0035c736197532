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

"""The port's pipeline parallelism (parallel/pipeline.py,
parallel/pipeline_lm.py) on four gloo ranks against the JAX package's
on a CPU submesh of the same (data, pipe) shape: the GPipe and
circular schedules forward and backward (a partial tail group among
them), circular_stage_order, the schedules' errors, the PipelinedLM at
a tiny width against JAX's apply and gradients and against its own
reference_apply, remat, the placement-order refusal; then the driver's
--pipeline-parallelism on the ranks (train, checkpoint, resume) and
each driver resuming the other's pipeline checkpoint.

The JAX schedules compile one program a shape, so this file calls them
on four toy shapes and one LM shape. Inputs are made from numpy seeds;
everything is f32. Tolerances: 2e-5 for the toy outputs, 1e-4 for
gradients and for the LM (absolute and relative), unless an assertion
states another."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from container_engine_accelerators_tpu.parallel import pipeline as jax_pipe
from container_engine_accelerators_tpu.parallel.pipeline_lm import (
    PipelinedLM as JaxPipelinedLM,
)
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.parallel import pipeline
from container_engine_accelerators_tpu_torch.parallel.pipeline_lm import (
    PipelinedLM,
)
from tests import torch_dist_cases as cases
from tests import torch_drivers
from tests.torch_dist_pool import RankPool

N = 4
D = 8
TOL = dict(rtol=2e-5, atol=2e-5)
GTOL = dict(rtol=1e-4, atol=1e-4)
LM = dict(vocab_size=64, embed_dim=32, num_layers=4, num_heads=4,
          max_seq_len=16)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


def _toy(stages, batch, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.standard_normal((stages, D, D)) * 0.5).astype(
                  np.float32),
              "b": (rng.standard_normal((stages, D)) * 0.1).astype(
                  np.float32)}
    return params, rng.standard_normal((batch, D)).astype(np.float32)


def _jax_toy(kind, params, x, pipe, data, m):
    """(outputs, parameter grads in natural order, input grads) of the
    JAX schedule under sum(out ** 2) on a (data, pipe) submesh."""
    mesh = jax_pipe.build_pipeline_mesh(pipe, data=data,
                                        devices=jax.devices()[:pipe * data])
    fn = (jax_pipe.pipeline_apply if kind == "gpipe"
          else jax_pipe.circular_pipeline_apply)

    def stage(w, h):
        return jnp.tanh(h @ w["w"] + w["b"])

    def loss(p, xx):
        out = fn(mesh, stage, p, xx, num_microbatches=m)
        return jnp.sum(out ** 2), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    return (np.asarray(out), jax.tree_util.tree_map(np.asarray, gp),
            np.asarray(gx))


def _assemble(results, data):
    """The global outputs and input gradients from pipe rank 0 of each
    data rank; every pipe rank holds the same."""
    out, gx = [None] * data, [None] * data
    for r in results:
        di, d = r["coord"]
        if d == 0:
            out[di], gx[di] = r["out"], r["x_grad"]
    for r in results:
        di, _ = r["coord"]
        np.testing.assert_array_equal(r["out"], out[di])
        np.testing.assert_array_equal(r["x_grad"], gx[di])
    return np.concatenate(out), np.concatenate(gx)


def _natural_grads(results, params):
    """Every rank's parameter gradients summed into the natural stack
    (a data rank's are its own rows' part of the global loss)."""
    total = {k: np.zeros_like(v) for k, v in params.items()}
    for r in results:
        for k, g in r["grads"].items():
            total[k][r["rows"]] += g
    return total


@pytest.mark.parametrize("kind,stages,pipe,data,m,layout", [
    ("gpipe", 4, 4, 1, 4, "rows"),
    ("gpipe", 2, 2, 2, 3, "rows"),
    ("circular", 8, 4, 1, 6, "rows"),
    ("circular", 4, 2, 2, 2, "whole"),
])
def test_schedule_matches_jax(pool, kind, stages, pipe, data, m, layout):
    """Each schedule's outputs, stage and input gradients against the
    JAX function on the same (data, pipe) shape: GPipe over 4 ranks and
    over a 2 x 2 mesh (3 microbatches), the circular schedule with 2
    laps on 4 ranks and 6 microbatches (a partial tail group: 6 mod 4)
    on its placement rows, and on a 2 x 2 mesh from the whole natural
    stack. Every pipe rank holds the outputs and the input gradient;
    each rank runs its stage M·v times (bubble ticks skip it)."""
    params, x = _toy(stages, 2 * m * data)
    results = pool.run(cases.pipe_toy, kind, params, x, pipe, data, m,
                       layout)
    out, gx = _assemble(results, data)
    want_out, want_gp, want_gx = _jax_toy(kind, params, x, pipe, data, m)
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(gx, want_gx, **GTOL)
    got_gp = _natural_grads(results, params)
    for k in params:
        np.testing.assert_allclose(got_gp[k], want_gp[k], **GTOL)
    v = stages // pipe
    assert [r["calls"] for r in results] == [m * v] * N


def test_circular_stage_order_matches_jax():
    for n, p in ((8, 4), (8, 2), (6, 3), (4, 1), (5, 5)):
        np.testing.assert_array_equal(pipeline.circular_stage_order(n, p),
                                      jax_pipe.circular_stage_order(n, p))
    with pytest.raises(ValueError) as want:
        jax_pipe.circular_stage_order(6, 4)
    with pytest.raises(ValueError, match="do not fold") as got:
        pipeline.circular_stage_order(6, 4)
    assert str(got.value) == str(want.value)


def _jax_error(fn, *args, **kwargs):
    with pytest.raises(ValueError) as e:
        fn(*args, **kwargs)
    return str(e.value)


def test_schedule_errors_match_jax(pool):
    """The microbatch divisibility error (one process) and the stage
    count errors on the ranks, letter for letter as JAX's: 4 stages
    for GPipe on a 2-rank pipe, 3 for the circular schedule."""
    params, x = _toy(2, 3)
    mesh = jax_pipe.build_pipeline_mesh(1, data=1,
                                        devices=jax.devices()[:1])
    want = _jax_error(
        jax_pipe.pipeline_apply, mesh, lambda w, h: h,
        jax.tree_util.tree_map(lambda v: jnp.asarray(v[:1]), params),
        jnp.asarray(x), num_microbatches=2)
    local = {k: torch.from_numpy(v[:1]) for k, v in params.items()}
    with pytest.raises(ValueError, match="not divisible") as got:
        pipeline.pipeline_apply(None, cases._toy_stage, local,
                                torch.from_numpy(x), num_microbatches=2)
    assert str(got.value) == want

    jmesh = jax_pipe.build_pipeline_mesh(2, data=2,
                                         devices=jax.devices()[:4])
    params4, x4 = _toy(4, 8)
    want = _jax_error(jax_pipe.pipeline_apply, jmesh, lambda w, h: h,
                      params4, x4, num_microbatches=2)
    got = pool.run(cases.pipe_toy, "gpipe", params4, x4, 2, 2, 2)
    assert got == [("ValueError", want)] * N
    params3, x3 = _toy(3, 8)
    want = _jax_error(jax_pipe.circular_pipeline_apply, jmesh,
                      lambda w, h: h, params3, x3, num_microbatches=2)
    got = pool.run(cases.pipe_toy, "circular", params3, x3, 2, 2, 2,
                   "whole")
    assert got == [("ValueError", want)] * N


@pytest.fixture(scope="module")
def lm_tree():
    jlm = JaxPipelinedLM(**LM, pipe=2, dtype=jnp.float32)
    params = jlm.init(jax.random.PRNGKey(0))
    return jlm, jax.tree_util.tree_map(np.asarray, params)


def _jax_lm(jlm, tree, tokens, m):
    mesh = jax_pipe.build_pipeline_mesh(2, data=2,
                                        devices=jax.devices()[:4])

    def loss(p):
        logits = jlm.apply(p, jnp.asarray(tokens), mesh=mesh,
                           num_microbatches=m)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        nll = -jnp.take_along_axis(
            logp, jnp.asarray(tokens)[:, 1:, None], axis=-1)
        return jnp.mean(nll), logits

    (value, logits), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, tree))
    return (float(value), np.asarray(logits),
            jax.tree_util.tree_map(np.asarray, grads))


def _lm_tokens():
    return np.random.default_rng(3).integers(
        0, LM["vocab_size"], (4, LM["max_seq_len"])).astype(np.int32)


def test_pipelined_lm_matches_jax(pool, lm_tree):
    """The PipelinedLM on a 2 x 2 (data, pipe) mesh, two layers a rank
    and two microbatches, against JAX's apply on a 2 x 2 submesh: the
    logits, the next-token loss and every gradient (a rank's block rows
    against JAX's placement rows; the replicated leaves on every rank),
    and against its own reference_apply; the clip's global norm over
    every stage against optax's; each rank runs its blocks M·v = 4
    times."""
    jlm, tree = lm_tree
    tokens = _lm_tokens()
    results = pool.run(cases.pipe_lm, LM, tree, tokens, 2, 2, 2)
    want_loss, want_logits, want_grads = _jax_lm(jlm, tree, tokens, 2)
    want_norm = float(optax.global_norm(want_grads))
    for r in results:
        di, d = r["coord"]
        np.testing.assert_allclose(r["logits"], want_logits[2 * di:
                                                            2 * di + 2],
                                   **GTOL)
        np.testing.assert_allclose(r["logits"], r["ref_logits"], **GTOL)
        assert r["loss"] == pytest.approx(want_loss, rel=1e-5)
        rows = r["rows"]
        assert rows == [2 * d, 2 * d + 1]
        got = torch_drivers.flat(r["grads"])
        want = torch_drivers.flat(want_grads)
        assert sorted(got) == sorted(want)
        for key, g in got.items():
            w = want[key][rows] if key.startswith("blocks/") else want[key]
            np.testing.assert_allclose(g, w, err_msg=key, **GTOL)
        assert r["calls"] == 4
        assert r["norm"] == pytest.approx(want_norm, rel=1e-4)


def test_pipelined_lm_remat_and_refusal(pool, lm_tree):
    """remat leaves the logits and gradients of the step without it
    (the stage recomputed, the hops outside the checkpoint); a model
    built for pipe 2 refuses a pipe-4 mesh with JAX's placement-order
    message; a layer count the pipe does not divide is refused with
    JAX's "fold" message."""
    jlm, tree = lm_tree
    tokens = _lm_tokens()
    plain = pool.run(cases.pipe_lm, LM, tree, tokens, 2, 2, 2)
    remat = pool.run(cases.pipe_lm, LM, tree, tokens, 2, 2, 2, remat=True)
    for a, b in zip(plain, remat):
        np.testing.assert_array_equal(a["logits"], b["logits"])
        for key, g in torch_drivers.flat(a["grads"]).items():
            np.testing.assert_array_equal(
                g, torch_drivers.flat(b["grads"])[key], err_msg=key)
    jmesh = jax_pipe.build_pipeline_mesh(4, data=1,
                                         devices=jax.devices()[:4])
    want = _jax_error(jlm.apply, tree, jnp.asarray(tokens), mesh=jmesh,
                      num_microbatches=2)
    got = pool.run(cases.pipe_lm, LM, tree, tokens, 4, 1, 2, model_pipe=2)
    assert got == [("ValueError", want)] * N
    assert "placement order" in want
    want = _jax_error(JaxPipelinedLM, **dict(LM, num_layers=3), pipe=2)
    with pytest.raises(ValueError, match="fold") as e:
        PipelinedLM(**dict(LM, num_layers=3), pipe=2, device="cpu")
    assert str(e.value) == want


def test_pipeline_converters_round_trip(lm_tree):
    """A rank's rows of the JAX tree through pipeline_params_from_flax
    and back are the same arrays; init's tree has the JAX init's paths
    and shapes in placement order (natural stage order[k] at row k);
    the decay mask leaves out exactly the leaves of rank < 2 in the JAX
    tree, where the blocks are stacked (the JAX driver's mask)."""
    from container_engine_accelerators_tpu_torch.parallel import (
        pipeline_lm,
    )
    jlm, tree = lm_tree
    for stage, rows in ((0, [0, 1]), (1, [2, 3])):
        lm = PipelinedLM(**LM, pipe=2, stage=stage, device="cpu")
        lm.load(tree)
        back = torch_drivers.flat(convert.pipeline_params_to_flax(
            dict(lm.named_parameters()), lm.config()))
        want = torch_drivers.flat(tree)
        for key, value in back.items():
            w = want[key][rows] if key.startswith("blocks/") else want[key]
            np.testing.assert_array_equal(value, w, err_msg=key)
    mine = PipelinedLM(**LM, pipe=2, device="cpu")
    init = torch_drivers.flat(mine.init(0))
    assert {k: v.shape for k, v in init.items()} == {
        k: v.shape for k, v in torch_drivers.flat(tree).items()}
    natural = convert.init_flax_layout_params(
        dict(LM, pos_embedding="learned"), 0)
    order = pipeline.circular_stage_order(4, 2)
    np.testing.assert_array_equal(
        init["blocks/Dense_0/kernel"][1],
        natural[f"block{order[1]}"]["Dense_0"]["kernel"])
    mask = pipeline_lm.decay_mask(mine)
    kept = {n for n, p in mine.named_parameters() if not mask(n, p)}
    assert kept == {"ln_f.weight", "ln_f.bias", "lm_head.bias"}
    assert sorted(k for k, v in torch_drivers.flat(tree).items()
                  if v.ndim < 2) == ["lm_head/bias", "ln/bias", "ln/scale"]
    stacked = pipeline.stack_stage_params([
        {"w": torch.full((2,), float(i))} for i in range(3)])
    assert stacked["w"].tolist() == [[0, 0], [1, 1], [2, 2]]


def test_one_rank_pipe_is_the_sequential_fold():
    """With no mesh (a one-rank pipe) the circular schedule runs each
    microbatch through every block in order: its logits equal
    reference_apply's, and so do its gradients."""
    lm = PipelinedLM(**LM, pipe=1, device="cpu", dtype=torch.float32)
    lm.load(lm.init(5))
    tokens = torch.from_numpy(_lm_tokens().astype(np.int64))
    got = lm.apply(tokens, mesh=None, num_microbatches=2)
    got.square().mean().backward()
    grads = {n: p.grad.clone() for n, p in lm.named_parameters()}
    lm.zero_grad()
    want = lm.reference_apply(tokens)
    want.square().mean().backward()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for n, p in lm.named_parameters():
        torch.testing.assert_close(grads[n], p.grad, rtol=1e-4, atol=1e-5)


# -- the driver --------------------------------------------------------------

PP_FLAGS = ["--model", "transformer", "--vocab-size", "64", "--embed-dim",
            "32", "--num-layers", "4", "--num-heads", "4", "--seq-len",
            "16", "--batch-size", "8", "--num-microbatches", "2",
            "--warmup-steps", "1", "--lr-schedule", "cosine"]


def test_driver_pipeline_trains_checkpoints_resumes(pool, tmp_path):
    """--pipeline-parallelism 2 --num-microbatches 2 on the four ranks (a
    2 x 2 (data, pipe) mesh): trains with finite, equal losses on every
    rank, writes checkpoint_3 (rank 0 alone), resumes from it to
    checkpoint_6, and refuses the Trainer-state flags with the demo's
    message."""
    argv = ["--device", "cpu"] + PP_FLAGS + [
        "--pipeline-parallelism", "2", "--steps", "3",
        "--model-dir", str(tmp_path)]
    first = pool.run(cases.pipe_driver, argv)
    result = first[0]["result"]
    assert result["pipeline_parallelism"] == 2
    assert result["num_microbatches"] == 2 and result["devices"] == N
    assert {"images_per_sec", "tokens_per_sec", "final_loss",
            "images_per_sec_per_chip", "global_batch"} <= set(result)
    losses = [r["losses"] for r in first]
    assert all(np.isfinite(x).all() for x in losses)
    assert all(x == losses[0] for x in losses)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_3"]
    pool.run(cases.pipe_driver, argv)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_3", "checkpoint_6"]
    from container_engine_accelerators_tpu_torch import train as port_train
    with pytest.raises(SystemExit, match="does not support --fsdp"):
        port_train.main(argv + ["--fsdp"])


def _demo_pp(argv):
    demo = torch_drivers.demo_train()
    return demo.main(argv)


def test_each_driver_resumes_the_others_pipeline_checkpoint(pool,
                                                             tmp_path):
    """The demo driver's pipeline checkpoint (pipe 2 over the eight
    virtual devices: a 4 x 2 mesh) resumes on the port's 2 x 2 ranks,
    and the port's resumes in the demo driver. Resuming with --steps 0
    re-saves the restored state at the same step: the archive comes
    back the same, leaf for leaf, so each driver reads every leaf of
    the other's where it belongs. A further step then trains on."""
    flags = PP_FLAGS + ["--pipeline-parallelism", "2"]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    # JAX writes, the port resumes.
    _demo_pp(flags + ["--steps", "2", "--model-dir", str(jax_dir)])
    written = torch_drivers.archive(str(jax_dir / "checkpoint_2"))
    pool.run(cases.pipe_driver, ["--device", "cpu"] + flags + [
        "--steps", "0", "--model-dir", str(jax_dir)])
    again = torch_drivers.archive(str(jax_dir / "checkpoint_2"))
    assert sorted(again) == sorted(written)
    for key in written:
        np.testing.assert_array_equal(again[key], written[key],
                                      err_msg=key)
    resumed = pool.run(cases.pipe_driver, ["--device", "cpu"] + flags + [
        "--steps", "1", "--model-dir", str(jax_dir)])
    assert np.isfinite(resumed[0]["losses"]).all()
    assert "checkpoint_3" in os.listdir(jax_dir)
    # The port writes, JAX resumes.
    pool.run(cases.pipe_driver, ["--device", "cpu"] + flags + [
        "--steps", "2", "--model-dir", str(port_dir)])
    written = torch_drivers.archive(str(port_dir / "checkpoint_2"))
    _demo_pp(flags + ["--steps", "0", "--model-dir", str(port_dir)])
    again = torch_drivers.archive(str(port_dir / "checkpoint_2"))
    assert sorted(again) == sorted(written)
    for key in written:
        np.testing.assert_array_equal(again[key], written[key],
                                      err_msg=key)
    result = _demo_pp(flags + ["--steps", "1", "--model-dir",
                               str(port_dir)])
    assert np.isfinite(result["final_loss"])
    assert "checkpoint_3" in os.listdir(port_dir)

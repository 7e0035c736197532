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


"""The port's trainer against the JAX Trainer and the demo driver.

Weights come from the flax init (tests/torch_parity.py) through
models/convert.py; three SGD steps of the port's Trainer run beside
three steps of the JAX Trainer on a 1x1 mesh, with the demo's own
``build_tx`` (demo/tpu-training/train.py, loaded by path) and the same
token batches, in f32. The loss is compared at every step, and every
parameter after the last one in the flax layout (``params_to_flax``).
Tolerances: loss 1e-5 relative, parameters 1e-5 absolute + 1e-4
relative (f32 summation order through two layers' forward and
backward, three updates with momentum).
"""

import functools
import importlib.util
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
from jax.sharding import Mesh

from container_engine_accelerators_tpu.models import transformer as jax_tf
from container_engine_accelerators_tpu.ops import (
    mean_cross_entropy_loss as jax_mean_xent,
)
from container_engine_accelerators_tpu.parallel import Trainer as JaxTrainer
from container_engine_accelerators_tpu.parallel.data import (
    SyntheticTokenLoader as JaxTokenLoader,
)
from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import transformer
from container_engine_accelerators_tpu_torch.ops import attention, xent
from container_engine_accelerators_tpu_torch.parallel import (
    Sgd,
    SyntheticTokenLoader,
    Trainer,
)
from container_engine_accelerators_tpu_torch.utils import wall_sync
from tests import torch_parity

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ = 4, 16


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _demo():
    """demo/tpu-training/train.py, loaded by path."""
    path = os.path.join(REPO_ROOT, "demo", "tpu-training", "train.py")
    spec = importlib.util.spec_from_file_location("_demo_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _argv(*extra):
    return ["--model", "transformer", "--seq-len", str(SEQ),
            "--batch-size", str(BATCH), *extra]


def _one_by_one_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))


def _flat(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(tree[key])


@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_three_steps_match_the_jax_trainer(variant):
    model, tree, config = torch_parity.flax_lm(variant, "f32")
    argv = _argv("--steps", "3")
    # JAX: the demo's optimizer, the Pallas loss, a 1x1 mesh.
    jax_loss = jax_tf.next_token_loss_fn(functools.partial(
        jax_mean_xent, label_smoothing=0.0))
    jax_trainer = JaxTrainer(jax_tf.make_apply_fn(model), jax_loss,
                             _demo().build_tx(_demo().parse_args(argv)),
                             mesh=_one_by_one_mesh(), donate_state=False)
    jax_state = jax_trainer.init_state(
        {"params": jax.tree_util.tree_map(jnp.asarray, tree)})
    # The port: the same weights, f32 parameters and compute.
    port = convert.load_lm(config, tree, device="cpu",
                           dtype=torch.float32, trainable=True)
    args = port_train.parse_args(argv + ["--device", "cpu"])
    port_loss = transformer.next_token_loss_fn(functools.partial(
        xent.mean_cross_entropy_loss, label_smoothing=0.0))
    trainer = Trainer(port, port_loss, port_train.build_tx(args, config))
    state = trainer.init_state()
    jax_batches = JaxTokenLoader(BATCH, SEQ, config["vocab_size"], pool=2)
    port_batches = SyntheticTokenLoader(BATCH, SEQ, config["vocab_size"],
                                        device="cpu", pool=2)
    for _ in range(3):
        jax_state, want = jax_trainer.train_step(jax_state,
                                                 next(jax_batches))
        state, got = trainer.train_step(state, next(port_batches))
        assert got.dim() == 0 and not got.requires_grad
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert state.step == 3
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jax_state.params)))
    got = dict(_flat(convert.params_to_flax(state.model, config)))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # The weights moved: the comparison is not of the initial tree.
    moved = dict(_flat(tree))
    assert any(np.abs(got[n] - moved[n]).max() > 1e-4 for n in got)


@pytest.mark.parametrize("variant", sorted(torch_parity.VARIANTS))
def test_decay_mask_follows_the_flax_ranks(variant):
    """The demo decays every leaf of rank >= 2 in the flax tree, the
    attention biases included (rank 2-3 there, rank 1 in torch); norm
    scales and the other biases are not decayed."""
    _, tree, config = torch_parity.flax_lm(variant, "f32")
    port = convert.load_lm(config, tree, device="cpu", trainable=True)
    args = port_train.parse_args(_argv("--device", "cpu"))
    opt = port_train.build_tx(args, config).init(port)
    names = {id(p): n for n, p in port.named_parameters()}
    decayed = {names[id(p)] for g in opt.param_groups
               if g["weight_decay"] > 0 for p in g["params"]}
    bias = ("blocks.0.attn.qkv.bias" if config["num_kv_heads"] is None
            else "blocks.0.attn.kv.bias")
    assert bias in decayed and port.get_parameter(bias).dim() == 1
    assert "blocks.0.attn.ln.weight" not in decayed
    assert "blocks.0.attn.proj.bias" not in decayed
    # Leaf for leaf, the demo's optax mask on the flax tree.
    flax_mask = dict(_flat(jax.tree_util.tree_map(
        lambda p: np.asarray(p.ndim >= 2), tree)))
    shapes = convert.flax_shapes(config)
    for name, _ in port.named_parameters():
        path = "/".join(shapes[name][0])
        assert bool(flax_mask[path]) == (name in decayed), name


@pytest.mark.parametrize("extra", [
    ("--lr-schedule", "cosine", "--lr-warmup-steps", "2"),
    ("--lr-schedule", "linear", "--lr-warmup-steps", "2"),
    ("--lr-schedule", "cosine", "--grad-clip", "0.5"),
    ("--lr-schedule", "linear", "--grad-clip", "1e3"),
    ("--grad-clip", "0.5", "--momentum", "0.0"),
])
def test_optimizer_matches_optax(extra):
    """Six updates with the same gradients through the demo's optax
    chain and the port's Sgd: schedules, clip, decay mask, momentum."""
    _, tree, config = torch_parity.flax_lm("rope_gqa", "f32")
    argv = _argv("--steps", "6", *extra)
    tx = _demo().build_tx(_demo().parse_args(argv))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    port = convert.load_lm(config, tree, device="cpu", trainable=True)
    sgd = port_train.build_tx(port_train.parse_args(argv), config)
    opt = sgd.init(port)
    rng = np.random.default_rng(0)
    for count in range(6):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 0.3).astype(
                np.float32), tree)
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, g in convert.params_from_flax(grads).items():
            port.get_parameter(name).grad = g
        sgd.update(opt, count)
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, params)))
    got = dict(_flat(convert.params_to_flax(port, config)))
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_schedules_match_optax():
    for warmup, steps in ((0, 10), (3, 10), (5, 5)):
        ours = port_train.join_schedules(
            [port_train.linear_schedule(0.0, 0.1, warmup),
             port_train.cosine_decay_schedule(
                 0.1, max(steps, warmup + 1) - warmup)], [warmup])
        theirs = optax.warmup_cosine_decay_schedule(
            0.0, 0.1, warmup, max(steps, warmup + 1))
        for count in range(steps + 3):
            assert abs(ours(count) - float(theirs(count))) < 1e-7


def test_params_to_flax_inverts_params_from_flax():
    for variant in sorted(torch_parity.VARIANTS):
        _, tree, config = torch_parity.flax_lm(variant)
        back = convert.params_to_flax(convert.params_from_flax(tree),
                                      config)
        want, got = dict(_flat(tree)), dict(_flat(back))
        assert set(got) == set(want)
        for name in want:
            assert got[name].shape == want[name].shape
            np.testing.assert_array_equal(got[name], want[name])
    with pytest.raises(ValueError, match="names differ"):
        convert.params_to_flax({"x": torch.zeros(1)}, config)


def test_trainable_weights_are_f32_and_serving_weights_bf16():
    _, tree, config = torch_parity.flax_lm("rope_gqa")
    train_model = convert.load_lm(config, tree, device="cpu",
                                  trainable=True)
    serve_model = convert.load_lm(config, tree, device="cpu")
    assert train_model.training and not serve_model.training
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train_model.parameters())
    assert serve_model.blocks[0].attn.q.weight.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in serve_model.parameters())
    toks = torch.from_numpy(torch_parity.tokens(0, (2, 8))).long()
    with torch.no_grad():
        # Cast at use: the same bf16 arithmetic either way.
        torch.testing.assert_close(train_model(toks), serve_model(toks),
                                   rtol=0, atol=0)


def test_attention_fn_replaces_the_flash_attention():
    _, tree, config = torch_parity.flax_lm("learned_mha")
    calls = []

    def plain(q, k, v, causal):
        calls.append(q.shape)
        return attention.flash_attention_reference(q, k, v, causal)[0]

    model = convert.load_lm(config, tree, device="cpu",
                            dtype=torch.float32, attention_fn=plain)
    base = convert.load_lm(config, tree, device="cpu", dtype=torch.float32)
    toks = torch.from_numpy(torch_parity.tokens(1, (2, 8))).long()
    torch.testing.assert_close(model(toks), base(toks), rtol=0, atol=0)
    assert len(calls) == config["num_layers"]


def test_token_loader_matches_jax_and_stays_put():
    ours = SyntheticTokenLoader(3, 5, 50, device="cpu", pool=2)
    theirs = JaxTokenLoader(3, 5, 50, pool=2)
    seen = []
    for _ in range(3):
        (a, b), (c, _) = next(ours), next(theirs)
        assert a is b and a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        seen.append(a)
    assert seen[2] is seen[0]  # the pool cycles; no new batch is made


def test_wall_sync_reads_the_first_tensor():
    assert wall_sync(torch.tensor([3.5, 1.0])) == 3.5
    assert wall_sync({"a": torch.zeros(0), "b": [torch.tensor([2])]}) == 2
    assert wall_sync([]) is None
    layer = torch.nn.Linear(2, 1)
    assert wall_sync(layer) == float(layer.weight.detach().reshape(-1)[0])


@pytest.mark.parametrize("option", [
    dict(mesh=object()), dict(fsdp=True), dict(straggler=object()),
    dict(mfu_source="auto"), dict(donate_state=False)])
def test_unported_trainer_options_raise(option):
    with pytest.raises(ValueError, match="not yet ported"):
        Trainer(torch.nn.Linear(2, 2), None, Sgd(0.1), **option)


def _lm_trainer(**option):
    _, tree, config = torch_parity.flax_lm("rope_gqa", "f32")
    model = convert.load_lm(config, tree, device="cpu",
                            dtype=torch.float32, trainable=True)
    loss = transformer.next_token_loss_fn(xent.mean_cross_entropy_loss)
    trainer = Trainer(model, loss, Sgd(0.1, momentum=0.9), **option)
    batches = SyntheticTokenLoader(BATCH, SEQ, config["vocab_size"],
                                   device="cpu")
    return trainer, trainer.init_state(), batches


@pytest.mark.parametrize("option", [
    dict(remat=True), dict(grad_accum=2),
    dict(augment_fn=lambda generator, x: x), dict(ema_decay=0.9)])
def test_ported_trainer_options_train_the_lm(option):
    """Each option the image slice ported also runs the LM's step
    (flash attention under remat's recomputation, the chunked batch,
    an augmentation that leaves tokens alone, the EMA shadow) and
    leaves the first step's loss as the plain step gives it."""
    trainer, state, batches = _lm_trainer(**option)
    plain, plain_state, plain_batches = _lm_trainer()
    for _ in range(2):
        state, loss = trainer.train_step(state, next(batches))
        plain_state, want = plain.train_step(plain_state,
                                             next(plain_batches))
        assert loss.dim() == 0 and torch.isfinite(loss)
        np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert state.step == 2
    if "ema_decay" in option:
        assert set(state.ema) == {n for n, _ in
                                  state.model.named_parameters()}


def test_eval_step_gives_the_lm_logits():
    trainer, state, batches = _lm_trainer()
    tokens = next(batches)[0]
    logits = trainer.eval_step(state, tokens)
    with torch.no_grad():
        want = state.model(tokens)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    assert not logits.requires_grad and state.model.training
    assert state.batch_stats == {}


@pytest.mark.parametrize("flags", [
    ["--model", "moe"], ["--attention-window", "64"],
    ["--model-parallelism", "2"], ["--context-parallelism", "2"],
    ["--attention", "ring"], ["--expert-parallelism", "2"],
    ["--pipeline-parallelism", "2"], ["--dcn-granules", "2"], ["--fsdp"],
    ["--data-dir", "d"], ["--model-dir", "m"], ["--profile-dir", "p"]])
def test_unported_flags_raise(flags):
    argv = ["--device", "cpu", "--model", "transformer"] + flags
    with pytest.raises(ValueError, match="not yet ported"):
        port_train.main(argv)


@pytest.mark.parametrize("flags", [
    ["--model", "resnet", "--depth", "18", "--image-size", "16",
     "--num-classes", "10"],
    ["--model", "mnist"],
    ["--model", "inception", "--image-size", "75", "--num-classes", "10"],
    ["--remat"], ["--grad-accum", "2"], ["--ema-decay", "0.99"],
    ["--augment"], ["--eval-batches", "2"]])
def test_ported_flags_train(flags, capsys):
    """The flags this slice ported run through the driver: the image
    models, and remat, accumulation, EMA, augmentation (the LM ignores
    it with a message) and eval on the LM."""
    argv = ["--device", "cpu", "--model", "transformer", "--vocab-size",
            "32", "--embed-dim", "16", "--num-layers", "1", "--num-heads",
            "2", "--seq-len", "8", "--batch-size", "2", "--steps", "2",
            "--warmup-steps", "1"] + flags
    result = port_train.main(argv)
    assert np.isfinite(result["final_loss"]) and result["steps"] == 2
    err = capsys.readouterr().err
    if flags == ["--augment"]:
        assert "--augment only applies to image models" in err
    if flags == ["--eval-batches", "2"]:
        assert 0.0 <= result["eval_accuracy"] <= 1.0


def test_cpu_run_prints_the_result_line_and_the_loss_falls():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MODEL_DIR")}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "container_engine_accelerators_tpu_torch.train",
         "--model", "transformer", "--device", "cpu", "--vocab-size", "64",
         "--embed-dim", "32",
         "--num-layers", "2", "--num-heads", "4", "--num-kv-heads", "2",
         "--pos-embedding", "rope", "--seq-len", "16", "--batch-size", "4",
         "--steps", "21", "--warmup-steps", "1", "--lr", "0.05"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    for key in ("model", "devices", "global_batch", "steps",
                "images_per_sec", "images_per_sec_per_chip",
                "tokens_per_sec", "final_loss", "kernel_launches"):
        assert key in result
    assert result["model"] == "transformer" and result["steps"] == 21
    losses = [float(line.split()[-1]) for line in proc.stderr.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2  # steps 0 and 20 (also the last)
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert set(result["kernel_launches"].values()) == {0}  # plain on cpu


def test_on_step_hook_sees_every_step():
    seen = []
    result = port_train.main(
        ["--model", "transformer", "--device", "cpu", "--vocab-size", "32",
         "--embed-dim", "16", "--num-layers", "1", "--num-heads", "2",
         "--seq-len", "8",
         "--batch-size", "2", "--steps", "3", "--warmup-steps", "1"],
        on_step=lambda step, loss: seen.append((step, loss)))
    assert [step for step, _ in seen] == [0, 1, 2]
    assert all(loss.dim() == 0 for _, loss in seen)
    assert result["final_loss"] == float(seen[-1][1])


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_train.main(["--model", "transformer", "--seq-len", "8",
                         "--batch-size", "1",
                         "--vocab-size", "16", "--embed-dim", "16",
                         "--num-layers", "1", "--num-heads", "2",
                         "--steps", "1"])


@pytest.mark.parametrize("kernel,label", [
    ("void (anonymous namespace)::flash_fwd_tc_kernel<64>("
     "(anonymous namespace)::Params)", "flash_fwd"),
    ("void (anonymous namespace)::flash_fwd_f32_kernel<128>("
     "(anonymous namespace)::Params)", "flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<__nv_bfloat16, 64>("
     "(anonymous namespace)::Params)", "flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dq_tc_kernel<64>("
     "(anonymous namespace)::Params)", "flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dq_tc_kernel<128>("
     "(anonymous namespace)::Params)", "flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dq_kernel<64>("
     "(anonymous namespace)::Params)", "flash_bwd_dq"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<128>("
     "(anonymous namespace)::Params)", "flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dkv_tc_kernel<64>("
     "(anonymous namespace)::Params)", "flash_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<float, 64>("
     "(anonymous namespace)::Params)", "flash_bwd_dkv"),
    ("void (anonymous namespace)::xent_bwd_kernel<float>(...)", "xent_bwd"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "matmul"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_kernel__5x_cudnn",
     "convolution"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_kernel__5x_cudnn",
     "convolution"),
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_execute_kernel__5x_cudnn",
     "convolution"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
     "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>(...)",
     "convolution"),
])
def test_profile_names_each_kernel_of_the_port(kernel, label):
    """The step profile files every flash kernel of the port (the
    tensor-core and the FMA ones) under its wrapper's name, and cuDNN's
    convolutions (forward, data and weight gradients, their layout
    transforms) under convolution, not under the matrix products."""
    from container_engine_accelerators_tpu_torch import train_profile
    assert train_profile.category(kernel) == label

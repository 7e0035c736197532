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

"""Image-classification training in the port against the JAX Trainer
(on a 1x1 ("data", "model") mesh) and the demo driver.

The same flax-layout weights (``tests/torch_parity.py``) and the same
synthetic batches go through both, in f32, with the demo's ``build_tx``
(SGD, momentum 0.9, weight decay 1e-4 on rank >= 2 leaves) and the
fused loss (the Pallas kernel in interpret mode on the JAX side, the
plain version on the port's). Tolerances: losses 1e-5 relative; every
gradient, parameter and EMA leaf 1e-4 relative L2; every ``batch_stats``
leaf 1e-5 of its largest value; eval logits 1e-4 of the largest. The
images are 33x33 (ResNet-18 at width 8): at 32x32 the last stage's maps
are 1x1 and batch-2 BN statistics over 2 values a channel amplify f32
summation-order differences (``tests/test_torch_resnet.py``).
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
import pytest
import torch
from jax.sharding import Mesh

from container_engine_accelerators_tpu.models.resnet import (
    make_apply_fn as resnet_apply_fn,
)
from container_engine_accelerators_tpu.models.common import (
    make_stateless_apply_fn,
)
from container_engine_accelerators_tpu.ops import (
    mean_cross_entropy_loss as jax_mean_xent,
)
from container_engine_accelerators_tpu.parallel import Trainer as JaxTrainer
from container_engine_accelerators_tpu.parallel import data as jax_data
from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models.layers import Dropout
from container_engine_accelerators_tpu_torch.ops import augment
from container_engine_accelerators_tpu_torch.ops import xent
from container_engine_accelerators_tpu_torch.parallel import (
    Sgd,
    SyntheticLoader,
    Trainer,
)
from container_engine_accelerators_tpu_torch.parallel import data
from container_engine_accelerators_tpu_torch.utils import step_generator
from tests import torch_parity

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SIZE = 4, 33
SHAPES = {"resnet18": (SIZE, SIZE, 3), "mlp": (28, 28, 1)}


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


def _argv(kind, *extra):
    model = "mnist" if kind == "mlp" else "resnet"
    return ["--model", model, "--batch-size", str(BATCH), *extra]


def _flat(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(tree[key], np.float32)


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_tree_close(got, want, tol, what, norm="l2"):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want), what
    for name in want:
        if norm == "l2":
            err = _rel_l2(got[name], want[name])
        else:
            err = float(np.abs(got[name] - want[name]).max()
                        / max(np.abs(want[name]).max(), 1e-30))
        assert err <= tol, f"{what} {name}: {err}"


def _batches(kind, steps):
    loader = jax_data.SyntheticLoader(BATCH, SHAPES[kind], 10, pool=2)
    return [next(loader) for _ in range(steps)]


@functools.lru_cache(maxsize=None)
def _jax_run(kind, steps, grad_accum=1, ema_decay=0.0):
    """The JAX Trainer's steps on the tiny model: losses, then params,
    batch_stats and ema_params as numpy trees, the first step's
    gradients (no accumulation only) and the eval logits of the first
    batch after the last step."""
    model, tree, _ = torch_parity.flax_image(kind)
    apply_fn = (make_stateless_apply_fn(model) if kind == "mlp"
                else resnet_apply_fn(model))
    tx = _demo().build_tx(_demo().parse_args(_argv(kind)))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    trainer = JaxTrainer(apply_fn, jax_mean_xent, tx, mesh=mesh,
                         donate_state=False, grad_accum=grad_accum,
                         ema_decay=ema_decay)
    variables = jax.tree_util.tree_map(jnp.asarray, tree)
    state = trainer.init_state(variables)
    batches = _batches(kind, steps)
    out = {}
    if grad_accum == 1:
        def loss(params, images, labels):
            logits, _ = apply_fn({**variables, "params": params}, images,
                                 True)
            return jax_mean_xent(logits, labels)
        out["grads"] = jax.jit(jax.grad(loss))(state.params, *batches[0])
    losses = []
    for batch in batches:
        state, value = trainer.train_step(state, batch)
        losses.append(float(value))
    out.update(losses=losses, params=state.params,
               batch_stats=state.batch_stats, ema_params=state.ema_params,
               eval_logits=trainer.eval_step(state, batches[0][0]))
    return jax.tree_util.tree_map(np.asarray, out)


def _port_run(kind, steps, **options):
    """The port's Trainer over the same weights and batches: (losses,
    trainer, state, first step's gradients as a flax params tree)."""
    _, _, port = torch_parity.flax_image(kind)
    args = port_train.parse_args(_argv(kind, "--device", "cpu"))
    trainer = Trainer(port.train(), xent.mean_cross_entropy_loss,
                      port_train.build_tx(args), **options)
    state = trainer.init_state()
    losses, grads = [], None
    for images, labels in _batches(kind, steps):
        batch = (torch.from_numpy(np.array(images)),
                 torch.from_numpy(np.array(labels)))
        state, loss = trainer.train_step(state, batch)
        assert loss.dim() == 0 and not loss.requires_grad
        losses.append(float(loss))
        if grads is None:
            grads = {n: p.grad.detach().clone()
                     for n, p in port.named_parameters()}
    grad_model = torch_parity.port_image_model(kind)
    grad_model.load_state_dict({**port.state_dict(), **grads})
    grads = convert.image_variables_to_flax(grad_model)["params"]
    return losses, trainer, state, grads


def _port_variables(state):
    return convert.image_variables_to_flax(state.model)


@pytest.mark.parametrize("kind", ["resnet18", "mlp"])
def test_one_sgd_step_matches_the_jax_trainer(kind):
    """Loss, every gradient, every updated parameter and every running
    statistic after one step of the demo's optimizer."""
    want = _jax_run(kind, 1)
    losses, _, state, grads = _port_run(kind, 1)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    _assert_tree_close(grads, want["grads"], 1e-4, "gradient")
    got = _port_variables(state)
    _assert_tree_close(got["params"], want["params"], 1e-4, "param")
    if kind == "resnet18":
        _assert_tree_close(got["batch_stats"], want["batch_stats"], 1e-5,
                           "batch_stats", norm="max")
    # The weights moved: the comparison is not of the starting tree.
    start = dict(_flat(torch_parity.flax_image(kind)[1]["params"]))
    assert any(_rel_l2(v, start[n]) > 1e-3
               for n, v in _flat(got["params"]))


def test_grad_accum_matches_the_jax_trainer():
    """grad_accum=2 (with EMA on, as the same run's other tests read):
    two steps' losses, the parameters and the statistics after both
    chunks of both steps."""
    want = _jax_run("resnet18", 2, grad_accum=2, ema_decay=0.9)
    losses, _, state, _ = _port_run("resnet18", 2, grad_accum=2,
                                    ema_decay=0.9)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    got = _port_variables(state)
    _assert_tree_close(got["params"], want["params"], 1e-4, "param")
    _assert_tree_close(got["batch_stats"], want["batch_stats"], 1e-5,
                       "batch_stats", norm="max")


def test_ema_matches_the_jax_trainer():
    """Two steps with ema_decay=0.9: the shadow is e*d + p*(1-d) after
    each update, seeded from the parameters."""
    want = _jax_run("resnet18", 2, grad_accum=2, ema_decay=0.9)
    _, trainer, state, _ = _port_run("resnet18", 2, grad_accum=2,
                                     ema_decay=0.9)
    shadow = torch_parity.port_image_model("resnet18")
    shadow.load_state_dict({**state.model.state_dict(),
                            **trainer.eval_params(state)})
    _assert_tree_close(convert.image_variables_to_flax(shadow)["params"],
                       want["ema_params"], 1e-4, "ema")
    assert trainer.eval_params(state) is state.ema
    live = dict(state.model.named_parameters())
    assert not torch.equal(state.ema["head.weight"], live["head.weight"])


def test_eval_step_matches_the_jax_trainer():
    """Eval mode on the EMA weights and the running statistics, no
    gradient; the model goes back to train mode."""
    want = _jax_run("resnet18", 2, grad_accum=2, ema_decay=0.9)
    _, trainer, state, _ = _port_run("resnet18", 2, grad_accum=2,
                                     ema_decay=0.9)
    images = torch.from_numpy(np.array(_batches("resnet18", 1)[0][0]))
    stats = {n: b.clone() for n, b in state.model.named_buffers()}
    logits = trainer.eval_step(state, images)
    assert not logits.requires_grad and state.model.training
    got, ref = logits.numpy(), want["eval_logits"]
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    for name, buf in state.model.named_buffers():
        assert torch.equal(buf, stats[name]), name


def test_ensure_ema_seeds_the_shadow():
    model = torch.nn.Linear(3, 2)
    trainer = Trainer(model, None, Sgd(0.1), ema_decay=0.5)
    state = trainer.init_state()
    state.ema = None
    state = trainer.ensure_ema(state)
    assert set(state.ema) == {"weight", "bias"}
    assert torch.equal(state.ema["weight"], model.weight)
    assert state.ema["weight"] is not model.weight
    plain = Trainer(model, None, Sgd(0.1))
    assert plain.ensure_ema(plain.init_state()).ema is None


def test_grad_accum_refuses_an_indivisible_batch():
    _, _, port = torch_parity.flax_image("mlp")
    trainer = Trainer(port, xent.mean_cross_entropy_loss, Sgd(0.1),
                      grad_accum=3)
    batch = next(SyntheticLoader(4, (28, 28, 1), 10, device="cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        trainer.train_step(trainer.init_state(), batch)


class _StepRecorder(torch.nn.Module):
    """A model that takes a step (as Inception's dropout does) and
    records each one it is given."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(3, 2)
        self.steps = []

    def forward(self, x, step=0):
        self.steps.append(int(step))
        return self.lin(x)


def test_each_chunk_sees_its_own_virtual_step():
    model = _StepRecorder()
    trainer = Trainer(model, xent.mean_cross_entropy_loss, Sgd(0.1),
                      grad_accum=2)
    state = trainer.init_state()
    batch = (torch.randn(4, 3), torch.tensor([0, 1, 1, 0]))
    for _ in range(2):
        state, _ = trainer.train_step(state, batch)
    # step * grad_accum + idx, as the JAX scan hands its chunks.
    assert model.steps == [0, 1, 2, 3]


@pytest.mark.parametrize("kind,options", [
    ("resnet18", {}), ("resnet18", {"grad_accum": 2}),
    ("inception", {})])
def test_remat_gives_the_step_without_it(kind, options):
    """Loss, gradients, parameters and running statistics bitwise equal
    with and without remat: the recomputed forward normalises as the
    first one did but leaves the statistics alone, and Inception's
    dropout (rate 0.2) draws the same mask from its step."""
    shape = SHAPES.get(kind, (75, 75, 3))
    images, labels = jax_data.synthetic_batch(4, shape, 10, seed=3)
    runs = []
    for remat in (False, True):
        _, _, port = torch_parity.flax_image(kind)
        trainer = Trainer(port.train(), xent.mean_cross_entropy_loss,
                          Sgd(0.1, momentum=0.9), remat=remat, **options)
        state = trainer.init_state()
        state, loss = trainer.train_step(
            state, (torch.from_numpy(images), torch.from_numpy(labels)))
        grads = {n: p.grad.clone() for n, p in port.named_parameters()}
        runs.append((loss, grads, port.state_dict()))
    (loss0, grads0, sd0), (loss1, grads1, sd1) = runs
    assert torch.equal(loss0, loss1)
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
    for name in sd0:
        assert torch.equal(sd0[name], sd1[name]), name
    start = torch_parity._image_variables(kind, 0)["batch_stats"]
    moved = convert.image_variables_to_flax(port)["batch_stats"]
    assert any(not np.array_equal(a, b) for (_, a), (_, b) in
               zip(_flat(moved), _flat(start)))


def test_synthetic_loader_matches_jax_and_stays_put():
    ours = SyntheticLoader(3, (5, 6, 2), 7, device="cpu", pool=2)
    theirs = jax_data.SyntheticLoader(3, (5, 6, 2), 7, pool=2)
    seen = []
    for _ in range(3):
        (a, b), (c, d) = next(ours), next(theirs)
        assert a.dtype == torch.float32 and b.dtype == torch.int32
        assert a.shape == (3, 5, 6, 2)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
        np.testing.assert_array_equal(b.numpy(), np.asarray(d))
        seen.append(a)
    assert seen[2] is seen[0]
    for step in (0, 5):
        for got, want in zip(
                data.synthetic_step_batch(step, 2, (4, 4, 3), 10, seed=9),
                jax_data.synthetic_step_batch(step, 2, (4, 4, 3), 10,
                                              seed=9)):
            np.testing.assert_array_equal(got, want)


def test_augment_matches_jax_with_injected_decisions():
    """Crop (reflect pad, then the window at each image's offsets) and
    flip, with the decisions handed in, against jnp.pad(mode="reflect"),
    lax.dynamic_slice and the flip of the JAX functions."""
    rng = np.random.default_rng(0)
    images = rng.standard_normal((5, 8, 7, 3)).astype(np.float32)
    pad = 3
    offsets = rng.integers(0, 2 * pad + 1, (2, 5))
    mask = np.array([True, False, True, True, False])
    padded = jnp.pad(images, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                     mode="reflect")
    want = np.stack([np.asarray(jax.lax.dynamic_slice(
        padded[i], (int(offsets[0, i]), int(offsets[1, i]), 0), (8, 7, 3)))
        for i in range(5)])
    got = augment.random_crop(None, torch.from_numpy(images), pad,
                              offsets=torch.from_numpy(offsets))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.where(mask[:, None, None, None], want[:, :, ::-1, :], want)
    got = augment.random_flip(None, got, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_is_keyed_by_the_step():
    """The same step gives the same augmentation, another step another;
    offsets fall in [0, 2 * padding]; about half the images flip."""
    fn = augment.make_augment_fn(flip=True, crop_padding=4)
    assert augment.make_augment_fn(flip=False, crop_padding=0) is None
    images = torch.randn(64, 16, 16, 3)
    first = fn(step_generator(17, 3, "cpu"), images)
    again = fn(step_generator(17, 3, "cpu"), images)
    other = fn(step_generator(17, 4, "cpu"), images)
    assert torch.equal(first, again) and not torch.equal(first, other)
    offsets = augment.crop_offsets(step_generator(17, 0, "cpu"), 4000, 4,
                                   "cpu")
    assert offsets.min() == 0 and offsets.max() == 8
    flips = augment.flip_mask(step_generator(17, 0, "cpu"), 4000, "cpu")
    assert abs(flips.float().mean().item() - 0.5) < 0.04  # 5 sigma
    # Inside the Trainer: the step's generator, train steps only.
    seen = []

    def record(generator, batch):
        seen.append(torch.rand(1, generator=generator).item())
        return batch

    model = torch.nn.Linear(3, 2)
    trainer = Trainer(model, xent.mean_cross_entropy_loss, Sgd(0.1),
                      augment_fn=record)
    state = trainer.init_state()
    batch = (torch.randn(4, 3), torch.tensor([0, 1, 1, 0]))
    state, _ = trainer.train_step(state, batch)
    trainer.eval_step(state, batch[0])
    state.step = 0
    trainer.train_step(state, batch)
    assert len(seen) == 2 and seen[0] == seen[1]


def test_dropout_keeps_its_share_and_scale():
    """rate 0 passes the input through (exact parity with flax); at 0.2
    about 80% of the values survive, each scaled by 1/0.8; eval mode
    passes through; the same generator seed repeats the mask."""
    x = torch.rand(200, 500) + 0.5
    assert Dropout(0.0).train()(x, None) is x
    drop = Dropout(0.2).train()
    y = drop(x, step_generator(0, 1, "cpu"))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.8) < 5 * (0.16 / 1e5) ** 0.5
    torch.testing.assert_close(y[kept], (x / 0.8)[kept], rtol=0, atol=0)
    assert torch.equal(y, drop(x, step_generator(0, 1, "cpu")))
    assert not torch.equal(y, drop(x, step_generator(0, 2, "cpu")))
    assert drop.eval()(x, None) is x


def test_image_decay_mask_matches_the_demo():
    """Conv and Dense kernels decay (rank >= 2 in flax and in torch), BN
    scales and biases do not."""
    for kind in ("resnet18", "mlp"):
        _, _, port = torch_parity.flax_image(kind)
        args = port_train.parse_args(_argv(kind, "--device", "cpu"))
        opt = port_train.build_tx(args).init(port)
        names = {id(p): n for n, p in port.named_parameters()}
        decayed = {names[id(p)] for g in opt.param_groups
                   if g["weight_decay"] > 0 for p in g["params"]}
        layout = convert.image_layout(port)
        for name, _ in port.named_parameters():
            flax_rank = len(layout[name][2])
            assert (name in decayed) == (flax_rank >= 2), name
        assert "head.weight" in decayed or "Dense_2.weight" in decayed


@pytest.mark.parametrize("flags", [
    ["--model", "resnet", "--depth", "18", "--image-size", "32",
     "--num-classes", "10"],
    ["--model", "mnist"],
    ["--model", "inception", "--image-size", "75", "--num-classes", "10"]])
def test_driver_trains_each_image_model(flags, capsys):
    result = port_train.main(["--device", "cpu", "--batch-size", "4",
                              "--steps", "3", "--warmup-steps", "1",
                              "--eval-batches", "1", *flags])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert result["model"] == flags[1] and result["steps"] == 3
    assert result["depth"] == (18 if flags[1] == "resnet" else None)
    assert "tokens_per_sec" not in result
    assert np.isfinite(result["final_loss"])
    assert 0.0 <= result["eval_accuracy"] <= result["eval_top5_accuracy"]
    assert set(result["kernel_launches"].values()) == {0}  # plain on cpu


def test_driver_command_line_prints_the_result_line():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MODEL_DIR")}
    env["OMP_NUM_THREADS"] = "2"
    proc = subprocess.run(
        [sys.executable, "-m", "container_engine_accelerators_tpu_torch.train",
         "--model", "resnet", "--device", "cpu", "--depth", "18",
         "--image-size", "32", "--num-classes", "10", "--batch-size", "4",
         "--steps", "3", "--warmup-steps", "1"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["model"] == "resnet" and result["depth"] == 18
    assert result["global_batch"] == 4 and result["images_per_sec"] > 0

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

"""The port's image models against the flax ones: ResNet (18, 50),
the MNIST MLP and Inception-v3, their building blocks, the converter
and the numpy initializers.

Weights: ``tests/torch_parity.py``'s tiny configurations, the same
flax-layout tree on both sides. Tolerances, relative to the largest
reference value: eval-mode logits f32 1e-4, bf16 2e-2 (8-bit
mantissas through every layer). Train mode, where each BN normalises
by its batch: ResNet-18 at 33x33, batch 2, logits and every updated
``batch_stats`` leaf at 1e-5; ResNet-50 (16 blocks) at 33x33, batch 8,
and Inception-v3 (94 BNs) at 75x75, batch 8, looser as each test says.
There BN's E[x^2] - E[x]^2 over the last stage's 8-32 values a channel
turns f32 summation-order differences into larger ones layer by layer
(batch 2 at 1x1 maps reaches 5e-2 in Inception); a wrong window, pad,
name or statistic moves the result by O(1), in either mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import flax.linen as nn
import torch

from container_engine_accelerators_tpu.models.resnet import (
    BasicBlock,
    BottleneckBlock,
)
from container_engine_accelerators_tpu_torch.models import convert, layers
from container_engine_accelerators_tpu_torch.models.inception import (
    InceptionV3,
)
from container_engine_accelerators_tpu_torch.models.resnet import resnet
from tests import torch_parity


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _port_logits(model, x, train=False):
    model.train(train)
    with torch.no_grad():
        return model(torch.from_numpy(x)).float().numpy()


@functools.lru_cache(maxsize=None)
def _flax_shapes(kind, shape):
    model = torch_parity.flax_image_model(kind)
    tree = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, *shape)), train=False), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda x: tuple(x.shape), tree)


@pytest.mark.parametrize("kind", sorted(torch_parity.IMAGE_TINY))
def test_flax_layout_names_and_shapes_match_flax(kind):
    """The port's module paths and shapes are flax's variables, leaf
    for leaf: conv_init/norm_init, BasicBlock_i or BottleneckBlock_i
    numbered across stages with Conv_k/BatchNorm_k/conv_proj/norm_proj,
    Dense_k, ConvBN_k inside InceptionA_k..E_k, head; params and
    batch_stats."""
    shape = torch_parity.IMAGE_SHAPES.get(kind, (32, 32, 3))
    want = _flax_shapes(kind, shape)
    got = jax.tree_util.tree_map(lambda x: x.shape,
                                 torch_parity._image_variables(kind, 0))
    assert got == want


@pytest.mark.parametrize("kind,port", [
    ("resnet50", lambda: resnet(50, 1000, device="meta")),
    ("inception", lambda: InceptionV3(1000, device="meta"))])
def test_parameter_counts_equal_flax_at_full_width(kind, port):
    model = torch_parity.flax_image_model(kind, num_classes=1000,
                                          **({"width": 64}
                                             if kind == "resnet50" else {}))
    size = 224 if kind == "resnet50" else 299
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, size, size, 3)), train=False),
        jax.random.PRNGKey(0))
    want = {c: sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(shapes[c]))
            for c in ("params", "batch_stats")}
    model = port()
    got = {"params": sum(p.numel() for p in model.parameters()),
           "batch_stats": sum(b.numel() for b in model.buffers())}
    assert got == want
    assert want["params"] == (25557032 if kind == "resnet50"
                              else 23834568)


@pytest.mark.parametrize("n,k,s", [(224, 7, 2), (112, 3, 2), (56, 3, 2),
                                   (7, 3, 2), (33, 3, 2), (17, 1, 2),
                                   (9, 3, 1), (1, 3, 2), (35, 7, 1)])
def test_same_pads_match_lax(n, k, s):
    want = jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]
    assert layers.same_pads(n, k, s) == tuple(want)
    assert layers.same_pads(224, 7, 2) == (2, 3)
    assert layers.same_pads(56, 3, 2) == (0, 1)
    assert layers.same_pads(7, 3, 2) == (1, 1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batchnorm_matches_flax(dtype):
    """Train mode: output, and the running statistics updated with the
    biased variance and momentum 0.9; eval mode on the updated
    statistics. bf16 input, f32 statistics, bf16 output."""
    jdt, tdt = torch_parity.DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = (2.0 + 3.0 * rng.standard_normal((4, 5, 6, 8))).astype(np.float32)
    x = np.array(jnp.asarray(x, jdt).astype(jnp.float32))
    stats = {"mean": 0.3 * rng.standard_normal(8).astype(np.float32),
             "var": (1 + rng.random(8)).astype(np.float32)}
    params = {"scale": (1 + 0.2 * rng.standard_normal(8)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(8)).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jdt)
    variables = {"params": params, "batch_stats": stats}
    want, mutated = bn.apply(variables, jnp.asarray(x, jdt),
                             mutable=["batch_stats"])
    port = layers.BatchNorm(8, eps=1e-5, dtype=tdt)
    port.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"])})
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = port(xt).permute(0, 2, 3, 1)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "f32" else 1e-2
    assert _rel_err(got.float(), np.asarray(want, np.float32)) <= tol
    for leaf, buf in (("mean", port.running_mean), ("var", port.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(mutated["batch_stats"][leaf]),
                                   rtol=1e-5, atol=1e-6)
    unbiased = xt.float().var(dim=(0, 2, 3), unbiased=True)
    assert not torch.allclose(port.running_var,
                              0.9 * torch.from_numpy(stats["var"])
                              + 0.1 * unbiased)
    bn_eval = nn.BatchNorm(use_running_average=True, momentum=0.9,
                           epsilon=1e-5, dtype=jdt)
    want = bn_eval.apply({"params": params,
                          "batch_stats": mutated["batch_stats"]},
                         jnp.asarray(x, jdt))
    with torch.no_grad():
        got = port.eval()(xt).permute(0, 2, 3, 1)
    assert _rel_err(got.float(), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("kind", ["resnet18", "resnet50"])
@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resnet_forward_matches_flax(kind, size, dtype):
    """Eval mode (running statistics). 33x33 takes the other SAME
    split (odd maps: pads on both sides where 32 pads only after)."""
    model, tree, port = torch_parity.flax_image(kind, dtype)
    x = torch_parity.images(size, 2, (size, size, 3))
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(tree, x)
    got = _port_logits(port, x)
    assert got.shape == (2, 10)
    assert _rel_err(got, want) <= (1e-4 if dtype == "f32" else 2e-2)


def _train_forward(kind, batch, size, **overrides):
    """(flax logits, flax mutated batch_stats, port logits, port
    batch_stats in the flax layout) of one train-mode forward."""
    model = torch_parity.flax_image_model(kind, **overrides)
    tree = jax.tree_util.tree_map(np.copy,
                                  torch_parity._image_variables(kind, 0))
    port = convert.load_image_model(
        torch_parity.port_image_model(kind, **overrides), tree)
    x = torch_parity.images(batch, batch, (size, size, 3))
    want, mutated = jax.jit(lambda v, x: model.apply(
        v, x, train=True, mutable=["batch_stats"]))(tree, x)
    got = _port_logits(port, x, train=True)
    return (want, mutated["batch_stats"], got,
            convert.image_variables_to_flax(port)["batch_stats"])


def _worst_leaf(got, want):
    errs = jax.tree_util.tree_map(_rel_err, got, want)
    return max(jax.tree_util.tree_leaves(errs))


@pytest.mark.parametrize("kind,batch,tol", [
    ("resnet18", 2, 1e-5),
    # 16 bottleneck blocks of batch-normalised layers, the last stage
    # over 2x2 maps: measured 4.4e-5 (logits) and 1.0e-5 (statistics).
    ("resnet50", 8, 1e-4)])
def test_resnet_train_forward_matches_flax(kind, batch, tol):
    want, want_stats, got, got_stats = _train_forward(kind, batch, 33)
    assert _rel_err(got, want) <= tol
    assert _worst_leaf(got_stats, want_stats) <= tol
    # The statistics moved from the tree they started from.
    start = torch_parity._image_variables(kind, 0)["batch_stats"]
    assert _worst_leaf(got_stats, start) > 1e-2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mnist_mlp_matches_flax(dtype):
    """Flattened in (h, w, c) order; train and eval mode are the same
    function (no BN, no dropout)."""
    model, tree, port = torch_parity.flax_image("mlp", dtype)
    x = torch_parity.images(5, 3, (28, 28, 1))
    want = jax.jit(lambda v, x: model.apply(v, x, train=True))(tree, x)
    tol = 1e-5 if dtype == "f32" else 2e-2
    assert _rel_err(_port_logits(port, x, train=True), want) <= tol
    assert _rel_err(_port_logits(port, x), want) <= tol


def test_inception_eval_matches_flax():
    """75x75 (the smallest input), batch 2, f32: the VALID stem, the
    SAME average pools dividing by 9 with the pads, the concatenation
    order of every block."""
    model, tree, port = torch_parity.flax_image("inception")
    x = torch_parity.images(7, 2, (75, 75, 3))
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(tree, x)
    assert _rel_err(_port_logits(port, x), want) <= 1e-4


def test_inception_train_matches_flax():
    """Train mode with dropout 0 (flax passes the input through), batch
    8: 94 batch-normalised layers, the E blocks over 1x1 maps (8 values
    a channel), measured 1.1e-3 (logits) and 6.8e-5 (statistics)."""
    want, want_stats, got, got_stats = _train_forward(
        "inception", 8, 75, dropout_rate=0.0)
    assert _rel_err(got, want) <= 5e-3
    assert _worst_leaf(got_stats, want_stats) <= 5e-4


def _flat(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _flat(tree[key], prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), np.asarray(tree[key])


@pytest.mark.parametrize("kind", ["resnet18", "mlp", "inception"])
def test_converter_round_trip(kind):
    _, tree, port = torch_parity.flax_image(kind)
    back = dict(_flat(convert.image_variables_to_flax(port)))
    want = dict(_flat(tree))
    assert set(back) == set(want)
    for name in want:
        np.testing.assert_array_equal(back[name], want[name], err_msg=name)
    if kind == "resnet18":
        # Conv HWIO -> OIHW, Dense [in, out] -> Linear [out, in].
        assert tuple(port.conv_init.weight.shape) == (8, 3, 7, 7)
        assert port.conv_init.weight.is_contiguous(
            memory_format=torch.channels_last)
        assert tuple(port.head.weight.shape) == (10, 64)


def test_converter_refuses_a_partial_tree():
    _, tree, port = torch_parity.flax_image("resnet18")
    del tree["batch_stats"]["BasicBlock_2"]["norm_proj"]["var"]
    with pytest.raises(ValueError, match="lack batch_stats"):
        convert.image_variables_from_flax(port, tree)
    _, tree, port = torch_parity.flax_image("resnet18")
    tree["params"]["extra"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="leaves"):
        convert.image_variables_from_flax(port, tree)
    _, tree, port = torch_parity.flax_image("resnet18")
    tree["params"]["head"]["kernel"] = np.zeros((64, 11), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.image_variables_from_flax(port, tree)


@pytest.mark.parametrize("block", ["BasicBlock", "BottleneckBlock"])
def test_numpy_init_follows_flax_initializers(block):
    """Scale zeros exactly where flax's block says scale_init=zeros (its
    last BN), ones elsewhere; zero biases, means 0, variances 1;
    lecun-normal kernels (truncated at 2 std, std 1/sqrt(fan_in))."""
    cls = {"BasicBlock": BasicBlock, "BottleneckBlock": BottleneckBlock}[block]
    conv = functools.partial(nn.Conv, use_bias=False, padding="SAME")
    norm = functools.partial(nn.BatchNorm, use_running_average=False,
                             momentum=0.9, epsilon=1e-5)
    flax_block = cls(filters=8, strides=2, conv=conv, norm=norm)
    want = jax.jit(lambda k: flax_block.init(
        k, jnp.zeros((1, 8, 8, 8))))(jax.random.PRNGKey(0))
    depth = 18 if block == "BasicBlock" else 50
    model = resnet(depth, 10, width=8, device="meta")
    tree = convert.init_flax_layout_image(model, 0)
    name = f"{block}_{2 if depth == 18 else 3}"  # first block of stage 1
    got = tree["params"][name]
    assert sorted(got) == sorted(want["params"])
    for module, leaves in want["params"].items():
        if "scale" in leaves:  # all ones, or all zeros (the last BN)
            assert set(np.unique(got[module]["scale"])) == set(
                np.unique(np.asarray(leaves["scale"]))), module
            assert not got[module]["bias"].any()
    for module, stats in tree["batch_stats"][name].items():
        assert not stats["mean"].any() and (stats["var"] == 1).all()
    kernels = [np.asarray(leaf) for path, leaf in
               jax.tree_util.tree_leaves_with_path(tree["params"])
               if path[-1].key == "kernel"]
    big = max(kernels, key=np.size)
    fan_in = int(np.prod(big.shape[:-1]))
    assert abs(big.std() * np.sqrt(fan_in) - 1.0) < 0.05
    assert np.abs(big).max() <= 2.0 / layers._TRUNC_STD / np.sqrt(fan_in)
    with pytest.raises(ValueError, match="depth"):
        resnet(26)

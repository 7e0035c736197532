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


"""The port's fused cross-entropy against the JAX package's Pallas
kernel (ops/xent.py) and the plain loss against
parallel/train.py:cross_entropy_loss.

On the CPU the port's wrappers take their plain versions (the
functions the CUDA kernels are held to on the card) and the Pallas
kernels run in interpret mode. Tolerance: f32 2e-5 (summation order
over a 333-class row).

The port's contract for a label outside [0, C): no class matches, so
the label logit counts as 0 (the loss is the row's shifted
log-sum-exp) and the backward subtracts no one-hot. The Pallas kernel
agrees for labels below 0 and past its 128-padded class count; a
label in [C, padded C) hits a -1e9 padding class there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import xent as jax_xent
from container_engine_accelerators_tpu.parallel import train as jax_train
from container_engine_accelerators_tpu_torch.ops import _build
from container_engine_accelerators_tpu_torch.ops import xent
from container_engine_accelerators_tpu_torch.parallel import (
    cross_entropy_loss,
)

N, C = 200, 333  # neither a multiple of the Pallas kernel's 128 tiles
TOL = 2e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, out_of_range=()):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((N, C))).astype(np.float32)
    labels = rng.integers(0, C, N).astype(np.int32)
    for row, label in out_of_range:
        labels[row] = label
    g = rng.standard_normal(N).astype(np.float32)
    return logits, labels, g


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("out_of_range", [(), ((3, -1), (7, 1000))])
def test_loss_and_gradient_match_pallas(out_of_range):
    logits, labels, g = _inputs(0, out_of_range)
    want = jax_xent.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels))
    want_grad = jax.grad(lambda x: jnp.sum(
        jax_xent.softmax_cross_entropy(x, jnp.asarray(labels)) * g))(
            jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = xent.softmax_cross_entropy(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach(), want)
    _close(tl.grad, want_grad)


@pytest.mark.parametrize("n,c", [(128, 1000), (256, 10)])
def test_image_shapes_match_pallas(n, c):
    """The image path's logits: ResNet's [128, 1000] (C not a multiple of
    the Pallas kernel's 128 lanes, so it pads) and MNIST's [256, 10] (C
    not a multiple of 4: the CUDA kernel's scalar loads), f32."""
    rng = np.random.default_rng(c)
    logits = (3 * rng.standard_normal((n, c))).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    g = rng.standard_normal(n).astype(np.float32)
    want = jax_xent.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels))
    want_grad = jax.grad(lambda x: jnp.sum(
        jax_xent.softmax_cross_entropy(x, jnp.asarray(labels)) * g))(
            jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = xent.softmax_cross_entropy(tl, torch.from_numpy(labels))
    (got * torch.from_numpy(g)).sum().backward()
    _close(got.detach(), want)
    _close(tl.grad, want_grad)


def test_out_of_range_label_matches_no_class():
    """Labels -1, C (inside the Pallas padding) and 10**6: the loss is
    the shifted log-sum-exp and the gradient is softmax * g."""
    logits, labels, g = _inputs(1, ((0, -1), (1, C), (2, 10 ** 6)))
    tl = torch.from_numpy(logits).requires_grad_()
    loss = xent.softmax_cross_entropy(tl, torch.from_numpy(labels))
    (loss * torch.from_numpy(g)).sum().backward()
    lf = torch.from_numpy(logits).double()
    shifted = lf - lf.max(-1, keepdim=True).values
    want = torch.logsumexp(shifted, -1)
    probs = torch.softmax(lf, -1) * torch.from_numpy(g).double()[:, None]
    for row in (0, 1, 2):
        assert abs(float(loss.detach()[row]) - float(want[row])) < TOL
        np.testing.assert_allclose(tl.grad[row].numpy(),
                                   probs[row].numpy(), rtol=TOL, atol=TOL)
    # The Pallas kernel agrees for the labels outside its padding.
    pallas = np.asarray(jax_xent.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels)))
    _close(loss.detach()[[0, 2]], pallas[[0, 2]])


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_mean_loss_matches_jax(smoothing):
    logits, labels, _ = _inputs(2)

    def jax_loss(x):
        return jax_xent.mean_cross_entropy_loss(
            x, jnp.asarray(labels), label_smoothing=smoothing)
    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = xent.mean_cross_entropy_loss(tl, torch.from_numpy(labels),
                                       label_smoothing=smoothing)
    got.backward()
    _close(got.detach(), want)
    _close(tl.grad, want_grad)


def test_label_smoothing_range_is_checked():
    logits, labels, _ = _inputs(3)
    for eps in (-0.1, 1.0):
        with pytest.raises(ValueError, match="label_smoothing"):
            xent.mean_cross_entropy_loss(torch.from_numpy(logits),
                                         torch.from_numpy(labels), eps)


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_plain_cross_entropy_loss_matches_jax(smoothing):
    logits, labels, _ = _inputs(4, ((5, -1),))

    def jax_loss(x):
        return jax_train.cross_entropy_loss(x, jnp.asarray(labels),
                                            label_smoothing=smoothing)
    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy_loss(tl, torch.from_numpy(labels),
                             label_smoothing=smoothing)
    got.backward()
    _close(got.detach(), want)
    _close(tl.grad, want_grad)


def test_bf16_logits_keep_their_dtype_in_the_gradient():
    logits, labels, _ = _inputs(5)
    tl = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    xent.mean_cross_entropy_loss(tl, torch.from_numpy(labels)).backward()
    assert tl.grad.dtype == torch.bfloat16


def test_cpu_tensors_take_the_plain_versions():
    logits, labels, g = (torch.from_numpy(x) for x in _inputs(6))
    before = [kern.launches for kern in xent.KERNELS]
    torch.testing.assert_close(
        xent.xent_fwd(logits, labels),
        xent.softmax_cross_entropy_reference(logits, labels),
        rtol=0, atol=0)
    torch.testing.assert_close(
        xent.xent_bwd(logits, labels, g),
        xent.softmax_cross_entropy_bwd_reference(logits, labels, g),
        rtol=0, atol=0)
    assert [kern.launches for kern in xent.KERNELS] == before


def test_wrappers_refuse_other_devices_and_shapes():
    meta = torch.zeros((4, 8), device="meta")
    labels = torch.zeros(4, dtype=torch.long, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        xent.xent_fwd(meta, labels)
    with pytest.raises(ValueError, match="different devices"):
        xent.xent_bwd(meta, labels, torch.zeros(4))
    with pytest.raises(ValueError, match=r"\[N, C\]"):
        xent.xent_fwd(torch.zeros(4, 8), torch.zeros(5, dtype=torch.long))
    with pytest.raises(ValueError, match="integer labels"):
        xent.xent_fwd.launch(torch.zeros(4, 8), torch.zeros(4))


@pytest.mark.parametrize("kernel", ["xent_fwd", "xent_bwd"])
def test_xent_kernel_build_has_no_fallback(monkeypatch, kernel):
    """A failed build surfaces through the wrapper's launch."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "absent.so")
    monkeypatch.setitem(_build._loaded, "xent", None)
    wrapper = getattr(xent, kernel)
    monkeypatch.setattr(wrapper, "_fn", None)
    logits = torch.zeros(4, 8)
    labels = torch.zeros(4, dtype=torch.long)
    args = (logits, labels) if kernel == "xent_fwd" else (
        logits, labels, torch.ones(4))
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wrapper.launch(*args)
    assert wrapper.launches == before

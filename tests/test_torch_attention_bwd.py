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


"""The port's flash-attention gradients against the JAX package's
Pallas backward.

On the CPU the port's backward runs the plain versions of its dQ and
dK/dV kernels (the same functions the CUDA kernels are held to on the
card by tests/test_torch_gpu.py and chip_smoke.py), and ``jax.grad``
of the JAX functions runs the Pallas backward kernels in interpret
mode, resident or streaming as ``streaming=`` asks. Tolerances: f32
2e-4 (summation order through the recomputed probabilities), bf16 2e-2
of the largest gradient (outputs rounded to 8 bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import attention as jax_attn
from container_engine_accelerators_tpu_torch.ops import _build
from container_engine_accelerators_tpu_torch.ops import attention as attn

B, S, H, D = 1, 200, 2, 32  # S ragged against the 128-row block


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, shape=(B, S, H, D)):
    rng = np.random.default_rng(seed)
    q, k, v, g_o = (rng.standard_normal(shape).astype(np.float32)
                    for _ in range(4))
    g_lse = rng.standard_normal(shape[:3]).astype(np.float32)
    return q, k, v, g_o, g_lse


def _jax_grads(q, k, v, g_o, g_lse, dtype, **kw):
    def f(q, k, v):
        if g_lse is None:
            o = jax_attn.flash_attention(q, k, v, **kw)
            return jnp.sum(o.astype(jnp.float32) * g_o)
        o, lse = jax_attn.flash_attention_lse(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * g_o) + jnp.sum(lse * g_lse)
    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(x, np.float32) for x in grads]


def _port_grads(q, k, v, g_o, g_lse, dtype, **kw):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    if g_lse is None:
        o = attn.flash_attention(tq, tk, tv, **kw)
        loss = (o.float() * torch.from_numpy(g_o)).sum()
    else:
        o, lse = attn.flash_attention_lse(tq, tk, tv, **kw)
        loss = ((o.float() * torch.from_numpy(g_o)).sum()
                + (lse * torch.from_numpy(g_lse)).sum())
    loss.backward()
    for t in (tq, tk, tv):
        assert t.grad.dtype == dtype and t.grad.shape == q.shape
    return [t.grad.float().numpy() for t in (tq, tk, tv)]


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 64)])
def test_lse_gradients_match_pallas(causal, window, streaming):
    """dQ, dK, dV of o and lse together (a nonzero lse cotangent folds
    into delta) against the Pallas backward."""
    q, k, v, g_o, g_lse = _inputs(0)
    kw = dict(causal=causal, window=window, block=128, streaming=streaming)
    want = _jax_grads(q, k, v, g_o, g_lse, jnp.float32, **kw)
    got = _port_grads(q, k, v, g_o, g_lse, torch.float32, **kw)
    for name, w, g in zip("qkv", want, got):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_output_gradients_match_pallas(causal):
    """flash_attention (no lse output) through the resident kernels."""
    q, k, v, g_o, _ = _inputs(1)
    kw = dict(causal=causal, block=128)
    want = _jax_grads(q, k, v, g_o, None, jnp.float32, **kw)
    got = _port_grads(q, k, v, g_o, None, torch.float32, **kw)
    for name, w, g in zip("qkv", want, got):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("d", [4, 12, 256])
def test_gradients_match_pallas_at_head_dims(d):
    """Head dims the kernels take only through their route (D 4 and 12
    zero-padded to 8 and 16, D 256 on the wide kernels): the gradients
    of o and lse, f32, causal with the W 24 band at S 48, against the
    Pallas backward."""
    q, k, v, g_o, g_lse = _inputs(4, (1, 48, 2, d))
    kw = dict(causal=True, window=24, block=128)
    want = _jax_grads(q, k, v, g_o, g_lse, jnp.float32, **kw)
    got = _port_grads(q, k, v, g_o, g_lse, torch.float32, **kw)
    for name, w, g in zip("qkv", want, got):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4,
                                   err_msg=f"d{name}")


def test_bf16_gradients_match_pallas():
    q, k, v, g_o, g_lse = _inputs(2)
    kw = dict(causal=True)
    want = _jax_grads(q, k, v, g_o, g_lse, jnp.bfloat16, **kw)
    got = _port_grads(q, k, v, g_o, g_lse, torch.bfloat16, **kw)
    for name, w, g in zip("qkv", want, got):
        tol = 2e-2 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"d{name}")


def test_backward_plain_versions_take_the_kernels_arguments():
    """The two plain versions, called as the autograd function calls
    the kernels (delta = rowsum(dO*O) - g_lse), give the gradients
    autograd reports, and run no kernel."""
    q, k, v, g_o, g_lse = (torch.from_numpy(x) for x in _inputs(3))
    o, lse = attn.flash_attention_reference(q, k, v, True, 32)
    delta = (g_o * o).sum(-1) - g_lse
    before = [kern.launches for kern in attn.KERNELS]
    dq = attn.flash_bwd_dq(q, k, v, g_o, lse, delta, True, 32)
    dk, dv = attn.flash_bwd_dkv(q, k, v, g_o, lse, delta, True, 32)
    grads = torch.autograd.grad(
        attn.flash_attention_lse(*(x.requires_grad_() for x in (q, k, v)),
                                 causal=True, window=32),
        (q, k, v), (g_o, g_lse))
    for got, want in zip((dq, dk, dv), grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [kern.launches for kern in attn.KERNELS] == before


def test_only_lse_used_still_differentiates():
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _inputs(4)[:3])
    _, lse = attn.flash_attention_lse(q, k, v, causal=True)
    lse.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
    assert float(v.grad.abs().max()) == 0.0  # lse does not depend on v


def test_backward_wrappers_refuse_other_devices():
    x = torch.zeros((1, 8, 2, 8), device="meta")
    rows = torch.zeros((1, 8, 2), device="meta")
    for kern in (attn.flash_bwd_dq, attn.flash_bwd_dkv):
        with pytest.raises(ValueError, match="cuda or cpu"):
            kern(x, x, x, x, rows, rows, True)
        with pytest.raises(ValueError, match="different devices"):
            kern(x, x, x, torch.zeros(1, 8, 2, 8), rows, rows, True)


def test_backward_checks_its_operands():
    q = torch.zeros((1, 8, 2, 8))
    rows = torch.zeros((1, 8, 2))
    with pytest.raises(ValueError, match="one dtype"):
        attn.flash_bwd_dq.launch(q, q, q, q.double(), rows, rows, True, 0)
    with pytest.raises(ValueError, match="lse"):
        attn.flash_bwd_dkv.launch(q, q, q, q, rows.double(), rows, True, 0)
    with pytest.raises(ValueError, match="delta"):
        attn.flash_bwd_dkv.launch(q, q, q, q, rows, rows[:, :4], True, 0)


@pytest.mark.parametrize("kernel", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_kernel_build_has_no_fallback(monkeypatch, kernel):
    """A failed build surfaces through the wrapper's launch: no stand-in
    runs in the kernel's place."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "absent.so")
    monkeypatch.setitem(_build._loaded, "flash_bwd", None)
    wrapper = getattr(attn, kernel)
    monkeypatch.setattr(wrapper, "_fn", None)
    q = torch.zeros((1, 8, 2, 8))
    rows = torch.zeros((1, 8, 2))
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wrapper.launch(q, q, q, q, rows, rows, True, 0)
    assert wrapper.launches == before

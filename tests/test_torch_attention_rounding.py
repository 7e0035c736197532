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

"""The bf16 tensor-core flash kernels' rounding points, emulated in
plain torch and held against the JAX package's Pallas kernels.

The CUDA kernels for bf16 inputs (``ops/csrc/flash_fwd.cu``,
``ops/csrc/flash_bwd.cu``) round the probabilities to bf16 before the
second product of each pass: P before P.V in the forward, dS before
dQ = dS.K in the dQ backward, P^T and dS^T before dV = P^T.dO and dK =
dS^T.Q in the dK/dV backward. Those kernels run only on the card; this
file emulates their rounding points (not their tile order) in f32
arithmetic and shows on the CPU that the numerics fit the bf16 limit
the card checks use: 2e-2 on O and lse, 2e-2 of the largest gradient.
The Pallas kernels run in interpret mode on the same bf16 inputs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import attention as jax_attn

B, S, H = 1, 200, 2  # S ragged against the 64- and 128-row tiles
TOL = 2e-2
CASES = [(False, None), (True, None), (True, 64)]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, d):
    rng = np.random.default_rng(seed)
    q, k, v, g_o = (rng.standard_normal((B, S, H, d)).astype(np.float32)
                    for _ in range(4))
    g_lse = rng.standard_normal((B, S, H)).astype(np.float32)
    return q, k, v, g_o, g_lse


def _bf16(x):
    """x rounded to bf16, back in f32."""
    return x.to(torch.bfloat16).float()


def _heads_first(*xs):
    """bf16-rounded numpy [B, S, H, D] -> f32 torch [B, H, S, D]."""
    return [_bf16(torch.from_numpy(x)).transpose(1, 2) for x in xs]


def _scores(qf, kf, causal, window):
    """Scaled scores with the kernels' -1e9 masks."""
    s = qf.shape[2]
    scores = qf @ kf.transpose(-1, -2) / math.sqrt(qf.shape[-1])
    if causal:
        i = torch.arange(s)[:, None]
        j = torch.arange(s)[None, :]
        keep = j <= i
        if window:
            keep &= j > i - window
        scores = torch.where(keep, scores, torch.tensor(-1e9))
    return scores


def emulated_forward(q, k, v, causal, window):
    """The tensor-core forward's numerics: f32 scores and row sums, P
    rounded to bf16 before P.V, O written in bf16. Returns (o [B, S, H,
    D] f32 of bf16 values, lse [B, S, H] f32)."""
    qf, kf, vf = _heads_first(q, k, v)
    s = _scores(qf, kf, causal, window)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(-1, keepdim=True)
    o = _bf16((_bf16(p) @ vf) / den)
    lse = (m + torch.log(den))[..., 0]
    return o.transpose(1, 2), lse.transpose(1, 2)


def emulated_gradients(q, k, v, g_o, g_lse, causal, window):
    """dQ, dK, dV of sum(o * g_o) + sum(lse * g_lse) as the bf16
    kernels compute them: delta = rowsum(dO * O) - g_lse from the
    emulated forward's bf16 O; dQ = bf16(dS).K (the tensor-core dQ
    kernel); dV = bf16(P)^T.dO and dK = bf16(dS)^T.Q (the tensor-core
    dK/dV kernel); each written in bf16."""
    o, lse = emulated_forward(q, k, v, causal, window)
    qf, kf, vf, dof = _heads_first(q, k, v, g_o)
    delta = ((dof * o.transpose(1, 2)).sum(-1)
             - torch.from_numpy(g_lse).transpose(1, 2))
    s = _scores(qf, kf, causal, window)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta[..., None]) / math.sqrt(qf.shape[-1])
    dq = _bf16(ds) @ kf
    dk = _bf16(ds).transpose(-1, -2) @ qf
    dv = _bf16(p).transpose(-1, -2) @ dof
    return [_bf16(x).transpose(1, 2).numpy() for x in (dq, dk, dv)]


def _jax_grads(q, k, v, g_o, g_lse, **kw):
    def f(q, k, v):
        o, lse = jax_attn.flash_attention_lse(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * g_o) + jnp.sum(lse * g_lse)
    grads = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    return [np.asarray(x, np.float32) for x in grads]


@pytest.mark.parametrize("d", [32, 40])
@pytest.mark.parametrize("causal,window", CASES)
def test_forward_rounding_fits_pallas(causal, window, d):
    q, k, v, _, _ = _inputs(d, d)
    want_o, want_lse = jax_attn.flash_attention_lse(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
        window=window)
    got_o, got_lse = emulated_forward(q, k, v, causal, window)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o, np.float32),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [32, 40, 64])
@pytest.mark.parametrize("causal,window", CASES)
def test_backward_rounding_fits_pallas(causal, window, d):
    """dQ, dK, dV (an lse cotangent folded into delta) against the
    Pallas backward, each within 2e-2 of its largest value."""
    q, k, v, g_o, g_lse = _inputs(100 + d, d)
    want = _jax_grads(q, k, v, g_o, g_lse, causal=causal, window=window)
    got = emulated_gradients(q, k, v, g_o, g_lse, causal, window)
    for name, w, g in zip("qkv", want, got):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * float(np.abs(w).max()),
                                   err_msg=f"d{name}")

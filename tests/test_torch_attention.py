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

"""The port's flash attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper takes its plain version, and the Pallas
kernel runs in interpret mode, so these tests hold the plain version
(the same function the CUDA kernel is held to on the card by
tests/test_torch_gpu.py and chip_smoke.py) against the TPU kernel on
the same inputs. Tolerances: f32 2e-5 (the Pallas tests' own, for
reduction order), bf16 2e-2 (outputs rounded to 8 bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.ops import attention as jax_attn
from container_engine_accelerators_tpu_torch.ops import _build
from container_engine_accelerators_tpu_torch.ops import attention as attn

B, S, H, D = 1, 200, 2, 32  # S deliberately not a multiple of 128


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


_DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
           "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("causal,window", [(False, None), (True, None),
                                           (True, 64)])
def test_plain_matches_pallas(dtype, causal, window):
    jdt, tdt, tol = _DTYPES[dtype]
    q, k, v = _qkv(0)
    want_o, want_lse = jax_attn.flash_attention_lse(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
        window=window)
    got_o, got_lse = attn.flash_attention_lse(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), causal=causal,
        window=window)
    assert got_o.dtype == tdt and got_lse.dtype == torch.float32
    assert tuple(got_lse.shape) == (B, S, H)
    np.testing.assert_allclose(
        got_o.float().numpy(), np.asarray(want_o, np.float32),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=tol, atol=tol)


def test_block_and_streaming_do_not_change_the_result():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1))
    base = attn.flash_attention(q, k, v, causal=True)
    for block, streaming in ((128, None), (256, True), (512, False)):
        got = attn.flash_attention(q, k, v, causal=True, block=block,
                                   streaming=streaming)
        assert torch.equal(got, base)
    o, _ = attn.flash_attention_lse(q, k, v, causal=True)
    assert torch.equal(o, base)


_BAD_ARGS = [
    dict(shapes=((1, 8, 2, 8), (1, 9, 2, 8), (1, 8, 2, 8))),
    dict(block=100),
    dict(block=64),
    dict(window=-1, causal=True),
    dict(window=16, causal=False),
]


@pytest.mark.parametrize("case", range(len(_BAD_ARGS)))
def test_check_args_errors_match_jax(case):
    args = dict(_BAD_ARGS[case])
    shapes = args.pop("shapes", ((1, 8, 2, 8),) * 3)
    with pytest.raises(ValueError) as want:
        jax_attn._check_args(*(jnp.zeros(s) for s in shapes),
                             args.get("causal", False),
                             args.get("block"), None, args.get("window"))
    with pytest.raises(ValueError) as got:
        attn.flash_attention(*(torch.zeros(s) for s in shapes), **args)
    assert str(got.value) == str(want.value)


def test_check_args_defaults_match_jax():
    for s in (1, 127, 128, 200, 700):
        q = np.zeros((1, s, 1, 8), np.float32)
        want = jax_attn._check_args(*(jnp.asarray(q),) * 3, True, None,
                                    None, 8)
        got = attn._check_args(*(torch.from_numpy(q),) * 3, True, None,
                               None, 8)
        assert got == want


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2))
    before = attn.flash_fwd.launches
    o, lse = attn.flash_attention_lse(q, k, v, causal=True)
    ref_o, ref_lse = attn.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert attn.flash_fwd.launches == before == 0


def test_other_devices_raise_instead_of_falling_back():
    q = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        attn.flash_attention(q, q, q, causal=True)
    with pytest.raises(ValueError, match="different devices"):
        attn.flash_attention(q, torch.zeros(1, 8, 2, 8), q)


def test_kernel_build_has_no_fallback(monkeypatch):
    """Without nvcc the build raises; it never hands back a stand-in."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_fwd")


def test_kernel_sources_and_library_names():
    assert _build.sources() == ["flash_fwd"]
    path = _build.library_path("flash_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libflash_fwd-") and path.suffix == ".so"
    assert path == _build.library_path("flash_fwd")  # stable digest
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

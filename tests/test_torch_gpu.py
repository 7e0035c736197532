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

"""The port's CUDA kernel on the card (marker ``gpu``).

These tests need an NVIDIA card with nvcc; elsewhere they skip. The
file imports neither JAX nor the repo's conftest, so on a machine with
the card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

The flash kernel is held to its plain PyTorch version on the same
inputs: bf16 at 2e-2 (outputs rounded to 8 bits), f32 at 1e-4
(summation order).
"""

import math

import pytest
import torch

from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.ops import attention as attn

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device, dtype=dtype)
            for _ in range(3)]


@pytest.mark.parametrize("shape,dtype,causal,window", [
    ((1, 16, 8, 64), torch.bfloat16, True, 0),
    ((1, 200, 8, 64), torch.bfloat16, True, 0),
    ((2, 333, 4, 128), torch.bfloat16, True, 0),
    ((2, 200, 4, 32), torch.float32, False, 0),
    ((1, 300, 4, 64), torch.float32, True, 64),
    ((1, 1, 2, 8), torch.float32, False, 0),
])
def test_kernel_matches_plain_version(cuda, shape, dtype, causal, window):
    q, k, v = _qkv(shape, dtype, sum(shape), cuda)
    before = attn.flash_fwd.launches
    o, lse = attn.flash_attention_lse(q, k, v, causal=causal,
                                      window=window or None)
    torch.cuda.synchronize()
    assert attn.flash_fwd.launches == before + 1
    ro, rl = attn.flash_attention_reference(q, k, v, causal, window)
    assert o.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), ro.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, rl, rtol=TOL[dtype], atol=TOL[dtype])


def test_kernel_reads_strided_slices(cuda):
    """q, k, v as slices of one fused [B, S, 3, H, D] projection (the
    MHA layout) are read through their strides, without copies."""
    fused = torch.randn((2, 150, 3, 4, 64), device=cuda,
                        dtype=torch.bfloat16)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    assert not q.is_contiguous()
    o = attn.flash_attention(q, k, v, causal=True)
    ro, _ = attn.flash_attention_reference(q.contiguous(), k.contiguous(),
                                           v.contiguous(), True)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attn.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 256), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attn.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda).transpose(1, 3)
    with pytest.raises(ValueError):
        attn.flash_attention(q, q, q)


def test_engine_on_the_card_launches_the_kernel(cuda):
    """The dense slot engine at a small width on the card: greedy
    tokens equal greedy_decode, and every admission launches the flash
    kernel once per layer."""
    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=64)
    model = convert.load_lm(config, convert.init_flax_layout_params(
        config, 0), device="cuda")
    eng = decode.SlotDecodeEngine(model, slots=2, slot_len=48,
                                  paged=False)
    prompts = [torch.randint(0, 128, (n,), generator=torch.Generator()
                             .manual_seed(n)) for n in (5, 17)]
    before = attn.flash_fwd.launches
    out = {}
    for p in prompts:
        padded = torch.zeros(32, dtype=torch.long)
        padded[:len(p)] = p
        slot, first, _, _ = eng.admit(padded.numpy(), len(p))
        out[slot] = (p, [first])
    assert attn.flash_fwd.launches == before + 2 * config["num_layers"]
    for _ in range(6):
        toks, _ = eng.step()
        for slot, (_, seq) in out.items():
            seq.append(int(toks[slot]))
    for p, seq in out.values():
        want = decode.greedy_decode(model, p[None], 7)[0, len(p):]
        assert want.tolist() == seq
    assert math.isfinite(float(eng.step()[1][0]))

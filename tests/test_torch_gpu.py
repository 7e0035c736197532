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

Each kernel is held to its plain PyTorch version on the same inputs:
bf16 at 2e-2 (outputs rounded to 8 bits; the backward and the
cross-entropy relative to the largest reference value), f32 at 1e-4
(summation order). bf16 flash forward, dQ and dK/dV run on the tensor
cores (on the Hopper wgmma/TMA kernels, or on their mma.sync kernels
where ``attention.tma_rows`` is 0), f32 on the FMA kernels.
"""

import math
import time

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models import decode
from container_engine_accelerators_tpu_torch.models import transformer
from container_engine_accelerators_tpu_torch.models.resnet import resnet
from container_engine_accelerators_tpu_torch.ops import attention as attn
from container_engine_accelerators_tpu_torch.ops import xent
from container_engine_accelerators_tpu_torch.parallel import (
    Sgd,
    SyntheticLoader,
    SyntheticTokenLoader,
    Trainer,
    cross_entropy_loss,
)

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
    ((2, 200, 4, 40), torch.bfloat16, False, 0),
    ((1, 300, 4, 64), torch.bfloat16, True, 64),
    ((2, 200, 4, 32), torch.float32, False, 0),
    ((1, 300, 4, 64), torch.float32, True, 64),
    ((1, 1, 2, 8), torch.float32, False, 0),
    # Head dims past the multiples of 8 up to 128: D 4 runs zero-padded
    # to 8, D 256 the wide kernels (attention.head_dim_route).
    ((2, 100, 2, 4), torch.float32, True, 0),
    ((2, 100, 2, 4), torch.bfloat16, True, 32),
    ((2, 150, 4, 256), torch.float32, True, 0),
    ((2, 150, 4, 256), torch.bfloat16, True, 64),
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


def _card_lm():
    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=64)
    return convert.load_lm(config, convert.init_flax_layout_params(
        config, 0), device="cuda")


def test_paged_arena_write_and_gather_on_the_card(cuda):
    """The paged cache on CUDA tensors: a step through block tables
    writes each row's K/V at (table[b, p // bs], p % bs), and the
    gather puts every row back in position order, so the step's logits
    equal the dense step's on the same rows bitwise."""
    model = _card_lm()
    arena = model.init_paged_cache(9, 8)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for k, v in arena:
        k.copy_(torch.randn(k.shape, generator=gen, device="cuda"))
        v.copy_(torch.randn(v.shape, generator=gen, device="cuda"))
    tables = torch.tensor([[3, 0, 6], [8, 8, 8]], device="cuda")
    dense = [tuple(a[tables].flatten(1, 2).clone() for a in layer)
             for layer in arena]
    tok = torch.tensor([[5], [9]], device="cuda")
    pos = torch.tensor([13, 2], device="cuda")
    with torch.inference_mode():
        want = model(tok, dense, pos)
        got = model(tok, arena, pos, block_table=tables)
    assert torch.equal(got, want)
    for layer, dense_layer in zip(arena, dense):
        for a, d in zip(layer, dense_layer):
            assert torch.equal(a[0, 5], d[0, 13])
            assert torch.equal(a[tables[0]].flatten(0, 1), d[0])


def test_paged_engine_copy_on_write_on_the_card(cuda):
    """A second row sharing a resident prompt's full block and forking
    its partial boundary block on the card: the full block is mapped,
    not copied; the fork holds the donor's prompt rows bitwise; the
    paged admissions launch no flash kernel; the pool is clean after
    both rows retire."""
    model = _card_lm()
    eng = decode.SlotDecodeEngine(model, slots=2, slot_len=32, paged=True,
                                  kv_block_size=8)
    prompt = torch.randint(0, 128, (12,), generator=torch.Generator()
                           .manual_seed(1)).numpy()
    before = attn.flash_fwd.launches
    a = eng.admit(prompt, 12)[0]
    eng.step()
    b = eng.admit(np.concatenate([prompt, [7]]), 13)[0]
    assert attn.flash_fwd.launches == before
    assert eng.kv_block_stats()["prefix_hits"] == 1
    assert eng._tables[a, 0] == eng._tables[b, 0]
    src, dst = eng._tables[a, 1], eng._tables[b, 1]
    assert src != dst
    for layer in eng._cache:
        for arena in layer:
            assert torch.equal(arena[dst, :4], arena[src, :4])
    eng.step()
    eng.release(a)
    eng.release(b)
    assert eng.pool_leak_report() is None


@pytest.mark.parametrize("name", ["_quantize_rows_int8",
                                  "_quantize_rows_int4"])
def test_kv_quantizers_bitwise_card_against_cpu(cuda, name):
    """The KV-cache quantizers on the card give the CPU's bits (values,
    packed bytes, scales; the CPU ones are bitwise JAX's,
    tests/test_torch_quant.py), on bf16 rows at the deployed head dim
    with .5 ties (scale exactly 1), and the int4 unpack round-trips."""
    gen = torch.Generator().manual_seed(2)
    x = 3.0 * torch.randn((4, 16, 2, 64), generator=gen)
    x[0, 0, 0] = 0.0
    x[0, 0, 0, :5] = torch.tensor([127.0, 2.5, -3.5, 0.5, 126.5])
    x[0, 0, 1] = 0.0
    x[0, 0, 1, :5] = torch.tensor([7.0, 2.5, -1.5, 0.5, -6.5])
    x = x.to(torch.bfloat16)
    quantize = getattr(transformer, name)
    want_q, want_s = quantize(x)
    got_q, got_s = quantize(x.to(cuda))
    assert torch.equal(got_q.cpu(), want_q)
    assert torch.equal(got_s.cpu(), want_s)
    if name.endswith("int4"):
        assert torch.equal(transformer._unpack_int4(got_q).cpu(),
                           transformer._unpack_int4(want_q))


def _assert_near(got, want, dtype, what):
    """bf16: 2e-2 of the reference's largest magnitude; f32: 1e-4,
    relative once values exceed 1."""
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    tol = TOL[dtype] * (scale if dtype == torch.bfloat16
                        else max(1.0, scale))
    err = float((got.float() - want.float()).abs().max()) if want.numel() \
        else 0.0
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("shape,dtype,causal,window", [
    ((1, 16, 8, 64), torch.bfloat16, True, 0),
    ((1, 200, 8, 64), torch.bfloat16, True, 0),
    ((2, 333, 4, 128), torch.bfloat16, True, 0),
    ((2, 200, 4, 40), torch.bfloat16, False, 0),
    ((1, 300, 4, 64), torch.bfloat16, True, 64),
    ((1, 512, 8, 64), torch.bfloat16, True, 256),
    ((2, 300, 4, 128), torch.bfloat16, True, 100),
    ((2, 200, 4, 32), torch.float32, False, 0),
    ((1, 300, 4, 64), torch.float32, True, 64),
    ((1, 1, 2, 8), torch.float32, False, 0),
    ((2, 100, 2, 4), torch.float32, True, 0),
    ((2, 100, 2, 4), torch.bfloat16, True, 32),
    ((2, 150, 4, 256), torch.float32, True, 0),
    ((2, 150, 4, 256), torch.bfloat16, True, 64),
])
def test_backward_kernels_match_plain_versions(cuda, shape, dtype, causal,
                                               window):
    q, k, v = _qkv(shape, dtype, sum(shape), cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    do = torch.randn(shape, generator=gen, device=cuda, dtype=dtype)
    g_lse = torch.randn(shape[:3], generator=gen, device=cuda)
    o, lse = attn.flash_attention_reference(q, k, v, causal, window)
    delta = (do.float() * o.float()).sum(-1) - g_lse
    before = (attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches)
    dq = attn.flash_bwd_dq(q, k, v, do, lse, delta, causal, window)
    dk, dv = attn.flash_bwd_dkv(q, k, v, do, lse, delta, causal, window)
    torch.cuda.synchronize()
    assert (attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    rq = attn.flash_attention_dq_reference(q, k, v, do, lse, delta, causal,
                                           window)
    rk, rv = attn.flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                                causal, window)
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        _assert_near(got, want, dtype, name)


def _bwd_args(shape, dtype, causal, window, device, seed=7):
    """q, k, v, dO, lse, delta as the autograd function hands them to
    the backward kernels (delta from the plain forward's O, with an lse
    cotangent)."""
    q, k, v = _qkv(shape, dtype, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    g_lse = torch.randn(shape[:3], generator=gen, device=device)
    o, lse = attn.flash_attention_reference(q, k, v, causal, window)
    return q, k, v, do, lse, (do.float() * o.float()).sum(-1) - g_lse


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 64)])
def test_tensor_core_kernels_read_misaligned_rows(cuda, causal, window):
    """bf16 q/k/v/dO as slices of one fused projection whose rows are
    an odd number of elements apart (no row but the first starts on 16
    bytes): the tensor-core kernels stage them with narrow loads and
    agree with the plain versions."""
    b, s, h, d = 2, 150, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    fused = torch.randn((b, s, 4 * h * d + 1), generator=gen, device=cuda,
                        dtype=torch.bfloat16)
    q, k, v, do = (fused[:, :, 1 + i * h * d:1 + (i + 1) * h * d]
                   .unflatten(-1, (h, d)) for i in range(4))
    assert attn.rows_aligned(q, k, v, do) == 0
    o, lse = attn.flash_fwd(q, k, v, causal, window)
    ro, rl = attn.flash_attention_reference(q, k, v, causal, window)
    _assert_near(o, ro, torch.bfloat16, "o")
    torch.testing.assert_close(lse, rl, rtol=2e-2, atol=2e-2)
    delta = (do.float() * ro.float()).sum(-1)
    dq = attn.flash_bwd_dq(q, k, v, do, rl, delta, causal, window)
    rq = attn.flash_attention_dq_reference(q, k, v, do, rl, delta, causal,
                                           window)
    _assert_near(dq, rq, torch.bfloat16, "dq")
    dk, dv = attn.flash_bwd_dkv(q, k, v, do, rl, delta, causal, window)
    rk, rv = attn.flash_attention_dkv_reference(q, k, v, do, rl, delta,
                                                causal, window)
    _assert_near(dk, rk, torch.bfloat16, "dk")
    _assert_near(dv, rv, torch.bfloat16, "dv")


def test_tensor_core_kernels_are_deterministic(cuda):
    """Two launches on the same inputs give bitwise-equal outputs: every
    output tile is owned by one block, with no atomics."""
    shape = (2, 333, 4, 64)
    args = _bwd_args(shape, torch.bfloat16, True, 0, cuda)
    q, k, v = args[:3]
    first = attn.flash_fwd(q, k, v, True, 0)
    second = attn.flash_fwd(q, k, v, True, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    first = attn.flash_bwd_dq(*args, True, 0)
    second = attn.flash_bwd_dq(*args, True, 0)
    assert torch.equal(first, second)
    first = attn.flash_bwd_dkv(*args, True, 0)
    second = attn.flash_bwd_dkv(*args, True, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# The Hopper forward, dQ and dK/dV (wgmma, TMA) at the cases that
# stress them: head dims 16 (the demo draft's), 40 (zero-padded past a
# multiple of 16), 64 and 128; lengths 17 and 1000 (ragged against every
# tile); the window band; B 1 at S 1920 (one consumer warpgroup a
# block) and grids that fill the card (three consumers at D 64, two at
# D 128).
HOPPER_CASES = [
    ((2, 17, 8, 16), True, 0),
    ((1, 1920, 8, 16), True, 0),
    ((2, 1000, 4, 40), True, 0),
    ((1, 1920, 8, 64), True, 0),
    ((1, 1000, 8, 64), True, 512),
    ((8, 512, 8, 64), False, 0),
    ((8, 1000, 8, 64), True, 128),
    ((4, 1000, 8, 128), True, 256),
    ((4, 1024, 8, 128), True, 0),
]


@pytest.mark.parametrize("shape,causal,window", HOPPER_CASES)
def test_hopper_kernels_match_plain_versions(cuda, shape, causal, window):
    args = _bwd_args(shape, torch.bfloat16, causal, window, cuda)
    q, k, v, do, lse, delta = args
    assert attn.tma_rows(q, k, v, do) == 1
    before = [kern.launches for kern in attn.KERNELS]
    o, got_lse = attn.flash_fwd(q, k, v, causal, window)
    dq = attn.flash_bwd_dq(*args, causal, window)
    dk, dv = attn.flash_bwd_dkv(*args, causal, window)
    torch.cuda.synchronize()
    assert [kern.launches for kern in attn.KERNELS] == [
        n + 1 for n in before]
    ro, rl = attn.flash_attention_reference(q, k, v, causal, window)
    _assert_near(o, ro, torch.bfloat16, "o")
    torch.testing.assert_close(got_lse, rl, rtol=2e-2, atol=2e-2)
    rq = attn.flash_attention_dq_reference(*args, causal, window)
    _assert_near(dq, rq, torch.bfloat16, "dq")
    rk, rv = attn.flash_attention_dkv_reference(*args, causal, window)
    _assert_near(dk, rk, torch.bfloat16, "dk")
    _assert_near(dv, rv, torch.bfloat16, "dv")


@pytest.mark.parametrize("shape", [(1, 1920, 8, 64), (8, 512, 8, 64),
                                   (4, 1024, 8, 128)])
def test_hopper_kernels_are_deterministic(cuda, shape):
    """One and several consumer warpgroups a block: two launches give
    bitwise-equal outputs (one owner block a tile, no atomics)."""
    args = _bwd_args(shape, torch.bfloat16, True, 0, cuda)
    first = attn.flash_fwd(*args[:3], True, 0)
    second = attn.flash_fwd(*args[:3], True, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    first = attn.flash_bwd_dq(*args, True, 0)
    second = attn.flash_bwd_dq(*args, True, 0)
    assert torch.equal(first, second)
    first = attn.flash_bwd_dkv(*args, True, 0)
    second = attn.flash_bwd_dkv(*args, True, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# The Hopper forward, dQ and dK/dV at kernel head dims 136-256 (DMAX
# 256; 136 and 192 zero-filled by TMA past their last column): causal
# at S 17 and 2048, the W 200 band at S 1000, a ragged S 150 with the W
# 64 band.
WIDE_HOPPER_CASES = [
    ((2, 17, 2, 136), True, 0),
    ((2, 17, 2, 192), True, 0),
    ((2, 17, 2, 256), True, 0),
    ((1, 2048, 2, 136), True, 0),
    ((1, 2048, 2, 192), True, 0),
    ((1, 2048, 2, 256), True, 0),
    ((1, 1000, 2, 256), True, 200),
    ((2, 150, 4, 256), True, 64),
]


@pytest.mark.parametrize("shape,causal,window", WIDE_HOPPER_CASES)
def test_hopper_backward_at_head_dims_136_to_256(cuda, shape, causal,
                                                  window):
    args = _bwd_args(shape, torch.bfloat16, causal, window, cuda)
    q, k, v = args[:3]
    kd, _ = attn.head_dim_route(shape[3])
    assert attn.kernel_route(kd, *args[:4]) == attn.ROUTE_HOPPER
    before = [(kern.launches, kern.hopper_launches)
              for kern in attn.KERNELS]
    o, got_lse = attn.flash_fwd(q, k, v, causal, window)
    dq = attn.flash_bwd_dq(*args, causal, window)
    dk, dv = attn.flash_bwd_dkv(*args, causal, window)
    torch.cuda.synchronize()
    assert [(kern.launches, kern.hopper_launches)
            for kern in attn.KERNELS] == [(n + 1, m + 1) for n, m in before]
    ro, rl = attn.flash_attention_reference(q, k, v, causal, window)
    _assert_near(o, ro, torch.bfloat16, "o")
    torch.testing.assert_close(got_lse, rl, rtol=2e-2, atol=2e-2)
    rq = attn.flash_attention_dq_reference(*args, causal, window)
    _assert_near(dq, rq, torch.bfloat16, "dq")
    rk, rv = attn.flash_attention_dkv_reference(*args, causal, window)
    _assert_near(dk, rk, torch.bfloat16, "dk")
    _assert_near(dv, rv, torch.bfloat16, "dv")


def test_wide_hopper_forward_is_deterministic(cuda):
    """D 256 on the Hopper forward: two launches give bitwise-equal O
    and lse (one owner block a 64-row tile, no atomics)."""
    q, k, v = _bwd_args((2, 1000, 4, 256), torch.bfloat16, True, 0,
                        cuda)[:3]
    first = attn.flash_fwd(q, k, v, True, 0)
    second = attn.flash_fwd(q, k, v, True, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_wide_hopper_backward_is_deterministic(cuda):
    """D 256 on the Hopper dQ and dK/dV: two launches give bitwise-equal
    outputs (one owner block a tile, no atomics)."""
    args = _bwd_args((2, 1000, 4, 256), torch.bfloat16, True, 0, cuda)
    assert torch.equal(attn.flash_bwd_dq(*args, True, 0),
                       attn.flash_bwd_dq(*args, True, 0))
    first = attn.flash_bwd_dkv(*args, True, 0)
    second = attn.flash_bwd_dkv(*args, True, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _wide_rows(kind, shape, device):
    """q, k, v, dO at ``shape`` (D 256): "tma" plain tensors, "broadcast"
    k and v expanded over the heads, "misaligned" slices of one fused
    projection one element in."""
    b, s, h, d = shape
    gen = torch.Generator(device=device).manual_seed(3)

    def randn(*size):
        return torch.randn(size, generator=gen, device=device,
                           dtype=torch.bfloat16)

    if kind == "misaligned":
        fused = randn(b, s, 4 * h * d + 1)
        return [fused[:, :, 1 + i * h * d:1 + (i + 1) * h * d]
                .unflatten(-1, (h, d)) for i in range(4)]
    q, do = randn(*shape), randn(*shape)
    if kind == "broadcast":
        k, v = (randn(b, s, 1, d).expand(shape) for _ in range(2))
    else:
        k, v = randn(*shape), randn(*shape)
    return [q, k, v, do]


@pytest.mark.parametrize("kind,want", [
    ("tma", ("flash_fwd_wgmma_tc_kernel<256, 2>",
             "flash_bwd_dq_wgmma_tc_kernel<256, 1>",
             "flash_bwd_dkv_wgmma_tc_kernel<256, 2>")),
    ("broadcast", ("flash_fwd_wide_tc_kernel",
                   "flash_bwd_dq_wide_tc_kernel",
                   "flash_bwd_dkv_wide_tc_kernel")),
    ("misaligned", ("flash_fwd_wide_tc_kernel",
                    "flash_bwd_dq_wide_tc_kernel",
                    "flash_bwd_dkv_wide_tc_kernel")),
])
def test_wide_backward_runs_the_kernels_of_its_route(cuda, kind, want):
    """At D 256 rows a tensor map describes run the Hopper forward, dQ
    and dK/dV; k and v broadcast over the heads, or rows off 16 bytes,
    the wide mma.sync kernels: the kernels a profiler records for the
    three calls. Each agrees with the plain versions."""
    from torch.profiler import ProfilerActivity, profile

    shape = (2, 150, 4, 256)
    q, k, v, do = _wide_rows(kind, shape, cuda)
    ro, lse = attn.flash_attention_reference(q, k, v, True, 64)
    delta = (do.float() * ro.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, 64)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o, got_lse = attn.flash_fwd(q, k, v, True, 64)
        dq = attn.flash_bwd_dq(*args)
        dk, dv = attn.flash_bwd_dkv(*args)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "flash_" in e.key]
    assert len(names) == 3 and all(
        any(w in n for n in names) for w in want), names
    _assert_near(o, ro, torch.bfloat16, "o")
    torch.testing.assert_close(got_lse, lse, rtol=2e-2, atol=2e-2)
    _assert_near(dq, attn.flash_attention_dq_reference(*args), torch.bfloat16,
                 "dq")
    rk, rv = attn.flash_attention_dkv_reference(*args)
    _assert_near(dk, rk, torch.bfloat16, "dk")
    _assert_near(dv, rv, torch.bfloat16, "dv")


def test_first_launch_in_a_fresh_thread(cuda):
    """A host thread's first launch of each Hopper kernel succeeds when
    the caching allocator serves every tensor it allocates, so the
    thread has made no runtime call that would make a context current:
    the tensor maps' encoder, a driver call, needs one (a profile
    capture's launch thread died of it). The outputs equal the same
    launches' on this thread, bitwise."""
    import threading

    results = {}
    inputs = {d: _bwd_args((2, 512, 4, d), torch.bfloat16, True, 0, cuda)
              for d in (64, 256)}

    def run(into):
        for d, args in inputs.items():
            into[d] = (attn.flash_fwd(*args[:3], True, 0),
                       attn.flash_bwd_dq(*args, True, 0),
                       attn.flash_bwd_dkv(*args, True, 0))
        torch.cuda.synchronize()

    # The same launches once, their outputs freed: the thread's come
    # from the allocator's cache.
    run({})
    errors = []

    def thread():
        try:
            run(results)
        except RuntimeError as err:
            errors.append(repr(err))

    t = threading.Thread(target=thread)
    t.start()
    t.join(timeout=120)
    assert not errors, errors
    want = {}
    run(want)
    for d in inputs:
        for got, exp in zip(results[d], want[d]):
            got = got if isinstance(got, tuple) else (got,)
            exp = exp if isinstance(exp, tuple) else (exp,)
            assert all(torch.equal(a, b) for a, b in zip(got, exp)), d


def test_broadcast_rows_take_the_mma_sync_kernels(cuda):
    """k and v broadcast over the heads (stride 0): no TMA tensor map
    describes them, so the forward, dQ and dK/dV take their mma.sync
    kernels (``tma_rows`` 0), count the launch, and agree."""
    b, s, h, d = 2, 150, 4, 64
    q, do = _qkv((b, s, h, d), torch.bfloat16, 5, cuda)[:2]
    k, v = (x.expand(b, s, h, d) for x in
            _qkv((b, s, 1, d), torch.bfloat16, 6, cuda)[:2])
    assert attn.rows_aligned(q, k, v, do) == 1
    assert attn.tma_rows(q, k, v, do) == 0
    before = [kern.launches for kern in attn.KERNELS]
    o, lse = attn.flash_fwd(q, k, v, True, 0)
    ro, rl = attn.flash_attention_reference(q, k, v, True, 0)
    _assert_near(o, ro, torch.bfloat16, "o")
    delta = (do.float() * ro.float()).sum(-1)
    dq = attn.flash_bwd_dq(q, k, v, do, rl, delta, True, 0)
    dk, dv = attn.flash_bwd_dkv(q, k, v, do, rl, delta, True, 0)
    torch.cuda.synchronize()
    assert [kern.launches for kern in attn.KERNELS] == [
        n + 1 for n in before]
    rq = attn.flash_attention_dq_reference(q, k, v, do, rl, delta, True, 0)
    _assert_near(dq, rq, torch.bfloat16, "dq")
    rk, rv = attn.flash_attention_dkv_reference(q, k, v, do, rl, delta,
                                                True, 0)
    _assert_near(dk, rk, torch.bfloat16, "dk")
    _assert_near(dv, rv, torch.bfloat16, "dv")


def test_autograd_runs_the_three_kernels(cuda):
    """flash_attention_lse's gradients on the card, through the
    forward, dQ and dK/dV kernels, against autograd of the plain
    forward; q/k/v are slices of one fused projection."""
    fused = torch.randn((2, 150, 3, 4, 64), device=cuda,
                        dtype=torch.float32, requires_grad=True)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    g_o = torch.randn((2, 150, 4, 64), device=cuda)
    g_lse = torch.randn((2, 150, 4), device=cuda)
    counts = [kern.launches for kern in attn.KERNELS]
    got = torch.autograd.grad(attn.flash_attention_lse(q, k, v, causal=True),
                              fused, (g_o, g_lse))[0]
    assert [kern.launches for kern in attn.KERNELS] == [c + 1 for c in counts]
    want = torch.autograd.grad(
        attn.flash_attention_reference(q, k, v, True), fused,
        (g_o, g_lse))[0]
    _assert_near(got, want, torch.float32, "d(qkv)")


def _assert_dlogits_near(got, want, dtype):
    """Element by element, |got - want| <= rtol * (|want| + mean|want|):
    almost every entry is a softmax term far below the label's, so a
    bound tied to the largest value would miss a wrong softmax. f32
    1e-4 (a few f32 units apart); bf16 1e-2 (at most one bf16 unit,
    2**-7 relative, after rounding)."""
    rtol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    got, want = got.float(), want.float()
    scaled = float(((got - want).abs()
                    / (want.abs() + want.abs().mean())).max())
    assert scaled <= rtol, f"dlogits: scaled error {scaled} > {rtol}"


@pytest.mark.parametrize("n,c,dtype,aligned", [
    (200, 333, torch.float32, True),
    (300, 2052, torch.float32, True),  # 16-byte loads, ragged row end
    (64, 32000, torch.float32, True),
    (64, 32000, torch.float32, False),
    (50, 1000, torch.bfloat16, True),
])
def test_xent_kernels_match_plain_versions(cuda, n, c, dtype, aligned):
    gen = torch.Generator(device=cuda).manual_seed(c)
    base = torch.empty(n * c + 1, device=cuda, dtype=dtype)
    logits = (base[:n * c] if aligned else base[1:]).view(n, c)
    logits.copy_(3 * torch.randn((n, c), generator=gen, device=cuda))
    labels = torch.randint(0, c, (n,), generator=gen, device=cuda)
    labels[0], labels[1] = -1, c + 7  # outside [0, C): no class matches
    g = torch.randn((n,), generator=gen, device=cuda)
    before = (xent.xent_fwd.launches, xent.xent_bwd.launches)
    loss = xent.xent_fwd(logits, labels)
    dlogits = xent.xent_bwd(logits, labels, g)
    torch.cuda.synchronize()
    assert (xent.xent_fwd.launches, xent.xent_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_near(loss, xent.softmax_cross_entropy_reference(logits, labels),
                 torch.float32, "loss")
    want = xent.softmax_cross_entropy_bwd_reference(logits, labels, g)
    _assert_near(dlogits, want, dtype, "dlogits")
    _assert_dlogits_near(dlogits, want, dtype)


def test_xent_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        xent.softmax_cross_entropy(torch.zeros((2, 4), device=cuda,
                                               dtype=torch.float16),
                                   torch.zeros(2, dtype=torch.long,
                                               device=cuda))


def test_trainer_two_steps_on_the_card(cuda):
    """Two steps of a small LM through the kernels: every kernel
    launches as often as the path needs, the losses are finite, and a
    step's gradients agree with the plain path's (relative L2 within
    2e-2: bf16 compute rounds at other points in the two paths)."""
    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=64)
    tree = convert.init_flax_layout_params(config, 0)
    model = convert.load_lm(config, tree, device="cuda", trainable=True)
    loss_fn = transformer.next_token_loss_fn(xent.mean_cross_entropy_loss)
    trainer = Trainer(model, loss_fn, Sgd(0.1, momentum=0.9))
    state = trainer.init_state()
    batches = SyntheticTokenLoader(2, 64, 128, device="cuda")
    kernels = attn.KERNELS + xent.KERNELS
    before = [kern.launches for kern in kernels]
    losses = []
    for _ in range(2):
        state, loss = trainer.train_step(state, next(batches))
        losses.append(float(loss))
    layers = config["num_layers"]
    assert [kern.launches - b for kern, b in zip(kernels, before)] == [
        2 * layers, 2 * layers, 2 * layers, 2, 2]
    assert all(math.isfinite(x) for x in losses)

    def grads(attention_fn, loss):
        m = convert.load_lm(config, tree, device="cuda", trainable=True,
                            attention_fn=attention_fn)
        tokens = next(SyntheticTokenLoader(2, 64, 128, device="cuda"))[0]
        value = transformer.next_token_loss_fn(loss)(m(tokens), tokens)
        value.backward()
        return float(value.detach()), {
            n: p.grad for n, p in m.named_parameters()}

    def plain(q, k, v, causal):
        return attn.flash_attention_reference(q, k, v, causal)[0]

    kernel_loss, kernel_grads = grads(None, xent.mean_cross_entropy_loss)
    plain_loss, plain_grads = grads(plain, cross_entropy_loss)
    assert abs(kernel_loss - plain_loss) <= 1e-3 * abs(plain_loss)
    for name, want in plain_grads.items():
        got = kernel_grads[name]
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= 2e-2, f"{name}: relative L2 error {rel}"


def test_resnet_step_on_the_card(cuda):
    """One train step of ResNet-18 (width 16, 10 classes, 32x32, batch
    8) on the card: the fused loss launches the cross-entropy forward
    and backward once each and no attention kernel; against the same
    step on the plain loss (same weights and batch) the loss agrees
    within 1e-5 relative (the same logits, summed in another order),
    each gradient within 5e-2 relative L2 (the bf16 backward rounds
    dlogits that differ by f32 units) and the running statistics
    within 1e-6 (the forward does not see the loss)."""
    model = resnet(18, 10, width=16, device="meta")
    variables = convert.init_flax_layout_image(model, 0)
    batch = next(SyntheticLoader(8, (32, 32, 3), 10, device=cuda))

    def step(loss_fn):
        m = convert.load_image_model(resnet(18, 10, width=16, device="meta")
                                     .to_empty(device=cuda), variables)
        trainer = Trainer(m.train(), loss_fn, Sgd(0.1, momentum=0.9))
        _, loss = trainer.train_step(trainer.init_state(), batch)
        return (float(loss), {n: p.grad for n, p in m.named_parameters()},
                dict(m.named_buffers()))

    kernels = attn.KERNELS + xent.KERNELS
    before = [kern.launches for kern in kernels]
    kernel_loss, kernel_grads, kernel_stats = step(
        xent.mean_cross_entropy_loss)
    assert [kern.launches - b for kern, b in zip(kernels, before)] == [
        0, 0, 0, 1, 1]
    plain_loss, plain_grads, plain_stats = step(cross_entropy_loss)
    assert math.isfinite(kernel_loss)
    assert abs(kernel_loss - plain_loss) <= 1e-5 * abs(plain_loss)
    for name, want in plain_grads.items():
        got = kernel_grads[name]
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert rel <= 5e-2, f"{name}: relative L2 error {rel}"
    for name, want in plain_stats.items():
        torch.testing.assert_close(kernel_stats[name], want, rtol=0,
                                   atol=1e-6)


def test_verify_chunk_on_the_card_against_single_steps(cuda):
    """Speculation's verify: a width-4 chunk attending the cache (at an
    int offset, as speculative_decode runs it, and at per-row positions
    through block tables, as the paged engine runs it) gives the logits
    of 4 single-token steps, within the bf16 limit (2e-2 of the largest
    logit: the chunk and the steps round at other points)."""
    model = _card_lm()
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, 128, (2, 9), generator=gen).cuda()
    chunk = torch.randint(0, 128, (2, 4), generator=gen).cuda()
    with torch.inference_mode():
        steps_cache = model.init_cache(2, 20)
        model(prompt, steps_cache, 0)
        chunk_cache = [tuple(a.clone() for a in layer)
                       for layer in steps_cache]
        want = torch.cat([model(chunk[:, j:j + 1], steps_cache, 9 + j)
                          for j in range(4)], dim=1).float()
        got = model(chunk, chunk_cache, 9, chunk_attends_cache=True)
        arena = model.init_paged_cache(11, 4)
        tables = torch.arange(10, device="cuda").reshape(2, 5)
        for layer, dense in zip(arena, chunk_cache):
            for a, d in zip(layer, dense):
                a[:10] = d[:, :20].reshape(10, 4, *d.shape[2:])
        paged = model(chunk, arena, torch.tensor([9, 9], device="cuda"),
                      block_table=tables)
    limit = TOL[torch.bfloat16] * want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= limit
    assert (paged.float() - want).abs().max().item() <= limit
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_spec_engine_counts_on_the_card_equal_the_cpu_engine(cuda):
    """A self-draft engine (k 4) on the card and on the CPU, f32, both
    pools: the same tokens and the same counts every step on a short
    trace of two greedy rows."""
    from container_engine_accelerators_tpu_torch.models import speculative
    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=64)
    tree = convert.init_flax_layout_params(config, 0)
    models = {dev: convert.load_lm(config, tree, device=dev,
                                   dtype=torch.float32)
              for dev in ("cuda", "cpu")}
    prompts = [np.random.default_rng(n).integers(0, 128, n)
               for n in (5, 11)]
    for paged in (False, True):
        runs = {}
        for dev, model in models.items():
            eng = decode.SlotDecodeEngine(model, slots=2, slot_len=40,
                                          paged=paged, kv_block_size=8,
                                          draft_model=model, spec_k=4)
            trace = [eng.admit(p, len(p), max_new=16)[1] for p in prompts]
            for _ in range(5):
                toks, _, counts = eng.step()
                trace.append((toks.tolist(), counts.tolist()))
            runs[dev] = trace
            assert eng.spec_accepted > 0
        assert runs["cuda"] == runs["cpu"]
    want = speculative.speculative_decode(models["cpu"], models["cpu"],
                                          prompts[1][None], 12, k=4)
    got = speculative.speculative_decode(models["cuda"], models["cuda"],
                                         prompts[1][None], 12, k=4)
    assert got.cpu().tolist() == want.tolist()


def test_predict_server_on_the_card_answers_as_the_forward(cuda):
    """The image predict server with ResNet-18 (width 16, 10 classes,
    32x32) on the card: each prediction is the argmax and top softmax
    probability of the same model's eval forward on the same padded
    batch, run directly (bf16 compute: classes equal or at a near tie,
    2e-2 of the largest logit; scores within 2e-2)."""
    from container_engine_accelerators_tpu_torch.serving import server
    model = resnet(18, 10, width=16, device="meta")
    model = convert.load_image_model(
        model.to_empty(device=cuda), convert.init_flax_layout_image(model, 0))
    srv = server.InferenceServer("resnet", model, (32, 32, 3), port=0,
                                 max_batch=4, host="127.0.0.1")
    try:
        images = np.random.default_rng(0).standard_normal(
            (3, 32, 32, 3)).astype(np.float32)
        code, body = srv._handle_post({"instances": images.tolist()})
        assert code == 200
        padded = np.zeros((4, 32, 32, 3), np.float32)
        padded[:3] = images
        with torch.inference_mode():
            logits = model.eval()(torch.from_numpy(padded).cuda()).float()
        probs = torch.softmax(logits, -1)
        for i, pred in enumerate(body["predictions"]):
            row = logits[i]
            if pred["class"] != int(row.argmax()):
                gap = float(row.max() - row[pred["class"]])
                assert gap <= 2e-2 * float(row.abs().max())
            assert abs(pred["score"] - float(probs[i].max())) <= 2e-2
    finally:
        srv.stop()


def test_dense_replay_on_the_card_launches_the_kernel(cuda):
    """A step fault in a supervised dense-pool engine service on the
    card (f32): the rebuilt engine replays each row as one admission of
    prompt plus delivered tokens, each launching the flash kernel once
    per layer, and the streams equal greedy_decode."""
    from container_engine_accelerators_tpu_torch.serving import server
    from container_engine_accelerators_tpu_torch.utils import faults
    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=64)
    model = convert.load_lm(config, convert.init_flax_layout_params(
        config, 0), device="cuda", dtype=torch.float32)

    def factory():
        return decode.SlotDecodeEngine(model, 2, 48, paged=False)

    svc = server._EngineService(factory(), server._Admission(0),
                                engine_factory=factory)
    prompts = [np.random.default_rng(n).integers(0, 128, n) for n in (5, 17)]
    works = []
    for i, p in enumerate(prompts):
        row = np.zeros((32,), np.int32)
        row[:len(p)] = p
        works.append(server._EngineWork(row, len(p), 8, 0.0, 0, 1.0, 0.0,
                                        1.0, -1, False, i, None))
    before = attn.flash_fwd.launches
    faults.install({"step": [2]})
    try:
        assert svc.submit_many(works) is not None
        for w in works:
            status, out = w.done.get(timeout=120)
            assert status == "ok", out
    finally:
        faults.reset()
        svc.stop()
    stats = svc.stats()
    assert stats["engine_rebuilds"] == 1 and stats["replayed_rows"] == 2
    # Two admissions and two replay admissions, one launch a layer each.
    assert attn.flash_fwd.launches - before == 4 * config["num_layers"]
    assert dict(svc.engine.prefill_widths) == {len(p) + 3: 1
                                               for p in prompts}
    for p, w in zip(prompts, works):
        want = decode.greedy_decode(model, torch.tensor(p)[None], 8)
        assert w.tokens == want[0, len(p):].tolist()


def test_moe_routing_forms_agree_on_the_card(cuda):
    """One routed layer at the serving width (T 2048, d 512, 8 experts,
    bf16 tokens and experts, f32 gate): the index form's slot
    assignment and weights equal the dense form's exactly and the CPU
    index form's on the same logits; its output lies within the bf16
    rule of ``dense_moe_reference``'s, aux within 1e-5."""
    from container_engine_accelerators_tpu_torch.parallel import expert
    gen = torch.Generator().manual_seed(0)
    t, d, e = 2048, 512, 8
    # A shared offset skews the routing: the preferred experts overflow.
    tokens = (torch.randn((t, d), generator=gen)
              + torch.randn((1, d), generator=gen)).bfloat16()
    gate = torch.randn((d, e), generator=gen) * d ** -0.5
    w_in = (torch.randn((e, d, 4 * d), generator=gen)
            * (e * d) ** -0.5).bfloat16()
    w_out = (torch.randn((e, 4 * d, d), generator=gen)
             * (4 * e * d) ** -0.5).bfloat16()
    cap = expert.expert_capacity(t, e, 1.25, 2)
    logits = tokens.cuda().float() @ gate.cuda()
    dispatch, combine, aux_dense = expert.top_k_routing(logits, cap)
    idx, slot, keep, weight, aux_idx = expert.top_k_routing_indices(logits,
                                                                    cap)
    rows = torch.arange(t, device=cuda)[:, None].expand_as(idx)
    rebuilt = torch.zeros_like(dispatch)
    rebuilt[rows[keep], idx[keep], slot[keep]] = 1.0
    weights = torch.zeros_like(combine)
    weights[rows[keep], idx[keep], slot[keep]] = weight[keep]
    assert torch.equal(rebuilt, dispatch) and torch.equal(weights, combine)
    assert float(aux_idx) == float(aux_dense)
    assert 0 < int((~keep).sum()) < t      # the group drops some choices
    cpu = expert.top_k_routing_indices(logits.cpu(), cap)
    for got, want in zip((idx, slot, keep), cpu[:3]):
        assert torch.equal(got.cpu(), want)
    args = [x.cuda() for x in (tokens, gate, w_in, w_out)]
    out, aux = expert.dense_moe(*args)
    ref, ref_aux = expert.dense_moe_reference(*args)
    _assert_near(out, ref, torch.bfloat16, "moe output")
    assert abs(float(aux) - float(ref_aux)) <= 1e-5


def test_moe_trainer_step_launches_on_the_card(cuda):
    """One step of a small MoE (2 layers: layer 1 routed over 4
    experts) through the kernels: flash forward, dQ and dK/dV once a
    layer and the fused cross-entropy once each way; the loss (with
    the router's aux) is finite and the gate and the experts get
    gradients."""
    from container_engine_accelerators_tpu_torch.models import moe
    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=64,
                  num_experts=4)
    tree = convert.init_flax_layout_params(config, 0)
    model = convert.load_lm(config, tree, device="cuda", trainable=True)
    assert isinstance(model, moe.MoETransformerLM)
    loss_fn = moe.with_router_loss(transformer.next_token_loss_fn(
        xent.mean_cross_entropy_loss))
    trainer = Trainer(model, loss_fn, Sgd(0.1, momentum=0.9))
    state = trainer.init_state()
    batch = next(SyntheticTokenLoader(2, 64, 128, device="cuda"))
    kernels = attn.KERNELS + xent.KERNELS
    before = [kern.launches for kern in kernels]
    routed = model.blocks[1].moe
    w_in = routed.w_in.detach().clone()
    state, loss = trainer.train_step(state, batch)
    assert [kern.launches - b for kern, b in zip(kernels, before)] == [
        2, 2, 2, 1, 1]
    assert math.isfinite(float(loss))
    for p in (routed.gate, routed.w_in, routed.w_out):
        assert p.grad is not None and float(p.grad.abs().sum()) > 0
    assert not torch.equal(routed.w_in.detach(), w_in)


def test_prefetch_loader_to_the_card_gives_the_host_batches(cuda):
    """PrefetchLoader(device="cuda"): pinned copies on a side stream,
    waited on by the consumer's stream. Each batch (64 MB of images) is
    read on the card the moment ``next()`` returns and equals the host
    batch; the tensors are on the card with their dtypes."""
    from container_engine_accelerators_tpu_torch.parallel import (
        PrefetchLoader,
    )
    rng = np.random.default_rng(0)
    source = [(rng.standard_normal((64, 256, 1024), dtype=np.float32),
               np.arange(64, dtype=np.int32) + i) for i in range(6)]
    got = []
    with PrefetchLoader(iter(source), device="cuda") as loader:
        for images, labels in loader:
            assert images.device.type == "cuda"
            assert images.dtype == torch.float32
            assert labels.dtype == torch.int32
            # Read on the current stream at once: a half-copied batch
            # would differ.
            got.append((images.sum(dtype=torch.float64),
                        images[:, -1, -8:].clone(), labels.clone()))
    torch.cuda.synchronize()
    assert len(got) == len(source)
    for (total, tail, labels), (images, want) in zip(got, source):
        np.testing.assert_allclose(float(total),
                                   images.sum(dtype=np.float64), rtol=1e-9)
        np.testing.assert_array_equal(tail.cpu().numpy(),
                                      images[:, -1, -8:])
        np.testing.assert_array_equal(labels.cpu().numpy(), want)


def test_async_save_on_the_card_archives_its_own_step(cuda, tmp_path):
    """The checkpoint snapshot copies the card's parameters and momentum
    to the host before save() returns: two more steps before the
    background write runs do not reach the archive."""
    import threading

    from container_engine_accelerators_tpu_torch.parallel import checkpoint
    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=64)
    model = convert.load_lm(config, convert.init_flax_layout_params(
        config, 0), device="cuda", trainable=True)
    trainer = Trainer(model, transformer.next_token_loss_fn(
        xent.mean_cross_entropy_loss), Sgd(0.1, momentum=0.9))
    state = trainer.init_state()
    batches = SyntheticTokenLoader(2, 64, 128, device="cuda")
    state, _ = trainer.train_step(state, next(batches))
    payload = checkpoint.state_payload(state, config)
    copy = {k: v.detach().cpu().numpy().copy() if torch.is_tensor(v)
            else np.array(v) for k, v in checkpoint.keystr_items(payload)}
    mgr = checkpoint.CheckpointManager(tmp_path)
    gate = threading.Event()
    write = mgr._write
    mgr._write = lambda *args: (gate.wait(30), write(*args))[1]
    mgr.save(payload, step=state.step)
    for _ in range(2):
        state, _ = trainer.train_step(state, next(batches))
    torch.cuda.synchronize()
    gate.set()
    mgr.wait_until_finished()
    with np.load(tmp_path / "checkpoint_1" / "arrays.npz") as raw:
        assert sorted(raw.files) == sorted(copy)
        for key in copy:
            np.testing.assert_array_equal(raw[key], copy[key], err_msg=key)
    live = convert.params_to_flax(state.model, config)
    assert not np.array_equal(live["lm_head"]["kernel"],
                              copy["['params']['lm_head']['kernel']"])


def test_memory_monitor_reads_the_card(cuda):
    """The allocator monitor on the card: in-use bytes, the peak and the
    card's total; the watermark survives an allocator peak reset."""
    from container_engine_accelerators_tpu_torch.obs import memory

    mon = memory.MemoryMonitor(soft_limit=0.99)
    block = torch.empty(64 << 20, dtype=torch.uint8, device=cuda)
    stats = mon.sample()
    label = str(torch.device("cuda", 0))
    total = torch.cuda.mem_get_info(0)[1]
    assert stats[label]["bytes_in_use"] >= block.numel()
    assert stats[label]["bytes_limit"] == total
    peak = torch.cuda.max_memory_allocated()
    del block
    torch.cuda.reset_peak_memory_stats()
    mon.sample()
    totals = mon.totals()
    assert peak <= totals["hbm_peak_bytes"] <= total
    assert totals["hbm_in_use_bytes"] <= totals["hbm_peak_bytes"]


def test_profile_capture_names_the_flash_kernel(cuda, tmp_path):
    """/debug/profile's capture on the card records the kernels that
    another thread launches during the window."""
    import json
    import threading

    from container_engine_accelerators_tpu_torch.obs import profiler

    q, k, v = _qkv((2, 512, 8, 64), torch.bfloat16, 0, cuda)
    stop = threading.Event()

    def launch():
        while not stop.is_set():
            attn.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()

    t = threading.Thread(target=launch)
    t.start()
    try:
        result = profiler.ProfileCapture().capture(
            seconds=0.5, out_dir=str(tmp_path))
    finally:
        stop.set()
        t.join(timeout=30)
    with open(result["trace"]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    assert any("flash_fwd_wgmma_tc_kernel" in n for n in names), names


def test_flop_count_on_the_card_equals_the_cpu_count(cuda):
    """count_flops over a flash forward and backward gives the kernels'
    declared products on the card, as the plain versions' count does on
    the CPU."""
    from container_engine_accelerators_tpu_torch.obs import efficiency

    b, s, h, d = 2, 256, 4, 64

    def fwd_bwd(device, dtype):
        gen = torch.Generator(device=device).manual_seed(0)
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=device,
                               dtype=dtype).requires_grad_()
                   for _ in range(3))
        return efficiency.count_flops(
            lambda: attn.flash_attention(q, k, v, causal=True)
            .float().sum().backward())[1]

    want = 18 * d * attn.kept_pairs(s, True, 0) * b * h
    assert fwd_bwd(cuda, torch.bfloat16) == want
    assert fwd_bwd(torch.device("cpu"), torch.float32) == want


@pytest.fixture
def nccl_group(cuda):
    """A one-rank NCCL process group on the card for the test."""
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import (
        distributed,
    )

    distributed.start_local_group("cuda:0")
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_trainer_in_a_one_rank_nccl_group_equals_no_group(nccl_group):
    """Two steps of a small LM as the one rank of an NCCL mesh, with and
    without FSDP, against the same steps without a group: the kernels
    launch as often, and the losses and parameters are bitwise equal
    (every collective is over one rank and every mean divides by 1)."""
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        build_mesh,
    )

    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=64)
    tree = convert.init_flax_layout_params(config, 0)
    kernels = attn.KERNELS + xent.KERNELS

    def run(mesh, fsdp=False):
        model = convert.load_lm(config, tree, device="cuda", trainable=True)
        trainer = Trainer(
            model, transformer.next_token_loss_fn(xent.mean_cross_entropy_loss),
            Sgd(0.1, momentum=0.9), mesh=mesh, fsdp=fsdp)
        state = trainer.init_state()
        batches = SyntheticTokenLoader(2, 64, 128, device="cuda")
        before = [kern.launches for kern in kernels]
        losses = [float(trainer.train_step(state, next(batches))[1])
                  for _ in range(2)]
        launched = [kern.launches - b for kern, b in zip(kernels, before)]
        return losses, launched, {n: p.detach().clone()
                                  for n, p in model.named_parameters()}

    want = run(None)
    for fsdp in (False, True):
        got = run(build_mesh(), fsdp)
        assert got[0] == want[0] and got[1] == want[1] == [4, 4, 4, 2, 2]
        for name, value in want[2].items():
            assert torch.equal(got[2][name], value), name


def test_collectives_on_a_one_rank_nccl_group(nccl_group):
    """Each explicit collective over a one-rank NCCL axis is the
    identity (the ring with n = 1 included) and leaves the tensor on
    the card."""
    from container_engine_accelerators_tpu_torch.parallel import collectives
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        build_mesh,
    )

    mesh = build_mesh()
    x = torch.randn(8, 3, device="cuda")
    for fn in (collectives.all_reduce_mean, collectives.all_gather,
               collectives.reduce_scatter, collectives.ring_all_reduce):
        out = fn(mesh, x)
        assert out.is_cuda and torch.equal(out, x), fn.__name__


def test_program_guard_on_a_card_engine(cuda):
    """The guard holds a small paged engine on the card to its bound
    over mixed prompt lengths, and counts a CUDA-graph capture against
    a budget of 0."""
    from container_engine_accelerators_tpu_torch.analysis import programs

    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=96)
    model = convert.load_lm(config, convert.init_flax_layout_params(
        config, 0), device="cuda")
    engine = decode.SlotDecodeEngine(model, slots=2, slot_len=96,
                                     paged=True, kv_block_size=8,
                                     buckets=(16, 32, 64))
    rng = np.random.default_rng(0)
    guard = programs.engine_guard(engine)
    with guard:
        for n in (5, 12, 20, 40, 33, 9):
            slot = engine.admit(rng.integers(0, 128, n), n, max_new=8)[0]
            for _ in range(3):
                engine.step()
            engine.release(slot)
    counts = guard.programs()
    assert counts["engine.prefill"] <= 3 and counts["engine.step"] == 1
    assert counts["engine.insert"] == 1
    assert counts["cuda_graph.capture"] == 0
    graphs = programs.ProgramGuard().watch_captures()
    with pytest.raises(programs.ProgramBoundError, match="cuda_graph"):
        with graphs:
            x = torch.zeros(4, device="cuda")
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                x.add_(1)


def test_ring_attention_on_the_card_equals_flash(nccl_group):
    """ring_attention on a one-rank context axis (use_flash follows the
    CUDA tensors: one diagonal hop through flash_attention_lse and the
    merge) against flash_attention: the output and dQ/dK/dV bitwise
    (the merge multiplies by exactly 1 and the lse cotangent is 0), one
    launch of each kernel; the plain schedule (use_flash=False) on the
    same tensors within 2e-2 of the largest value."""
    from container_engine_accelerators_tpu_torch.parallel import context

    mesh = context.build_context_mesh(context=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((2, 256, 4, 64), generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = [kern.launches for kern in attn.KERNELS]
        out = fn(*leaves)
        out.backward(do)
        launched = [kern.launches - b for kern, b in
                    zip(attn.KERNELS, before)]
        return out, [t.grad for t in leaves], launched

    want = run(lambda *t: attn.flash_attention(*t, causal=True))
    got = run(lambda *t: context.ring_attention(mesh, *t, causal=True))
    assert got[2] == want[2] == [1, 1, 1]
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)
    plain = run(lambda *t: context.ring_attention(mesh, *t, causal=True,
                                                  use_flash=False))
    assert plain[2] == [0, 0, 0]
    err = (plain[0].float() - want[0].float()).abs().max().item()
    assert err <= 2e-2 * want[0].float().abs().max().item()


def test_expert_parallel_moe_on_a_one_rank_axis_is_dense_moe(nccl_group):
    """expert_parallel_moe on a one-rank NCCL expert axis runs no
    collective and equals dense_moe bitwise on the card (bf16 tokens
    and experts, f32 gate)."""
    from container_engine_accelerators_tpu_torch.parallel import expert

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randn((256, 64), generator=gen, device="cuda").to(
        torch.bfloat16)
    gate = torch.randn((64, 8), generator=gen, device="cuda")
    w_in = (0.1 * torch.randn((8, 64, 128), generator=gen,
                              device="cuda")).to(torch.bfloat16)
    w_out = (0.1 * torch.randn((8, 128, 64), generator=gen,
                               device="cuda")).to(torch.bfloat16)
    mesh = expert.build_expert_mesh(expert=1)
    got, aux = expert.expert_parallel_moe(mesh, tokens, gate, w_in, w_out)
    want, want_aux = expert.dense_moe(tokens, gate, w_in, w_out)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)


def test_lockstep_engine_on_a_one_rank_group(nccl_group):
    """The tensor-parallel engine of a one-rank group on the card: the
    LockstepEngine's tokens equal a plain engine's on the same calls,
    bitwise, on both pools."""
    from container_engine_accelerators_tpu_torch.serving import lockstep

    config = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4,
                  num_kv_heads=2, pos_embedding="rope", max_seq_len=96)
    model = convert.load_lm(config, convert.init_flax_layout_params(
        config, 0), device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, n) for n in (5, 20, 33)]
    for paged in (True, False):
        kwargs = dict(slots=2, slot_len=96, paged=paged,
                      buckets=(16, 32, 64))

        def run(engine):
            toks = []
            for p in prompts:
                row = np.zeros(64 if not paged else len(p), np.int64)
                row[:len(p)] = p
                slot, first, _, _ = engine.admit(row, len(p), max_new=8)
                toks.append(first)
                for _ in range(4):
                    toks.append(int(engine.step()[0][slot]))
                engine.release(slot)
            return toks

        channel = lockstep.Channel()
        got = run(lockstep.build_engine(channel, model, **kwargs))
        channel.stop()
        want = run(decode.SlotDecodeEngine(model, **kwargs))
        assert got == want, paged


def _event_seconds(work):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    work()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def test_device_span_times_the_card_without_a_wait(cuda):
    """A device-timed span around ~50 ms of device work exits on the
    host at once (no sync), reads unresolved until the work is done,
    then resolves to the plain event-timed duration within 10%."""
    from container_engine_accelerators_tpu_torch.obs import trace

    tracer = trace.Tracer(enabled=True)
    with tracer.span("warm", timed_on=cuda):
        torch.cuda._sleep(1000)
    probe = 10_000_000
    cycles = int(probe * 0.05 / _event_seconds(
        lambda: torch.cuda._sleep(probe)))
    plain = _event_seconds(lambda: torch.cuda._sleep(cycles))
    assert 0.03 < plain < 0.08
    t0 = time.perf_counter()
    with tracer.span("sleep", timed_on=cuda):
        torch.cuda._sleep(cycles)
    host = time.perf_counter() - t0
    assert host < 1e-3
    (rec,) = [s for s in tracer.snapshot()["spans"] if s["name"] == "sleep"]
    assert rec["device_s"] is None
    torch.cuda.synchronize()
    (rec,) = [s for s in tracer.snapshot()["spans"] if s["name"] == "sleep"]
    assert abs(rec["device_s"] - plain) < 0.1 * plain, (rec, plain)

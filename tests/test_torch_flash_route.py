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

"""The bf16 flash kernels' route, on the CPU: ``attention.tma_rows``
decides between the Hopper kernels (wgmma, TMA) and the mma.sync
kernels, and the wrappers hand exactly that flag to every entry point.
The launch itself is replaced by a recorder, so nothing needs the card.
Also the names ``chip_smoke.py`` reads the kernels by in the build's
ptxas and SASS listings.
"""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu_torch.ops import attention as attn

H, D = 4, 64
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO_ROOT, "container_engine_accelerators_tpu_torch",
                    "ops", "csrc")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _fused(n, extra=0, s=10):
    fused = torch.zeros((2, s, n * H * D + extra), dtype=torch.bfloat16)
    return [fused[:, :, extra + i * H * D:extra + (i + 1) * H * D]
            .unflatten(-1, (H, D)) for i in range(n)]


def test_projection_slices_take_the_tma_route():
    q, k, v, do = _fused(4)
    assert attn.tma_rows(q, k, v, do) == 1
    assert attn.tma_rows(torch.zeros((1, 7, H, 16),
                                     dtype=torch.bfloat16)) == 1


def test_misaligned_and_broadcast_rows_take_the_mma_sync_route():
    q, k, v = _fused(3, extra=1)
    assert attn.rows_aligned(q, k, v) == 0
    assert attn.tma_rows(q, k, v) == 0
    aligned = _fused(1)[0]
    broadcast = torch.zeros((2, 10, 1, D), dtype=torch.bfloat16).expand(
        2, 10, H, D)
    assert attn.rows_aligned(aligned, broadcast) == 1
    assert attn.tma_rows(aligned, broadcast) == 0


def test_a_length_one_dim_is_never_stepped():
    """A dim of length 1 has a stride nobody steps: neither an odd nor
    a zero one changes the route."""
    base = torch.zeros((1, 10, H, D), dtype=torch.bfloat16)
    odd = base.as_strided((1, 10, H, D), (3, H * D, D, 1))
    zero = base.as_strided((1, 10, H, D), (0, H * D, D, 1))
    assert attn.tma_rows(odd) == 1
    assert attn.tma_rows(zero) == 1


@pytest.fixture
def recorded(monkeypatch):
    """Every kernel's launch replaced by a recorder of its arguments."""
    calls = {}
    for kern in attn.KERNELS:
        def record(device, *args, what="", name=kern.name):
            calls[name] = args
        monkeypatch.setattr(kern, "_launch", record)
    return calls


@pytest.mark.parametrize("extra,want", [(0, 1), (1, 0)])
def test_wrappers_pass_the_route_to_every_entry_point(recorded, extra,
                                                      want):
    q, k, v, do = _fused(4, extra=extra)
    lse = torch.zeros((2, 10, H), dtype=torch.float32)
    attn.flash_fwd.launch(q, k, v, True, 0)
    attn.flash_bwd_dq.launch(q, k, v, do, lse, lse, True, 0)
    attn.flash_bwd_dkv.launch(q, k, v, do, lse, lse, True, 0)
    assert set(recorded) == {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    # The flag is each entry point's last argument before the stream.
    assert {name: args[-1] for name, args in recorded.items()} == {
        "flash_fwd": want, "flash_bwd_dq": want, "flash_bwd_dkv": want}


@pytest.mark.parametrize("symbol", [
    "_ZN12_GLOBAL__N_128flash_bwd_dq_wgmma_tc_kernelILi64ELi2EEEv"
    "NS_9TmaParamsE",
    "void (anonymous namespace)::flash_bwd_dq_wgmma_tc_kernel<64, 2>("
    "(anonymous namespace)::TmaParams)",
])
def test_kernel_key_reads_the_dq_wgmma_symbol(symbol):
    """ptxas names a kernel by its mangled symbol, cuobjdump by either
    form: both map to one short name."""
    assert _chip_smoke().kernel_key(symbol) == (
        "flash_bwd_dq_wgmma_tc_kernel<64,2>")


def test_wgmma_kernels_name_the_three_hopper_kernels():
    """Phase 2 requires the forward's, dQ's and dK/dV's wgmma kernels,
    each in the library its source builds."""
    wanted = _chip_smoke().WGMMA_KERNELS
    assert {lib: set(names) for lib, names in wanted.items()} == {
        "flash_fwd": {"flash_fwd_wgmma_tc_kernel"},
        "flash_bwd": {"flash_bwd_dkv_wgmma_tc_kernel",
                      "flash_bwd_dq_wgmma_tc_kernel"}}
    for lib, names in wanted.items():
        with open(os.path.join(CSRC, f"{lib}.cu")) as f:
            source = f.read()
        for name in names:
            assert re.search(r"__global__[^;{]*\b" + name + r"\(", source), (
                f"{name} is not a kernel of {lib}.cu")


@pytest.mark.parametrize("d,want", [
    (1, (8, 1)), (4, (8, 1)), (8, (8, 1)), (12, (16, 1)), (64, (64, 1)),
    (127, (128, 1)), (128, (128, 1)), (129, (136, 2)), (136, (136, 2)),
    (256, (256, 2)), (257, (264, 3)), (320, (320, 3)), (1000, (1000, 8))])
def test_head_dim_route(d, want):
    """Every head dim >= 1 has a route: padded up to a multiple of 8,
    split into 128-column chunks above 128."""
    assert attn.head_dim_route(d) == want


def test_kernel_route_reads_the_rows_above_128():
    """Up to kernel head dim 256 rows a tensor map describes take the
    Hopper kernels (ROUTE_HOPPER); up to 128 every other row takes the
    mma.sync kernels (0); above, the wide kernels read
    ``rows_aligned``: a broadcast row stride that a tensor map refuses
    still stages by 16 bytes (ROUTE_ROWS16), rows off 16 bytes by 2."""
    aligned = torch.zeros((2, 10, H, 256), dtype=torch.bfloat16)
    broadcast = torch.zeros((2, 1, H, 256), dtype=torch.bfloat16).expand(
        2, 10, H, 256)
    assert attn.kernel_route(256, aligned) == attn.ROUTE_HOPPER
    assert attn.tma_rows(broadcast) == 0
    assert attn.kernel_route(256, aligned, broadcast) == attn.ROUTE_ROWS16
    assert attn.kernel_route(256, aligned[:, :, :, 1:]) == 0
    q, k, v = _fused(3)
    assert attn.kernel_route(D, q, k, v) == attn.tma_rows(q, k, v) == 1
    q, k, v = _fused(3, extra=1)
    assert attn.kernel_route(D, q, k, v) == 0


@pytest.mark.parametrize("d", [4, 12, 64, 136, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_route_pads_and_keeps_the_true_scale(monkeypatch, d, dtype):
    """The card-side route on the CPU: ``_device_type`` says cuda, and
    each wrapper's kernel (``run``, what the route hands over) is
    replaced by its plain version. The kernels see the head dim padded
    to a multiple of 8 (the caller's tensors themselves when it is one)
    with the true head dim's scale, and the outputs and gradients equal
    the plain path's."""
    rng = np.random.default_rng(d)
    shape = (2, 24, 2, d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for _ in range(4))
    g_lse = torch.from_numpy(rng.standard_normal(shape[:3]).astype(
        np.float32))

    leaves = []

    def grads():
        leaves[:] = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = attn.flash_attention_lse(*leaves, causal=True, window=16)
        ((o.float() * g.float()).sum() + (lse * g_lse).sum()).backward()
        return [o, lse] + [x.grad for x in leaves]

    want = grads()
    seen = []

    def plain(fn, wrap=lambda x: x):
        def run(*args):
            seen.append((args[0].shape[3], args[-1], all(
                a.data_ptr() == x.data_ptr() for a, x in zip(args, leaves))))
            return wrap(fn(*args))
        return run

    monkeypatch.setattr(attn, "_device_type", lambda *xs: "cuda")
    monkeypatch.setattr(attn.flash_fwd, "run",
                        plain(attn.flash_attention_reference))
    monkeypatch.setattr(attn.flash_bwd_dq, "run", plain(
        attn.flash_attention_dq_reference, lambda x: (x,)))
    monkeypatch.setattr(attn.flash_bwd_dkv, "run",
                        plain(attn.flash_attention_dkv_reference))
    got = grads()
    kd, _ = attn.head_dim_route(d)
    assert [s[:2] for s in seen] == [(kd, 1.0 / np.sqrt(d))] * 3
    # Padding copies the operands; a multiple of 8 hands them over.
    assert all(s[2] == (kd == d) for s in seen)
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d,kd,want", [(12, 16, 1), (256, 256, 1),
                                       (132, 136, 1)])
def test_wrappers_pass_the_kernel_head_dim(recorded, d, kd, want):
    """Each entry point gets the kernel head dim, the true head dim's
    scale and ``kernel_route``'s flag."""
    q, k, v, do = (torch.zeros((2, 10, H, d), dtype=torch.bfloat16)
                   for _ in range(4))
    lse = torch.zeros((2, 10, H), dtype=torch.float32)
    attn.flash_fwd.launch(q, k, v, True, 0)
    attn.flash_bwd_dq.launch(q, k, v, do, lse, lse, True, 0)
    attn.flash_bwd_dkv.launch(q, k, v, do, lse, lse, True, 0)
    # fwd: 5 pointers, dtype, b, s, h, d; bwd: 8 pointers, dtype, b, s,
    # h, d. The scale and the flag end each argument list.
    dims = {name: args[9 if name == "flash_fwd" else 12]
            for name, args in recorded.items()}
    assert dims == dict.fromkeys(dims, kd) and len(dims) == 3
    for args in recorded.values():
        assert args[-2] == pytest.approx(1.0 / np.sqrt(d))
        assert args[-1] == want


def _launch_all(q, k, v, do):
    b, s, h, _ = q.shape
    lse = torch.zeros((b, s, h), dtype=torch.float32)
    attn.flash_fwd.launch(q, k, v, True, 0)
    attn.flash_bwd_dq.launch(q, k, v, do, lse, lse, True, 0)
    attn.flash_bwd_dkv.launch(q, k, v, do, lse, lse, True, 0)


def _flags(recorded):
    return {name: args[-1] for name, args in recorded.items()}


def _hopper_counts():
    return [kern.hopper_launches for kern in attn.KERNELS]


@pytest.mark.parametrize("d", [136, 192, 256])
def test_backward_takes_the_hopper_route_up_to_256(recorded, d):
    """bf16 forward, dQ and dK/dV at kernel head dims 136-256 on rows a
    tensor map describes pass ROUTE_HOPPER, and each counts a Hopper
    launch."""
    q, k, v, do = (torch.zeros((2, 10, H, d), dtype=torch.bfloat16)
                   for _ in range(4))
    assert attn.tma_rows(q, k, v, do) == 1
    before = _hopper_counts()
    _launch_all(q, k, v, do)
    assert _flags(recorded) == {"flash_fwd": attn.ROUTE_HOPPER,
                                "flash_bwd_dq": attn.ROUTE_HOPPER,
                                "flash_bwd_dkv": attn.ROUTE_HOPPER}
    assert _hopper_counts() == [n + 1 for n in before]


@pytest.mark.parametrize("d", [264, 320])
def test_backward_above_256_keeps_the_wide_kernels(recorded, d):
    """Past kernel head dim 256 no Hopper kernel exists: aligned rows
    pass ROUTE_ROWS16 to the forward, dQ and dK/dV alike (the wide
    mma.sync kernels, 16-byte staging), and none counts a Hopper
    launch."""
    q, k, v, do = (torch.zeros((2, 10, H, d), dtype=torch.bfloat16)
                   for _ in range(4))
    assert attn.tma_rows(q, k, v, do) == 1
    before = _hopper_counts()
    _launch_all(q, k, v, do)
    assert _flags(recorded) == {"flash_fwd": attn.ROUTE_ROWS16,
                                "flash_bwd_dq": attn.ROUTE_ROWS16,
                                "flash_bwd_dkv": attn.ROUTE_ROWS16}
    assert _hopper_counts() == before


def test_wide_broadcast_and_misaligned_rows_keep_the_wide_kernels(recorded):
    """D 256 rows a tensor map cannot describe: k and v broadcast over
    the heads (rows still on 16 bytes: ROUTE_ROWS16) and slices of a
    fused projection one element in (0, 2-byte staging), for the
    forward as for dQ and dK/dV."""
    d = 256
    q, do = (torch.zeros((2, 10, H, d), dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (torch.zeros((2, 10, 1, d), dtype=torch.bfloat16).expand(
        2, 10, H, d) for _ in range(2))
    assert attn.tma_rows(q, k, v, do) == 0
    before = _hopper_counts()
    _launch_all(q, k, v, do)
    assert _flags(recorded) == {"flash_fwd": attn.ROUTE_ROWS16,
                                "flash_bwd_dq": attn.ROUTE_ROWS16,
                                "flash_bwd_dkv": attn.ROUTE_ROWS16}
    assert _hopper_counts() == before
    recorded.clear()
    fused = torch.zeros((2, 10, 4 * H * d + 1), dtype=torch.bfloat16)
    q, k, v, do = (fused[:, :, 1 + i * H * d:1 + (i + 1) * H * d]
                   .unflatten(-1, (H, d)) for i in range(4))
    _launch_all(q, k, v, do)
    assert _flags(recorded) == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0}
    assert _hopper_counts() == before


@pytest.mark.parametrize("d", [8, 64, 128, 136, 256, 264])
@pytest.mark.parametrize("extra", [0, 1])
def test_forward_flag_is_unchanged_at_every_head_dim(recorded, d, extra):
    """One route for the three kernels: at every head dim the forward
    gets the flag dQ and dK/dV get, ``kernel_route``'s: ROUTE_HOPPER
    up to 256 on rows a tensor map describes, ROUTE_ROWS16 on such rows
    past 256, 0 on rows off 16 bytes."""
    fused = torch.zeros((2, 10, 4 * H * d + extra), dtype=torch.bfloat16)
    q, k, v, do = (fused[:, :, extra + i * H * d:extra + (i + 1) * H * d]
                   .unflatten(-1, (H, d)) for i in range(4))
    want = (0 if extra else attn.ROUTE_HOPPER if d <= 256
            else attn.ROUTE_ROWS16)
    assert attn.kernel_route(d, q, k, v) == want
    _launch_all(q, k, v, do)
    assert _flags(recorded) == dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), want)


def _rows(kind, d):
    """q, k, v, dO at head dim ``d``: "tma" plain tensors, "broadcast"
    k and v expanded over the heads, "misaligned" slices of one fused
    projection one element in."""
    if kind == "misaligned":
        fused = torch.zeros((2, 10, 4 * H * d + 1), dtype=torch.bfloat16)
        return [fused[:, :, 1 + i * H * d:1 + (i + 1) * H * d]
                .unflatten(-1, (H, d)) for i in range(4)]
    q, k, v, do = (torch.zeros((2, 10, H, d), dtype=torch.bfloat16)
                   for _ in range(4))
    if kind == "broadcast":
        k, v = (torch.zeros((2, 10, 1, d), dtype=torch.bfloat16).expand(
            2, 10, H, d) for _ in range(2))
    return [q, k, v, do]


@pytest.mark.parametrize("kern", attn.KERNELS, ids=lambda k: k.name)
@pytest.mark.parametrize("kind,d,dtype,hopper", [
    ("tma", 64, torch.bfloat16, True), ("tma", 256, torch.bfloat16, True),
    ("broadcast", 256, torch.bfloat16, False),
    ("misaligned", 192, torch.bfloat16, False),
    ("tma", 320, torch.bfloat16, False), ("tma", 256, torch.float32, False)])
def test_each_wrapper_counts_its_hopper_launches(recorded, kern, kind, d,
                                                 dtype, hopper):
    """Each wrapper counts a Hopper launch (``hopper_launches``) exactly
    where its route is ROUTE_HOPPER on bf16; f32 runs the FMA kernels
    whatever the flag and counts none."""
    xs = [x.to(dtype) for x in _rows(kind, d)]
    lse = torch.zeros((2, 10, H), dtype=torch.float32)
    args = xs[:3] + ([] if kern is attn.flash_fwd else [xs[3], lse, lse])
    before = kern.hopper_launches
    kern.launch(*args, True, 0)
    assert recorded[kern.name][-1] == attn.kernel_route(d, *xs)
    assert kern.hopper_launches == before + int(hopper)


@pytest.mark.parametrize("symbol,key", [
    ("_ZN12_GLOBAL__N_129flash_bwd_dkv_wgmma_tc_kernelILi256ELi2EEEv"
     "NS_9TmaParamsE", "flash_bwd_dkv_wgmma_tc_kernel<256,2>"),
    ("void (anonymous namespace)::flash_bwd_dkv_wgmma_tc_kernel<256, 2>("
     "(anonymous namespace)::TmaParams)",
     "flash_bwd_dkv_wgmma_tc_kernel<256,2>"),
    ("_ZN12_GLOBAL__N_128flash_bwd_dq_wgmma_tc_kernelILi256ELi1EEEv"
     "NS_9TmaParamsE", "flash_bwd_dq_wgmma_tc_kernel<256,1>"),
    ("void (anonymous namespace)::flash_bwd_dq_wgmma_tc_kernel<256, 1>("
     "(anonymous namespace)::TmaParams)",
     "flash_bwd_dq_wgmma_tc_kernel<256,1>"),
    ("_ZN12_GLOBAL__N_125flash_fwd_wgmma_tc_kernelILi256ELi2EEEv"
     "NS_9TmaParamsE", "flash_fwd_wgmma_tc_kernel<256,2>"),
    ("void (anonymous namespace)::flash_fwd_wgmma_tc_kernel<256, 2>("
     "(anonymous namespace)::TmaParams)",
     "flash_fwd_wgmma_tc_kernel<256,2>"),
])
def test_kernel_key_reads_the_wide_hopper_symbols(symbol, key):
    """The D 256 Hopper kernels' (forward, dQ, dK/dV) ptxas and
    cuobjdump names map to the short names phase 2 reports and
    checks."""
    assert _chip_smoke().kernel_key(symbol) == key

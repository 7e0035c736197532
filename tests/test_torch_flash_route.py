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

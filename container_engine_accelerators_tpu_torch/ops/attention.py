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

"""Flash attention forward: the CUDA kernel and its plain version.

Counterpart of container_engine_accelerators_tpu/ops/attention.py,
forward only (the backward kernels come with the training slice).
The public functions keep that module's layout and argument contract:
q, k, v are [B, S, H, D]; ``flash_attention_lse`` also returns the
per-row logsumexp as [B, S, H] f32; ``block`` and ``streaming`` are
validated exactly as there and do not change the result.

Dispatch is by the tensors' device and nothing else: a CPU tensor
takes the plain version (``flash_attention_reference``), a CUDA tensor
launches ``csrc/flash_fwd.cu`` or raises. There is no fallback from
the kernel to the plain version.
"""

import ctypes
import math
import threading

import torch

from ..utils import env_number
from . import _build

# Seq-dim tile of the Pallas kernels; validated and otherwise unused
# here (the CUDA kernel picks its own tiles). 0 = adaptive default.
_DEFAULT_BLOCK = env_number("CEA_FLASH_BLOCK", 0, parse=int)
_NEG = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_Q_TILES = 65535  # grid.y limit; 64-row Q tiles


def flash_attention_reference(q, k, v, causal=False, window=0):
    """Plain PyTorch version: dense f32 scores with the kernels' -1e9
    masks. Returns (o [B, S, H, D] in q's dtype, lse [B, S, H] f32)."""
    s, d = q.shape[1], q.shape[3]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        pos = torch.arange(s, device=q.device)
        keep = pos[:, None] >= pos[None, :]
        if window:
            keep = keep & (pos[None, :] > pos[:, None] - window)
        scores = torch.where(keep, scores, torch.full_like(scores, _NEG))
    lse = torch.logsumexp(scores, dim=-1)             # [B, H, S]
    probs = torch.exp(scores - lse[..., None])
    o = torch.matmul(probs, vf).transpose(1, 2)       # [B, S, H, D]
    return o.to(q.dtype), lse.transpose(1, 2).contiguous()


class FlashForward:
    """The flash-forward kernel's wrapper: checks, allocation, launch
    and a count of launches (``launches``, incremented once per kernel
    launch and nowhere else)."""

    name = "flash_fwd"

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            fn = _build.load(self.name).cea_flash_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 9
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, q, k, v, causal=False, window=0):
        """Returns (o [B, S, H, D] in q's dtype, lse [B, S, H] f32)."""
        devices = {q.device, k.device, v.device}
        if len(devices) != 1:
            raise ValueError(f"q/k/v on different devices: {devices}")
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, causal, window)
        if q.device.type != "cuda":
            raise ValueError(
                f"flash attention runs on cuda or cpu tensors, not "
                f"{q.device.type}")
        return self.launch(q, k, v, causal, window)

    def launch(self, q, k, v, causal, window):
        """Launch the kernel on CUDA tensors (no device dispatch)."""
        if q.dim() != 4 or not (q.shape == k.shape == v.shape):
            raise ValueError(
                f"flash kernel takes q/k/v of one [B, S, H, D] shape: "
                f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
        if not (q.dtype == k.dtype == v.dtype) or (
                q.dtype not in _DTYPE_CODES):
            raise ValueError(
                f"flash kernel takes float32 or bfloat16 q/k/v of one "
                f"dtype: {q.dtype} {k.dtype} {v.dtype}")
        b, s, h, d = q.shape
        if d > _MAX_HEAD_DIM or d % 8:
            raise ValueError(
                f"flash kernel head dim must be a multiple of 8 up to "
                f"{_MAX_HEAD_DIM}: {d}")
        for name, x in (("q", q), ("k", k), ("v", v)):
            if x.stride(3) != 1 or min(x.stride()) < 0:
                raise ValueError(
                    f"flash kernel needs {name} with a contiguous head "
                    f"dim and non-negative strides: {x.stride()}")
        if -(-s // 64) > _MAX_Q_TILES:
            raise ValueError(f"sequence too long for the kernel: {s}")
        o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
        if o.numel() == 0:
            return o, lse
        fn = self._kernel()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _DTYPE_CODES[q.dtype], b, s, h, d,
                 *(q.stride(i) for i in range(3)),
                 *(k.stride(i) for i in range(3)),
                 *(v.stride(i) for i in range(3)),
                 int(bool(causal)), int(window), 1.0 / math.sqrt(d),
                 stream)
        if err != 0:
            raise RuntimeError(
                f"flash_fwd launch failed: cudaError {err} "
                f"(shape {tuple(q.shape)}, {q.dtype})")
        with self._lock:
            self.launches += 1
        return o, lse


flash_fwd = FlashForward()


def flash_attention(q, k, v, causal=False, block=None, streaming=None,
                    window=None):
    """Exact attention. q/k/v: [B, S, H, D] -> o [B, S, H, D].

    ``block`` (multiple of 128) and ``streaming`` are the Pallas
    kernels' tiling knobs: validated as there, without effect on the
    result. ``window`` > 0 (requires causal): query p sees keys in
    (p - window, p].
    """
    causal, _, _, window = _check_args(q, k, v, causal, block, streaming,
                                       window)
    return flash_fwd(q, k, v, causal, window)[0]


def flash_attention_lse(q, k, v, causal=False, block=None,
                        streaming=None, window=None):
    """flash_attention that also returns the per-row logsumexp:
    (o [B, S, H, D], lse [B, S, H] f32) with
    lse = log sum_j exp(q_i . k_j / sqrt(D)) over unmasked j."""
    causal, _, _, window = _check_args(q, k, v, causal, block, streaming,
                                       window)
    return flash_fwd(q, k, v, causal, window)


def _check_args(q, k, v, causal, block, streaming, window=None):
    if not (q.shape == k.shape == v.shape):
        raise ValueError(
            f"q/k/v shapes differ: {tuple(q.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)}")
    if block is None:
        if _DEFAULT_BLOCK:
            block = _DEFAULT_BLOCK
        else:
            padded_seq = -(-q.shape[1] // 128) * 128
            block = min(512, padded_seq)
    block = int(block)
    if block < 128 or block % 128:
        raise ValueError(f"block must be a positive multiple of 128: "
                         f"{block}")
    window = int(window or 0)
    if window < 0:
        raise ValueError(f"window must be >= 0: {window}")
    if window and not causal:
        raise ValueError("window requires causal=True")
    return (bool(causal), block,
            None if streaming is None else bool(streaming), window)

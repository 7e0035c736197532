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

"""Flash attention, forward and backward: the CUDA kernels and their
plain versions.

Counterpart of container_engine_accelerators_tpu/ops/attention.py.
The public functions keep that module's layout and argument contract:
q, k, v are [B, S, H, D]; ``flash_attention_lse`` also returns the
per-row logsumexp as [B, S, H] f32; ``block`` and ``streaming`` are
validated exactly as there and do not change the result.

Both public functions are differentiable through ``_FlashFunction``
(the counterpart of the custom VJPs ``_flash``/``_flash_lse``): the
backward forms ``delta = rowsum(dO * O) - g_lse`` in f32 as plain
torch, as ``_flash_bwd`` does outside any kernel, then runs the dQ and
the dK/dV kernels. The lse output's cotangent folds into ``delta``.

Dispatch is by the tensors' device and nothing else: a CPU tensor
takes the plain version (``flash_attention_reference``,
``flash_attention_dq_reference``, ``flash_attention_dkv_reference``),
a CUDA tensor launches ``csrc/flash_fwd.cu`` / ``csrc/flash_bwd.cu``
or raises. There is no fallback from a kernel to its plain version.
"""

import ctypes
import math

import torch

from ..utils import env_number
from . import _build

# Seq-dim tile of the Pallas kernels; validated and otherwise unused
# here (the CUDA kernels pick their own tiles). 0 = adaptive default.
_DEFAULT_BLOCK = env_number("CEA_FLASH_BLOCK", 0, parse=int)
_NEG = -1e9
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_TILES = 65535  # grid.y limit; 64-row tiles


def _keep_mask(s, window, device):
    """[S, S] bool: query i sees key j (causal, optional window)."""
    pos = torch.arange(s, device=device)
    keep = pos[:, None] >= pos[None, :]
    if window:
        keep = keep & (pos[None, :] > pos[:, None] - window)
    return keep


def _masked_scores(qf, kf, causal, window):
    """[B, H, S, D] f32 q/k -> [B, H, S, S] f32 scaled scores with the
    kernels' -1e9 masks."""
    s, d = qf.shape[2], qf.shape[3]
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    if causal:
        keep = _keep_mask(s, window, qf.device)
        scores = torch.where(keep, scores, torch.full_like(scores, _NEG))
    return scores


def _heads_first(*xs):
    return [x.float().transpose(1, 2) for x in xs]


def flash_attention_reference(q, k, v, causal=False, window=0):
    """Plain PyTorch version: dense f32 scores with the kernels' -1e9
    masks. Returns (o [B, S, H, D] in q's dtype, lse [B, S, H] f32)."""
    qf, kf, vf = _heads_first(q, k, v)
    scores = _masked_scores(qf, kf, causal, window)
    lse = torch.logsumexp(scores, dim=-1)             # [B, H, S]
    probs = torch.exp(scores - lse[..., None])
    o = torch.matmul(probs, vf).transpose(1, 2)       # [B, S, H, D]
    return o.to(q.dtype), lse.transpose(1, 2).contiguous()


def _bwd_terms(q, k, v, do, lse, delta, causal, window):
    """The backward's recomputed terms, heads first and in f32:
    (p, ds, qf, kf, dof) with p = exp(s - lse) and
    ds = p * (dO.V^T - delta) * scale (``_dq_step``/``_dkv_step``)."""
    qf, kf, vf, dof = _heads_first(q, k, v, do)
    scores = _masked_scores(qf, kf, causal, window)
    p = torch.exp(scores - lse.transpose(1, 2)[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.transpose(1, 2)[..., None]) * (
        1.0 / math.sqrt(q.shape[3]))
    return p, ds, qf, kf, dof


def flash_attention_dq_reference(q, k, v, do, lse, delta, causal=False,
                                 window=0):
    """Plain version of the dQ kernel. q/k/v/do [B, S, H, D], lse and
    delta [B, S, H] f32 (delta = rowsum(dO*O) - g_lse). Returns dQ
    [B, S, H, D] in q's dtype."""
    _, ds, _, kf, _ = _bwd_terms(q, k, v, do, lse, delta, causal, window)
    return torch.matmul(ds, kf).transpose(1, 2).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, causal=False,
                                  window=0):
    """Plain version of the dK/dV kernel: (dK, dV) [B, S, H, D] in
    k's and v's dtypes, dV = p^T.dO and dK = ds^T.Q."""
    p, ds, qf, _, dof = _bwd_terms(q, k, v, do, lse, delta, causal,
                                   window)
    dv = torch.matmul(p.transpose(-1, -2), dof).transpose(1, 2)
    dk = torch.matmul(ds.transpose(-1, -2), qf).transpose(1, 2)
    return dk.to(k.dtype), dv.to(v.dtype)


def _strides(*xs):
    return [x.stride(i) for x in xs for i in range(3)]


def rows_aligned(*xs):
    """1 when every row (one position of one head) of every [B, S, H, D]
    operand starts on 16 bytes: the pointer and each stride of the
    batch, sequence and head dims that is ever stepped. The bf16
    tensor-core kernels then stage rows by 16-byte ``cp.async``, and by
    2-byte loads otherwise (0)."""
    for x in xs:
        size = x.element_size()
        if x.data_ptr() % 16 or any(
                x.stride(i) * size % 16 for i in range(3) if x.shape[i] > 1):
            return 0
    return 1


def _check_tensors(what, tensors):
    """Checks every kernel of this module makes on its [B, S, H, D]
    operands (``tensors``: {name: tensor}). Returns (b, s, h, d)."""
    first = next(iter(tensors.values()))
    shapes = {name: tuple(x.shape) for name, x in tensors.items()}
    if first.dim() != 4 or len(set(shapes.values())) != 1:
        raise ValueError(
            f"{what} takes operands of one [B, S, H, D] shape: {shapes}")
    dtypes = {x.dtype for x in tensors.values()}
    if len(dtypes) != 1 or first.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"{what} takes float32 or bfloat16 operands of one dtype: "
            f"{sorted(map(str, dtypes))}")
    b, s, h, d = first.shape
    if d > _MAX_HEAD_DIM or d % 8:
        raise ValueError(
            f"{what} head dim must be a multiple of 8 up to "
            f"{_MAX_HEAD_DIM}: {d}")
    for name, x in tensors.items():
        if x.stride(3) != 1 or min(x.stride()) < 0:
            raise ValueError(
                f"{what} needs {name} with a contiguous head dim and "
                f"non-negative strides: {x.stride()}")
    if -(-s // 64) > _MAX_TILES:
        raise ValueError(f"sequence too long for {what}: {s}")
    return b, s, h, d


def _check_rows(what, b, s, h, rows):
    """lse/delta: contiguous [B, S, H] f32."""
    for name, x in rows.items():
        if (tuple(x.shape) != (b, s, h) or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(
                f"{what} needs {name} as a contiguous float32 "
                f"[{b}, {s}, {h}]: {tuple(x.shape)} {x.dtype}")


class FlashForward(_build.Kernel):
    """The flash-forward kernel's wrapper: checks, allocation, launch
    and a count of launches."""

    name = library = "flash_fwd"
    symbol = "cea_flash_fwd"
    argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 9
                + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p])

    def __call__(self, q, k, v, causal=False, window=0):
        """Returns (o [B, S, H, D] in q's dtype, lse [B, S, H] f32)."""
        if _device_type(q, k, v) == "cpu":
            return flash_attention_reference(q, k, v, causal, window)
        return self.launch(q, k, v, causal, window)

    def launch(self, q, k, v, causal, window):
        """Launch the kernel on CUDA tensors (no device dispatch)."""
        b, s, h, d = _check_tensors("flash kernel",
                                    {"q": q, "k": k, "v": v})
        o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
        if o.numel() == 0:
            return o, lse
        self._launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), _DTYPE_CODES[q.dtype],
                     b, s, h, d, *_strides(q, k, v), int(bool(causal)),
                     int(window), 1.0 / math.sqrt(d), rows_aligned(q, k, v),
                     what=f"shape {tuple(q.shape)}, {q.dtype}")
        return o, lse


_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 12
                 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_int, ctypes.c_void_p])


class _FlashBackward(_build.Kernel):
    """Common checks and launch of the two backward kernels. Both
    entry points take (q, k, v, do, lse, delta, out0, out1, dtype, b,
    s, h, d, 12 strides, causal, window, scale, aligned, stream); dQ
    passes a null out1."""

    library = "flash_bwd"
    argtypes = _BWD_ARGTYPES
    n_out = 1

    def launch(self, q, k, v, do, lse, delta, causal, window):
        """Launch on CUDA tensors (no device dispatch). Returns the
        outputs, contiguous [B, S, H, D] in the input dtype."""
        b, s, h, d = _check_tensors(
            f"{self.name} kernel", {"q": q, "k": k, "v": v, "do": do})
        _check_rows(f"{self.name} kernel", b, s, h,
                    {"lse": lse, "delta": delta})
        outs = [torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                for _ in range(self.n_out)]
        if q.numel() == 0:
            return tuple(outs)
        ptrs = [o.data_ptr() for o in outs] + [None] * (2 - self.n_out)
        self._launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     *ptrs, _DTYPE_CODES[q.dtype], b, s, h, d,
                     *_strides(q, k, v, do), int(bool(causal)),
                     int(window), 1.0 / math.sqrt(d),
                     rows_aligned(q, k, v, do),
                     what=f"shape {tuple(q.shape)}, {q.dtype}")
        return tuple(outs)


class FlashBackwardDQ(_FlashBackward):
    """dQ kernel's wrapper (Pallas ``_dq_kernel``/``_dq_kernel_stream``)."""

    name = "flash_bwd_dq"
    symbol = "cea_flash_bwd_dq"

    def __call__(self, q, k, v, do, lse, delta, causal=False, window=0):
        if _device_type(q, k, v, do, lse, delta) == "cpu":
            return flash_attention_dq_reference(q, k, v, do, lse, delta,
                                                causal, window)
        return self.launch(q, k, v, do, lse, delta, causal, window)[0]


class FlashBackwardDKV(_FlashBackward):
    """dK/dV kernel's wrapper (Pallas ``_dkv_kernel``/
    ``_dkv_kernel_stream``)."""

    name = "flash_bwd_dkv"
    symbol = "cea_flash_bwd_dkv"
    n_out = 2

    def __call__(self, q, k, v, do, lse, delta, causal=False, window=0):
        if _device_type(q, k, v, do, lse, delta) == "cpu":
            return flash_attention_dkv_reference(q, k, v, do, lse, delta,
                                                 causal, window)
        return self.launch(q, k, v, do, lse, delta, causal, window)


def _device_type(*xs):
    """'cpu' or 'cuda' for tensors all on one device; raises
    otherwise."""
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"flash attention operands on different devices: "
                         f"{sorted(map(str, devices))}")
    kind = xs[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(
            f"flash attention runs on cuda or cpu tensors, not {kind}")
    return kind


flash_fwd = FlashForward()
flash_bwd_dq = FlashBackwardDQ()
flash_bwd_dkv = FlashBackwardDKV()
KERNELS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)


class _FlashFunction(torch.autograd.Function):
    """(o, lse) = flash(q, k, v) with the flash backward: the
    counterpart of ``_flash_lse`` and its custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = flash_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        g_o = g_o.to(o.dtype)
        if g_o.stride(3) != 1:
            g_o = g_o.contiguous()
        delta = (g_o.float() * o.float()).sum(-1)     # [B, S, H] f32
        if g_lse is not None:
            delta = delta - g_lse.float()
        args = (q, k, v, g_o, lse, delta, ctx.causal, ctx.window)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None


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
    return _FlashFunction.apply(q, k, v, causal, window)[0]


def flash_attention_lse(q, k, v, causal=False, block=None,
                        streaming=None, window=None):
    """flash_attention that also returns the per-row logsumexp:
    (o [B, S, H, D], lse [B, S, H] f32) with
    lse = log sum_j exp(q_i . k_j / sqrt(D)) over unmasked j. Both
    outputs are differentiable."""
    causal, _, _, window = _check_args(q, k, v, causal, block, streaming,
                                       window)
    return _FlashFunction.apply(q, k, v, causal, window)


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

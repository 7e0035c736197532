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

"""Fused softmax cross-entropy: the CUDA kernels and their plain
versions.

Counterpart of container_engine_accelerators_tpu/ops/xent.py:
``softmax_cross_entropy(logits [N, C], labels [N])`` gives the
per-example loss in f32, and its backward is the fused
``(softmax - onehot) * g`` kernel with the upstream per-row cotangent
``g``; ``mean_cross_entropy_loss`` keeps label smoothing outside the
kernel, as there.

A label outside [0, C) matches no class, as in the Pallas kernel's
iota compare: its label logit counts as 0, so the loss is the row's
log-sum-exp of the shifted logits and the backward subtracts no
one-hot. (The Pallas kernel pads C to a multiple of 128 with -1e9, so
a label in [C, padded C) lands on a padded class there; labels below
0 or past the padding agree.) Nothing raises on such a label: checking
would cost a device-to-host read every step.

Dispatch is by the tensors' device: a CPU tensor takes the plain
version (``softmax_cross_entropy_reference``,
``softmax_cross_entropy_bwd_reference``), a CUDA tensor launches
``csrc/xent.cu`` or raises. There is no fallback.
"""

import ctypes

import torch

from . import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _shifted_and_onehot(logits, labels):
    """f32 shifted logits (x - row max) and the f32 one-hot of the
    labels (all zero for a label outside [0, C))."""
    lf = logits.float()
    shifted = lf - lf.max(dim=-1, keepdim=True).values
    classes = torch.arange(lf.shape[-1], device=lf.device)
    onehot = (classes[None, :] == labels.long()[:, None]).float()
    return shifted, onehot


def softmax_cross_entropy_reference(logits, labels):
    """Plain version of the forward kernel: per-row
    lse(shifted) - shifted[label], [N] f32."""
    shifted, onehot = _shifted_and_onehot(logits, labels)
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    return lse - (shifted * onehot).sum(dim=-1)


def softmax_cross_entropy_bwd_reference(logits, labels, g):
    """Plain version of the backward kernel: (softmax - onehot) * g,
    [N, C] in the logits' dtype."""
    shifted, onehot = _shifted_and_onehot(logits, labels)
    e = torch.exp(shifted)
    probs = e / e.sum(dim=-1, keepdim=True)
    return ((probs - onehot) * g.float()[:, None]).to(logits.dtype)


def _check(logits, labels, *rows):
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(
            f"cross entropy takes logits [N, C] and labels [N]: "
            f"{tuple(logits.shape)} {tuple(labels.shape)}")
    devices = {x.device for x in (logits, labels, *rows)}
    if len(devices) != 1:
        raise ValueError(f"cross entropy operands on different devices: "
                         f"{sorted(map(str, devices))}")
    kind = logits.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(
            f"cross entropy runs on cuda or cpu tensors, not {kind}")
    return kind


class _XentKernel(_build.Kernel):
    library = "xent"

    def _operands(self, logits, labels):
        """(logits, int64 labels, dtype code, n, c, vec) for the
        kernel; raises on what it does not take."""
        if logits.dtype not in _DTYPE_CODES:
            raise ValueError(f"{self.name} kernel takes float32 or "
                             f"bfloat16 logits: {logits.dtype}")
        if labels.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"{self.name} kernel takes integer labels: "
                             f"{labels.dtype}")
        n, c = logits.shape
        if c == 0 or n >= 2 ** 31 or c >= 2 ** 31:
            raise ValueError(f"{self.name} kernel takes 1 to 2**31 - 1 "
                             f"classes and rows: {(n, c)}")
        logits = logits.contiguous()
        labels = labels.to(torch.int64).contiguous()
        vec = int(logits.dtype == torch.float32 and c % 4 == 0
                  and logits.data_ptr() % 16 == 0)
        return logits, labels, _DTYPE_CODES[logits.dtype], n, c, vec


class XentForward(_XentKernel):
    """Forward kernel's wrapper (Pallas ``_fwd_kernel``)."""

    name = "xent_fwd"
    symbol = "cea_xent_fwd"
    argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])

    def __call__(self, logits, labels):
        if _check(logits, labels) == "cpu":
            return softmax_cross_entropy_reference(logits, labels)
        return self.launch(logits, labels)

    def launch(self, logits, labels):
        """Launch on CUDA tensors: loss [N] f32."""
        logits, labels, code, n, c, vec = self._operands(logits, labels)
        loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
        if n == 0:
            return loss
        self._launch(logits.device, logits.data_ptr(), labels.data_ptr(),
                     loss.data_ptr(), code, n, c, vec,
                     what=f"logits {(n, c)}, {logits.dtype}")
        return loss


class XentBackward(_XentKernel):
    """Backward kernel's wrapper (Pallas ``_bwd_kernel``)."""

    name = "xent_bwd"
    symbol = "cea_xent_bwd"
    argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])

    def __call__(self, logits, labels, g):
        if _check(logits, labels, g) == "cpu":
            return softmax_cross_entropy_bwd_reference(logits, labels, g)
        return self.launch(logits, labels, g)

    def launch(self, logits, labels, g):
        """Launch on CUDA tensors: dlogits [N, C] in the logits'
        dtype."""
        logits, labels, code, n, c, vec = self._operands(logits, labels)
        g = g.to(torch.float32).reshape(n).contiguous()
        out = torch.empty((n, c), dtype=logits.dtype, device=logits.device)
        if out.numel() == 0:
            return out
        self._launch(logits.device, logits.data_ptr(), labels.data_ptr(),
                     g.data_ptr(), out.data_ptr(), code, n, c, vec,
                     what=f"logits {(n, c)}, {logits.dtype}")
        return out


xent_fwd = XentForward()
xent_bwd = XentBackward()
KERNELS = (xent_fwd, xent_bwd)


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """Counterpart of the custom VJP of ``softmax_cross_entropy``."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return xent_fwd(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return xent_bwd(logits, labels, g), None


def softmax_cross_entropy(logits, labels):
    """Per-example softmax cross entropy. logits [N, C], labels [N]
    int -> [N] f32."""
    return _SoftmaxCrossEntropy.apply(logits, labels)


def mean_cross_entropy_loss(logits, labels, label_smoothing=0.0):
    """Trainer-compatible scalar loss built on the fused kernel.

    ``label_smoothing`` (epsilon in [0, 1)) mixes the hard target with
    the uniform distribution; its term -mean_c log p_c =
    logsumexp(logits) - mean(logits) is plain torch outside the
    kernel, as in the JAX package."""
    ce = softmax_cross_entropy(logits, labels)
    if label_smoothing:
        eps = float(label_smoothing)
        if not 0.0 <= eps < 1.0:
            raise ValueError(
                f"label_smoothing must be in [0, 1): {eps}")
        lf = logits.float()
        uniform_ce = torch.logsumexp(lf, dim=-1) - lf.mean(dim=-1)
        ce = (1.0 - eps) * ce + eps * uniform_ce
    return ce.mean()

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

"""flax-semantics building blocks of the image models: convolutions
and pools with flax's SAME/VALID padding, BatchNorm with flax's
statistics, and step-keyed dropout.

The image models take NHWC batches, as the JAX models do, and work on
``x.permute(0, 3, 1, 2)`` of them: NCHW by shape, channels_last in
memory, which is what cuDNN's NHWC kernels read. Convolution weights
are held as OIHW in channels_last memory.

- **SAME** (``same_pads``) pads ``total = max((ceil(n/s) - 1)*s + k - n,
  0)`` with ``total // 2`` before and the rest after, so a stride-2
  window on an even input pads only after it: the 7x7/2 stem on 224
  pads (2, 3), a 3x3/2 conv on 56 pads (0, 1). ``nn.Conv2d`` and
  ``MaxPool2d`` pad symmetrically and pick other windows, so the
  asymmetric case pads explicitly with ``F.pad`` (-inf for the max
  pool, as ``lax.reduce_window`` pads).
- **BatchNorm** computes its batch statistics in f32 whatever the
  input's dtype, with flax's ``use_fast_variance``:
  ``var = max(E[x^2] - E[x]^2, 0)`` (biased), normalises as
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32 and casts
  the result to the compute dtype. The running statistics follow
  flax's ``ra = momentum * ra + (1 - momentum) * batch`` with the
  biased variance (``torch.nn.BatchNorm2d`` updates from the unbiased
  estimate with the other meaning of momentum, so it is not used).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# lecun_normal's truncated normal (flax's default kernel init) draws
# from N(0, 1) cut at +-2 and divides by this, its standard deviation.
_TRUNC_STD = 0.87962566103423978


def same_pads(n, k, s):
    """(before, after) padding of flax's SAME for input size ``n``,
    window ``k`` and stride ``s``."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad(x, kernel, strides, padding, value=0.0):
    """(x, symmetric padding for the op): SAME pads that are the same
    on both sides go to the op; others are applied here."""
    if padding == "VALID":
        return x, (0, 0)
    if padding != "SAME":
        raise ValueError(f"padding is SAME or VALID: {padding!r}")
    (th, bh), (lw, rw) = (same_pads(n, k, s) for n, k, s in
                          zip(x.shape[2:], kernel, strides))
    if th == bh and lw == rw:
        return x, (th, lw)
    return F.pad(x, (lw, rw, th, bh), value=value), (0, 0)


def lecun_normal_(weight, fan_in):
    """flax's lecun_normal in place: a truncated normal with standard
    deviation 1/sqrt(fan_in)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std)
    return weight


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel, strides, padding,
    use_bias=False, dtype=...)`` on NCHW (channels_last) activations.
    The weight [out, in, kh, kw] is held in f32 and cast to the
    compute dtype at the call."""

    def __init__(self, in_channels, out_channels, kernel, strides=(1, 1),
                 padding="SAME", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.padding = padding
        self.compute_dtype = dtype
        weight = torch.empty((out_channels, in_channels, *self.kernel),
                             device=device)
        self.weight = nn.Parameter(weight.to(
            memory_format=torch.channels_last))
        lecun_normal_(self.weight, in_channels * int(np.prod(self.kernel)))

    def forward(self, x):
        x, pad = _pad(x, self.kernel, self.strides, self.padding)
        return F.conv2d(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype),
                        stride=self.strides, padding=pad)


def max_pool(x, window, strides, padding):
    """flax ``nn.max_pool`` on NCHW: SAME pads with -inf."""
    x, pad = _pad(x, window, strides, padding, value=-math.inf)
    return F.max_pool2d(x, window, strides, padding=pad)


def avg_pool(x, window, strides, padding):
    """flax ``nn.avg_pool`` on NCHW with its default
    ``count_include_pad=True``: every window sum is divided by the
    window's size, padded positions included."""
    x, pad = _pad(x, window, strides, padding)
    return F.avg_pool2d(x, window, strides, padding=pad,
                        count_include_pad=True)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype=...)`` over the
    channel axis of NCHW activations (module docstring).

    ``weight``/``bias`` are flax's ``scale``/``bias`` (f32);
    ``running_mean``/``running_var`` its ``batch_stats``. In train mode
    the forward normalises by the batch statistics and updates the
    running ones in place (unless ``update_stats`` is off, as while
    remat recomputes a forward); in eval mode it reads the running
    ones. ``zero_scale`` marks flax's ``scale_init=zeros`` (the last BN
    of a residual block) for the initializers."""

    def __init__(self, features, eps, momentum=0.9, dtype=torch.bfloat16,
                 zero_scale=False, device=None):
        super().__init__()
        self.eps, self.momentum = float(eps), float(momentum)
        self.compute_dtype = dtype
        self.zero_scale = zero_scale
        self.update_stats = True
        scale = torch.zeros if zero_scale else torch.ones
        self.weight = nn.Parameter(scale(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    def forward(self, x):
        xf = x.float()
        if self.training:
            dims = (0, 2, 3)
            mean = xf.mean(dim=dims)
            var = torch.clamp_min(xf.square().mean(dim=dims)
                                  - mean.square(), 0.0)
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(self.compute_dtype)


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode keep each value with
    probability 1 - rate and scale it by 1/(1 - rate); rate 0 and eval
    mode pass the input through. The mask comes from the generator the
    caller hands over (the port's counterpart of the ``dropout`` rng)."""

    def __init__(self, rate):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, generator=None):
        if not self.training or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

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

"""Weight-only int8 linear layers for serving (counterpart of the JAX
package's models/quantized.py).

Kernels are held as int8 with one f32 scale per output channel, so
the scale folds outside the contraction: x @ (q * s) == (x @ q) * s.
``Int8Linear`` rounds where ``Int8DenseGeneral`` does: the product of
the compute-dtype input and the int8 weight converted to the compute
dtype gives a compute-dtype result, which is scaled in f32, cast back,
and then takes the bias in the compute dtype. The product is a plain
``F.linear``: the JAX package computes it in XLA, not in a Pallas
kernel. Quantization (``quantize_kernel_int8``, ``convert_params_int8``)
runs once at load time on numpy trees in the flax layout.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Int8Linear(nn.Module):
    """``Int8DenseGeneral`` over a flattened output: int8 ``weight``
    [out, in], f32 ``scale`` [out] and ``bias`` [out] in the compute
    dtype (flax creates the bias in ``dtype`` and
    ``convert_params_int8`` casts it there). Zero-filled with unit
    scales until a converted tree is loaded."""

    def __init__(self, in_features, out_features, dtype, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros((out_features, in_features), dtype=torch.int8,
                        device=device), requires_grad=False)
        self.scale = nn.Parameter(
            torch.ones((out_features,), dtype=torch.float32,
                       device=device), requires_grad=False)
        self.bias = nn.Parameter(
            torch.zeros((out_features,), dtype=dtype, device=device),
            requires_grad=False)

    def forward(self, x):
        dt = self.compute_dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        return (y.float() * self.scale).to(dt) + self.bias


def quantize_kernel_int8(kernel):
    """Symmetric per-output-channel int8 quantization of a dense kernel
    [in, *out] (numpy): (int8 q, f32 scale [*out]), amax over the input
    axis, divided by the scale and rounded half to even."""
    w = np.asarray(kernel, np.float32)
    amax = np.max(np.abs(w), axis=0)
    scale = np.maximum(amax, np.float32(1e-8)) / np.float32(127.0)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def convert_params_int8(template, params):
    """Fill a weights="int8" model's flax-layout tree from a trained
    full-precision one (numpy trees). ``template`` has the int8 model's
    layout: quantized modules hold ``kernel_q``/``scale``[/``bias``]
    where ``params`` holds ``kernel``/``bias``. Other leaves copy
    through; shapes are checked, so a mismatched tree fails loudly. The
    bias takes the template's dtype."""
    if not isinstance(template, dict):
        if np.shape(template) != np.shape(params):
            raise ValueError(
                f"shape mismatch converting params: "
                f"{np.shape(params)} -> {np.shape(template)}")
        return params
    if "kernel_q" in template:
        out = {}
        q, scale = quantize_kernel_int8(params["kernel"])
        if q.shape != template["kernel_q"].shape:
            raise ValueError(
                f"kernel shape {q.shape} != template "
                f"{template['kernel_q'].shape}")
        out["kernel_q"], out["scale"] = q, scale
        if "bias" in template:
            out["bias"] = np.asarray(params["bias"],
                                     template["bias"].dtype)
        return out
    if set(template) != set(params):
        raise ValueError(
            f"param tree mismatch: {sorted(template)} vs "
            f"{sorted(params)}")
    return {k: convert_params_int8(template[k], params[k])
            for k in template}

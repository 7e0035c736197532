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

"""ResNet v1.5 (counterpart of the flax ResNet in
container_engine_accelerators_tpu/models/resnet.py).

Same architecture and numerics: the stride of a bottleneck block on
its 3x3 convolution, SAME padding with flax's asymmetric split, BN
momentum 0.9 and epsilon 1e-5 with f32 statistics, the last BN of each
block with its scale initialised to zero, a projection shortcut only
where the block changes the shape, the spatial mean in the compute
dtype and an f32 ``head``. Takes NHWC images (``models/layers.py``
says how they are laid out inside).

Submodules carry flax's names (``conv_init``, ``norm_init``,
``BottleneckBlock_{i}`` numbered across stages with ``Conv_k``,
``BatchNorm_k``, ``conv_proj``, ``norm_proj``, ``head``), so the
state_dict names are the flax paths (``models/convert.py``). Train
mode (``model.train()``) normalises by the batch and updates the
running statistics in place; eval mode reads them: flax's
``make_apply_fn`` with ``train`` True or False.
"""

import functools

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv, max_pool
from .transformer import Linear

_STAGE_SIZES = {
    18: [2, 2, 2, 2],
    34: [3, 4, 6, 3],
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}
_BOTTLENECK = {18: False, 34: False, 50: True, 101: True, 152: True}


class _Block(nn.Module):
    """A residual block: ``layers`` (in_channels, out_channels, kernel,
    stride) in order, each a conv and a BN, ReLU between them; a
    projection of the input when the shapes differ."""

    def __init__(self, in_channels, strides, layers, conv, norm):
        super().__init__()
        self.depth = len(layers)
        for k, (cin, cout, kernel, stride) in enumerate(layers):
            last = k == len(layers) - 1
            self.add_module(f"Conv_{k}", conv(cin, cout, kernel,
                                              (stride, stride)))
            self.add_module(f"BatchNorm_{k}", norm(cout, zero_scale=last))
        out = layers[-1][1]
        # flax compares the shapes (residual.shape != y.shape): the
        # channels differ, or a stride shrinks the map.
        self.project = in_channels != out or strides != 1
        if self.project:
            self.conv_proj = conv(in_channels, out, (1, 1),
                                  (strides, strides))
            self.norm_proj = norm(out)

    def forward(self, x):
        y = x
        for k in range(self.depth):
            y = getattr(self, f"BatchNorm_{k}")(getattr(self, f"Conv_{k}")(y))
            if k < self.depth - 1:
                y = F.relu(y)
        residual = self.norm_proj(self.conv_proj(x)) if self.project else x
        return F.relu(residual + y)


class BasicBlock(_Block):
    def __init__(self, in_channels, filters, strides, conv, norm):
        super().__init__(in_channels, strides, [
            (in_channels, filters, (3, 3), strides),
            (filters, filters, (3, 3), 1)], conv, norm)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, in_channels, filters, strides, conv, norm):
        # v1.5: the stride lives on the 3x3, not the 1x1.
        super().__init__(in_channels, strides, [
            (in_channels, filters, (1, 1), 1),
            (filters, filters, (3, 3), strides),
            (filters, filters * 4, (1, 1), 1)], conv, norm)


class ResNet(nn.Module):
    """ResNet v1.5; depth in {18, 34, 50, 101, 152}. ``forward(images
    [B, H, W, C]) -> logits [B, num_classes]`` f32."""

    def __init__(self, depth=50, num_classes=1000, dtype=torch.bfloat16,
                 width=64, device=None):
        super().__init__()
        self.depth, self.num_classes, self.width = depth, num_classes, width
        self.dtype = dtype
        conv = functools.partial(Conv, padding="SAME", dtype=dtype,
                                 device=device)
        norm = functools.partial(BatchNorm, eps=1e-5, momentum=0.9,
                                 dtype=dtype, device=device)
        bottleneck = _BOTTLENECK[depth]
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        self.conv_init = conv(3, width, (7, 7), (2, 2))
        self.norm_init = norm(width)
        self.blocks = []
        channels, i = width, 0
        for stage, num_blocks in enumerate(_STAGE_SIZES[depth]):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                filters = width * 2 ** stage
                name = f"{block_cls.__name__}_{i}"
                self.add_module(name, block_cls(channels, filters, strides,
                                                conv, norm))
                self.blocks.append(name)
                channels = filters * (4 if bottleneck else 1)
                i += 1
        self.head = Linear(channels, num_classes, torch.float32,
                           torch.float32, device=device)

    def forward(self, images):
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.norm_init(self.conv_init(x)))
        x = max_pool(x, (3, 3), (2, 2), "SAME")
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.head(x.float())


def resnet(depth=50, num_classes=1000, dtype=torch.bfloat16, width=64,
           device=None):
    if depth not in _STAGE_SIZES:
        raise ValueError(f"unsupported ResNet depth {depth}; "
                         f"want one of {sorted(_STAGE_SIZES)}")
    return ResNet(depth=depth, num_classes=num_classes, dtype=dtype,
                  width=width, device=device)

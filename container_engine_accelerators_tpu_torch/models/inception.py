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

"""Inception-v3 (counterpart of container_engine_accelerators_tpu/
models/inception.py): the stem, 3 x A, B, 4 x C, D, 2 x E, the spatial
mean, dropout 0.2 and an f32 ``head``; no auxiliary head, as there.

Every convolution is a ``ConvBN`` (conv without bias, BN with epsilon
1e-3 and momentum 0.9, ReLU); many are VALID. The average pools are
3x3 SAME with flax's ``count_include_pad=True``, so each window sum is
divided by 9, pads included. Submodules carry flax's names
(``ConvBN_k`` with ``Conv_0``/``BatchNorm_0`` inside, ``InceptionA_k``
and the rest, ``head``).

The dropout is keyed by the training step, as the JAX apply function
folds the step into ``PRNGKey(0)``: ``forward(images, step)`` draws
its mask from a generator seeded from (0, step)
(``utils.step_generator``), so a step repeats its mask and the next
step draws a fresh one. jax's bits are not reproduced.
"""

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import step_generator
from .layers import BatchNorm, Conv, Dropout, avg_pool, max_pool
from .transformer import Linear

DROPOUT_KEY = 0


class ConvBN(nn.Module):
    def __init__(self, in_channels, features, kernel, strides=(1, 1),
                 padding="SAME", dtype=torch.bfloat16, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_channels, features, kernel, strides, padding,
                           dtype=dtype, device=device)
        self.BatchNorm_0 = BatchNorm(features, eps=1e-3, momentum=0.9,
                                     dtype=dtype, device=device)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _avg_pool_same(x):
    return avg_pool(x, (3, 3), (1, 1), "SAME")


def _max_pool_valid(x):
    return max_pool(x, (3, 3), (2, 2), "VALID")


class _Mixed(nn.Module):
    """An Inception block: ``conv`` makes its ConvBNs, named
    ``ConvBN_k`` in the order flax creates them."""

    def __init__(self, conv):
        super().__init__()
        self._make = conv
        self._count = 0

    def conv(self, *args, **kwargs):
        module = self._make(*args, **kwargs)
        self.add_module(f"ConvBN_{self._count}", module)
        self._count += 1
        return module


def _chain(convs, x):
    for conv in convs:
        x = conv(x)
    return x


class InceptionA(_Mixed):
    def __init__(self, in_channels, pool_features, conv):
        super().__init__(conv)
        c = self.conv
        self.b1 = [c(in_channels, 64, (1, 1))]
        self.b2 = [c(in_channels, 48, (1, 1)), c(48, 64, (5, 5))]
        self.b3 = [c(in_channels, 64, (1, 1)), c(64, 96, (3, 3)),
                   c(96, 96, (3, 3))]
        self.b4 = [c(in_channels, pool_features, (1, 1))]
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _chain(self.b3, x),
                          _chain(self.b4, _avg_pool_same(x))], dim=1)


class InceptionB(_Mixed):
    def __init__(self, in_channels, conv):
        super().__init__(conv)
        c = self.conv
        self.b1 = [c(in_channels, 384, (3, 3), (2, 2), padding="VALID")]
        self.b2 = [c(in_channels, 64, (1, 1)), c(64, 96, (3, 3)),
                   c(96, 96, (3, 3), (2, 2), padding="VALID")]
        self.out_channels = 384 + 96 + in_channels

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _max_pool_valid(x)], dim=1)


class InceptionC(_Mixed):
    def __init__(self, in_channels, channels_7x7, conv):
        super().__init__(conv)
        c, c7 = self.conv, channels_7x7
        self.b1 = [c(in_channels, 192, (1, 1))]
        self.b2 = [c(in_channels, c7, (1, 1)), c(c7, c7, (1, 7)),
                   c(c7, 192, (7, 1))]
        self.b3 = [c(in_channels, c7, (1, 1)), c(c7, c7, (7, 1)),
                   c(c7, c7, (1, 7)), c(c7, c7, (7, 1)),
                   c(c7, 192, (1, 7))]
        self.b4 = [c(in_channels, 192, (1, 1))]
        self.out_channels = 4 * 192

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _chain(self.b3, x),
                          _chain(self.b4, _avg_pool_same(x))], dim=1)


class InceptionD(_Mixed):
    def __init__(self, in_channels, conv):
        super().__init__(conv)
        c = self.conv
        self.b1 = [c(in_channels, 192, (1, 1)),
                   c(192, 320, (3, 3), (2, 2), padding="VALID")]
        self.b2 = [c(in_channels, 192, (1, 1)), c(192, 192, (1, 7)),
                   c(192, 192, (7, 1)),
                   c(192, 192, (3, 3), (2, 2), padding="VALID")]
        self.out_channels = 320 + 192 + in_channels

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _max_pool_valid(x)], dim=1)


class InceptionE(_Mixed):
    def __init__(self, in_channels, conv):
        super().__init__(conv)
        c = self.conv
        self.b1 = [c(in_channels, 320, (1, 1))]
        self.b2 = [c(in_channels, 384, (1, 1))]
        self.b2_split = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.b3 = [c(in_channels, 448, (1, 1)), c(448, 384, (3, 3))]
        self.b3_split = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.b4 = [c(in_channels, 192, (1, 1))]
        self.out_channels = 320 + 2 * 768 + 192

    def forward(self, x):
        b2 = _chain(self.b2, x)
        b3 = _chain(self.b3, x)
        return torch.cat([_chain(self.b1, x)]
                         + [conv(b2) for conv in self.b2_split]
                         + [conv(b3) for conv in self.b3_split]
                         + [_chain(self.b4, _avg_pool_same(x))], dim=1)


class InceptionV3(nn.Module):
    """Inception-v3 for 299x299 inputs (75x75 is the smallest it
    takes). ``forward(images [B, H, W, C], step=0) -> logits [B,
    num_classes]`` f32."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16,
                 dropout_rate=0.2, device=None):
        super().__init__()
        self.dtype = dtype
        conv = functools.partial(ConvBN, dtype=dtype, device=device)
        self.ConvBN_0 = conv(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = conv(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = conv(32, 64, (3, 3))
        self.ConvBN_3 = conv(64, 80, (1, 1), padding="VALID")
        self.ConvBN_4 = conv(80, 192, (3, 3), padding="VALID")
        self.mixed = []
        channels = 192
        for name, make in (
                ("InceptionA_0", lambda c: InceptionA(c, 32, conv)),
                ("InceptionA_1", lambda c: InceptionA(c, 64, conv)),
                ("InceptionA_2", lambda c: InceptionA(c, 64, conv)),
                ("InceptionB_0", lambda c: InceptionB(c, conv)),
                ("InceptionC_0", lambda c: InceptionC(c, 128, conv)),
                ("InceptionC_1", lambda c: InceptionC(c, 160, conv)),
                ("InceptionC_2", lambda c: InceptionC(c, 160, conv)),
                ("InceptionC_3", lambda c: InceptionC(c, 192, conv)),
                ("InceptionD_0", lambda c: InceptionD(c, conv)),
                ("InceptionE_0", lambda c: InceptionE(c, conv)),
                ("InceptionE_1", lambda c: InceptionE(c, conv))):
            block = make(channels)
            self.add_module(name, block)
            self.mixed.append(name)
            channels = block.out_channels
        self.dropout = Dropout(dropout_rate)
        self.head = Linear(channels, num_classes, torch.float32,
                           torch.float32, device=device)

    def forward(self, images, step=0):
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = _max_pool_valid(x)
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = _max_pool_valid(x)
        for name in self.mixed:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        gen = None
        if self.training and self.dropout.rate:
            gen = step_generator(DROPOUT_KEY, step, x.device)
        x = self.dropout(x, gen)
        return self.head(x.float())

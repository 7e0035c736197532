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

"""MNIST MLP (counterpart of container_engine_accelerators_tpu/
models/mlp.py): flatten the NHWC image in (h, w, c) order, two ReLU
Dense layers in the compute dtype, an f32 last Dense on an f32 copy.
No BN and no dropout, so train and eval mode compute the same thing.
Submodules carry flax's names (``Dense_0`` .. ``Dense_2``)."""

import torch
import torch.nn.functional as F
from torch import nn

from .transformer import Linear

# The demo's MNIST images (flax infers the first Dense's input width
# from them; torch needs it at construction).
IMAGE_SHAPE = (28, 28, 1)


class MnistMLP(nn.Module):
    def __init__(self, hidden=512, num_classes=10, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        in_features = IMAGE_SHAPE[0] * IMAGE_SHAPE[1] * IMAGE_SHAPE[2]
        self.Dense_0 = Linear(in_features, hidden, dtype, torch.float32,
                              device=device)
        self.Dense_1 = Linear(hidden, hidden, dtype, torch.float32,
                              device=device)
        self.Dense_2 = Linear(hidden, num_classes, torch.float32,
                              torch.float32, device=device)

    def forward(self, images):
        x = images.reshape(images.shape[0], -1).to(self.dtype)
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x.float())

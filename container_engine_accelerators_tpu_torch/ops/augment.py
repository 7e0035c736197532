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

"""Device-side image augmentation (counterpart of
container_engine_accelerators_tpu/ops/augment.py), on [B, H, W, C]
batches where they already are.

Every function takes an explicit ``torch.Generator`` on the batch's
device (the Trainer seeds one from (17, step), ``utils.step_generator``)
and draws its random decisions first (``flip_mask``, ``crop_offsets``),
so a test can hand them in. Decisions follow the JAX package's
distributions (flip with probability 1/2; crop offsets uniform in
[0, 2 * padding]), not its bits.
"""

import torch
import torch.nn.functional as F


def flip_mask(generator, batch, device):
    """[batch] bool: which images to flip (each with probability 1/2)."""
    return torch.rand(batch, generator=generator, device=device) < 0.5


def crop_offsets(generator, batch, padding, device):
    """[2, batch] int64: the (row, column) offset of each image's window
    in its padded copy, uniform in [0, 2 * padding]."""
    return torch.randint(0, 2 * padding + 1, (2, batch),
                         generator=generator, device=device)


def random_flip(generator, images, mask=None):
    """Horizontal flip, per image iid with probability 1/2 (``mask``, a
    [B] bool, replaces the draw)."""
    if mask is None:
        mask = flip_mask(generator, images.shape[0], images.device)
    return torch.where(mask[:, None, None, None], images.flip(2), images)


def random_crop(generator, images, padding, offsets=None):
    """Pad by ``padding`` (reflect, numpy's and jnp.pad's ``reflect``:
    the edge is not repeated) and take a [H, W] window per image at
    ``offsets`` ([2, B], drawn when not given)."""
    b, h, w, _ = images.shape
    padded = F.pad(images.permute(0, 3, 1, 2),
                   (padding, padding, padding, padding),
                   mode="reflect").permute(0, 2, 3, 1)
    if offsets is None:
        offsets = crop_offsets(generator, b, padding, images.device)
    oy, ox = offsets.to(images.device)
    rows = oy[:, None] + torch.arange(h, device=images.device)
    cols = ox[:, None] + torch.arange(w, device=images.device)
    batch = torch.arange(b, device=images.device)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


def make_augment_fn(flip=True, crop_padding=0):
    """Compose the enabled augmentations into one ``(generator,
    images) -> images`` for ``Trainer(augment_fn=...)``: the crop
    first, then the flip; None if nothing is enabled."""
    if not flip and not crop_padding:
        return None

    def augment(generator, images):
        if crop_padding:
            images = random_crop(generator, images, crop_padding)
        if flip:
            images = random_flip(generator, images)
        return images

    return augment

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


"""Synthetic device-resident batches (counterpart of the pool loaders
of container_engine_accelerators_tpu/parallel/data.py).

The batches are the JAX package's numpy batches from seeds
``0..pool-1``, so the images, labels and token streams are identical;
each is placed on the device once, and iteration costs no host work
per step. ``PrefetchLoader`` and ``NpzShardDataset`` (real data) are
not ported yet.
"""

import numpy as np
import torch


class _PoolLoader:
    """Infinite loader cycling a small pool of device-resident
    batches."""

    def __init__(self, batches):
        self._pool = list(batches)
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        batch = self._pool[self._i % len(self._pool)]
        self._i += 1
        return batch


def synthetic_batch(batch_size, image_shape, num_classes, seed=0,
                    dtype=np.float32):
    """One host-generated (images, labels) pair of numpy arrays: images
    standard normal [batch, *image_shape], labels int32 in
    [0, num_classes)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (batch_size, *image_shape), dtype=np.float32).astype(dtype)
    labels = rng.integers(0, num_classes, size=(batch_size,),
                          dtype=np.int32)
    return images, labels


def synthetic_step_batch(step, batch_size, image_shape, num_classes,
                         seed=0, dtype=np.float32):
    """The global batch for one step, deterministic in (seed, step):
    any step's batch can be made again on its own."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed), int(step)]))
    images = rng.standard_normal(
        (batch_size, *image_shape), dtype=np.float32).astype(dtype)
    labels = rng.integers(0, num_classes, size=(batch_size,),
                          dtype=np.int32)
    return images, labels


class SyntheticLoader(_PoolLoader):
    """Image-classification batches: (images, labels) pairs, images
    NHWC f32 [batch, *image_shape] and labels int32 [batch], placed on
    ``device`` (the JAX loader's ``sharding``) once."""

    def __init__(self, batch_size, image_shape, num_classes, device="cuda",
                 pool=2, dtype=np.float32):
        batches = []
        for seed in range(pool):
            images, labels = synthetic_batch(
                batch_size, image_shape, num_classes, seed=seed, dtype=dtype)
            batches.append((torch.from_numpy(images).to(device),
                            torch.from_numpy(labels).to(device)))
        super().__init__(batches)


class SyntheticTokenLoader(_PoolLoader):
    """LM batches: (tokens, tokens) pairs of int32 [batch, seq] for the
    shift-by-one next-token objective (transformer.next_token_loss_fn).
    ``device`` takes the place of the JAX loader's ``sharding``."""

    def __init__(self, batch_size, seq_len, vocab_size, device="cuda",
                 pool=2):
        batches = []
        for seed in range(pool):
            rng = np.random.default_rng(seed)
            tokens = rng.integers(0, vocab_size,
                                  size=(batch_size, seq_len),
                                  dtype=np.int32)
            tokens = torch.from_numpy(tokens).to(device)
            batches.append((tokens, tokens))
        super().__init__(batches)

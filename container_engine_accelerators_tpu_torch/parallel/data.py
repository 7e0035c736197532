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
``0..pool-1``, so the token streams are identical; each is placed on
the device once, and iteration costs no host work per step.
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

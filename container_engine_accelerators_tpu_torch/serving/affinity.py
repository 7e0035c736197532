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

"""Content-keyed prefix chain hashing: the affinity-key function.

The port's own copy of the JAX package's ``serving/affinity.py``. The
paged block pool (``models/decode.py`` ``_BlockPool``) indexes prompt-
prefix KV blocks by a running SHA-256 chain over block contents, and
the fleet router steers a request to the engine already holding its
prefix blocks by computing the same key. The keys are byte-identical
to the JAX package's, so one router steers to JAX and torch engines
alike (``tests/test_torch_paging.py`` pins the identity).
"""

import hashlib

import numpy as np

from ..utils import env_number

# The paged pool's block size knob; router and engine read the same
# one, or their affinity keys diverge.
KV_BLOCK_ENV = "CEA_TPU_KV_BLOCK"
DEFAULT_BLOCK_SIZE = 16


def default_block_size():
    """The engine's KV block size as the router resolves it:
    ``CEA_TPU_KV_BLOCK`` or the built-in default."""
    return int(env_number(KV_BLOCK_ENV, DEFAULT_BLOCK_SIZE, parse=int))


def chain_digest(prev, payload):
    """One link of the content chain: SHA-256 over the previous link's
    digest, then this block's tokens as int64 bytes. A partial (prompt-
    tail) block is tagged ``("partial", tokens)`` so a full block and a
    partial block with the same leading tokens never collide."""
    h = hashlib.sha256(b"" if prev is None else prev)
    if (isinstance(payload, tuple) and payload
            and payload[0] == "partial"):
        h.update(b"partial")
        payload = payload[1]
    h.update(np.asarray(payload, np.int64).tobytes())
    return h.digest()


def full_block_keys(tokens, block_size):
    """The chain keys of every full ``block_size`` block of ``tokens``,
    in order: the keys the pool registers for a prompt's full
    blocks."""
    keys = []
    chain = None
    for i in range(len(tokens) // block_size):
        chain = chain_digest(
            chain, tuple(tokens[i * block_size:(i + 1) * block_size]))
        keys.append(chain)
    return keys


def partial_key(chain, tokens):
    """The chain key of a prompt-tail partial block (``tokens`` is its
    content, ``chain`` the last full-block key or None)."""
    return chain_digest(chain, ("partial", tuple(tokens)))


def affinity_key(tokens, block_size, max_blocks=None):
    """The router's placement key for a prompt: the chain key of its
    leading full blocks (at most ``max_blocks``), or None for a prompt
    shorter than one block. Two prompts agree on it iff they agree on
    every token of the covered region."""
    full = len(tokens) // block_size
    if max_blocks is not None:
        full = min(full, int(max_blocks))
    if full < 1:
        return None
    return full_block_keys(tokens[:full * block_size], block_size)[-1]

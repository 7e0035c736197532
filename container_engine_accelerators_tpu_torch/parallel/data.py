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


"""Input pipelines (counterpart of
container_engine_accelerators_tpu/parallel/data.py).

The synthetic loaders give the JAX package's numpy batches from seeds
``0..pool-1``, so the images, labels and token streams are identical;
each is placed on the device once, and iteration costs no host work
per step.

For real data the pipeline is ``PrefetchLoader`` over any host-batch
iterator (``NpzShardDataset`` reads ``.npz`` shard files, yielding the
JAX reader's batches bitwise): a background thread pins each batch and
copies it to the card on a side stream while the previous step runs,
and the consumer's stream waits on that copy before it reads the
batch. ``shard_assignment`` and ``reassign_shards`` are the elastic
supervisor's unit of data reassignment.
"""

import os
import queue
import threading
import time
import zipfile

import numpy as np
import torch

from .. import obs


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


def shard_assignment(num_shards, hosts):
    """{host: [shard indices]}: contiguous blocks, the remainder to the
    leading hosts. A "shard" is whatever the pipeline splits by host (a
    batch-row range, an .npz file set)."""
    hosts = list(hosts)
    if not hosts:
        raise ValueError("no hosts to assign shards to")
    if num_shards < len(hosts):
        raise ValueError(
            f"{num_shards} shards cannot cover {len(hosts)} hosts; "
            f"an unfed host would idle its chips")
    base, extra = divmod(num_shards, len(hosts))
    out, next_shard = {}, 0
    for i, host in enumerate(hosts):
        n = base + (1 if i < extra else 0)
        out[host] = list(range(next_shard, next_shard + n))
        next_shard += n
    return out


def reassign_shards(assignment, departed):
    """Fold departed hosts' shards onto the survivors: each survivor
    keeps its own shards in order and gains the orphans appended
    least-loaded first (ties by host name), so the load stays within
    one shard."""
    departed = set(departed)
    survivors = {h: list(s) for h, s in assignment.items()
                 if h not in departed}
    if not survivors:
        raise ValueError("eviction would leave no hosts")
    orphaned = sorted(s for h in departed & set(assignment)
                      for s in assignment[h])
    order = sorted(survivors)
    for shard in orphaned:
        host = min(order, key=lambda h: len(survivors[h]))
        survivors[host].append(shard)
    return survivors


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


def _tree_map(fn, tree):
    """``fn`` on every leaf of a batch (tuples, lists and dicts of
    arrays)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class PrefetchLoader:
    """Stage host batches onto the device ahead of the consumer.

    Wraps any iterator of batches (tuples, lists or dicts of numpy
    arrays). A daemon thread turns each into tensors on ``device``
    (the JAX loader's ``sharding``; None leaves the numpy batch as it
    is) through a bounded queue of depth ``prefetch``. To a card the
    thread pins the host arrays and copies them without blocking on a
    side stream, recording an event after the copy; ``next()`` makes
    the consumer's current stream wait on that event and records the
    tensors on it, so a step never reads a half-copied batch and the
    allocator never hands their memory out while the step may still
    read it. On the CPU the tensors share the numpy arrays' memory.

    Exceptions from the source re-raise at the consuming ``next()``,
    stickily (every later ``next()`` re-raises the same error);
    exhaustion is StopIteration. A consumer that stops early must
    ``close()`` the loader (or use it as a context manager), or the
    thread keeps ``prefetch`` + 1 staged batches in device memory.
    ``wait_cb`` is called with each ``next()``'s wait in seconds.
    """

    _DONE = object()

    def __init__(self, source, device=None, prefetch=2, wait_cb=None):
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1: {prefetch}")
        self._wait_cb = wait_cb
        self._device = None if device is None else torch.device(device)
        self._stream = None
        if self._device is not None and self._device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._device)
        self._q = queue.Queue(maxsize=prefetch)
        self._closed = threading.Event()
        self._exc = None
        self._done = False
        self._thread = threading.Thread(
            target=self._stage, args=(iter(source),),
            name="tpu-data-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item):
        """Blocking put that gives up once the loader is closed."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, batch):
        """(batch on the device, the copy's event or None)."""
        if self._device is None:
            return batch, None
        if self._stream is None:
            return _tree_map(lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).to(self._device), batch), None
        with torch.cuda.stream(self._stream):
            out = _tree_map(lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).pin_memory().to(
                    self._device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _stage(self, it):
        try:
            for batch in it:
                if self._closed.is_set():
                    return
                if not self._put(self._to_device(batch)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._put(e)
            return
        self._put(self._DONE)

    def close(self):
        """Stop staging and release the queued batches."""
        self._closed.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._exc is not None:
            raise self._exc
        if self._done or self._closed.is_set():
            raise StopIteration
        if obs.TRACER.enabled or self._wait_cb is not None:
            # How long the consumer waited for a staged batch: near
            # zero while prefetch keeps up.
            t0 = time.perf_counter()
            with obs.span("train.data_wait"):
                item = self._q.get()
            if self._wait_cb is not None:
                self._wait_cb(time.perf_counter() - t0)
        else:
            item = self._q.get()
        if item is self._DONE:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._exc = item
            raise item
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            _tree_map(lambda t: t.record_stream(stream), batch)
        return batch


def _npz_rows(path, name="images"):
    """Leading-dim length of one array in an .npz, read from its .npy
    header alone (no decompression): what makes a resume's
    fast-forward over big shards cheap."""
    from numpy.lib import format as npfmt

    with zipfile.ZipFile(path) as zf:
        with zf.open(name + ".npy") as f:
            version = npfmt.read_magic(f)
            if version == (1, 0):
                shape, _, _ = npfmt.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, _, _ = npfmt.read_array_header_2_0(f)
            elif hasattr(npfmt, "_read_array_header"):
                # 3.0 (utf-8 header) and later versions numpy knows.
                shape, _, _ = npfmt._read_array_header(f, version)
            else:
                raise ValueError(
                    f"unsupported .npy format version {version} "
                    f"in {path}:{name}")
    return shape[0]


class NpzShardDataset:
    """Host-side reader over a directory of .npz shard files.

    Each shard is an ``np.savez`` archive with ``images`` and
    ``labels`` arrays (any leading length). Iteration yields
    fixed-size (images, labels) numpy batches, reshuffling the shard
    order each epoch with the seed ``seed + epoch``; ``epochs=None``
    repeats forever; a tail smaller than a batch crosses into the next
    shard and is dropped at the epoch's end. Pair with PrefetchLoader
    for the device side.

    ``skip_batches`` fast-forwards for a checkpoint resume: whole
    shards are skipped by their .npy headers alone, then the first
    loaded shard is sliced. The accounting is per shard: leftovers
    that cross a boundary inside the skipped region are dropped, not
    rebuilt, so up to (shards skipped) x (batch - 1) samples near those
    boundaries are not yielded again; the stream after the resume
    point is deterministic.
    """

    def __init__(self, data_dir, batch_size, epochs=None, seed=0,
                 dtype=None, skip_batches=0):
        self._paths = sorted(
            os.path.join(data_dir, f) for f in os.listdir(data_dir)
            if f.endswith(".npz"))
        if not self._paths:
            raise FileNotFoundError(f"no .npz shards under {data_dir}")
        self._batch = batch_size
        self._epochs = epochs
        self._seed = seed
        self._dtype = dtype
        self._skip = int(skip_batches)

    def __iter__(self):
        epoch = 0
        leftover = None
        to_skip = self._skip
        while self._epochs is None or epoch < self._epochs:
            order = np.random.default_rng(
                self._seed + epoch).permutation(len(self._paths))
            for idx in order:
                path = self._paths[idx]
                if to_skip:
                    # Per-shard accounting (leftover dropped): the
                    # batches this shard alone yields.
                    own = _npz_rows(path) // self._batch
                    if own <= to_skip:
                        to_skip -= own
                        leftover = None
                        continue
                with np.load(path) as shard:
                    images = shard["images"]
                    labels = shard["labels"]
                if self._dtype is not None:
                    images = images.astype(self._dtype)
                if to_skip:
                    images = images[to_skip * self._batch:]
                    labels = labels[to_skip * self._batch:]
                    to_skip = 0
                    leftover = None
                if leftover is not None:
                    images = np.concatenate([leftover[0], images])
                    labels = np.concatenate([leftover[1], labels])
                    leftover = None
                n_full = len(images) // self._batch * self._batch
                for lo in range(0, n_full, self._batch):
                    yield (images[lo:lo + self._batch],
                           labels[lo:lo + self._batch])
                if n_full < len(images):
                    leftover = (images[n_full:], labels[n_full:])
            # A tail carried into the next epoch would be yielded
            # again when its shard is read next epoch.
            leftover = None
            epoch += 1

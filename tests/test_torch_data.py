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

"""The port's input pipeline against the JAX package's
(counterparts of tests/test_data.py).

``NpzShardDataset`` yields batches bitwise equal to the JAX reader's on
the same shards: epochs, shard boundaries, aligned and unaligned
``skip_batches``. ``PrefetchLoader`` keeps order and values, reports
its waits, places batches on the device it is given, and keeps the
JAX loader's sticky errors, close and context manager. The port's
driver trains a ResNet from shards beside the demo driver on the same
shards (f32, tests/torch_drivers.py; losses 1e-5 relative, parameters
1e-4 relative L2, BN statistics 1e-5 of the largest value, as
tests/test_torch_image_train.py holds the two trainers).
"""

import itertools
import time
import zipfile
from unittest import mock

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.parallel import (
    NpzShardDataset as JaxNpzShardDataset,
)
from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.parallel import (
    NpzShardDataset,
    PrefetchLoader,
    Sgd,
    Trainer,
    cross_entropy_loss,
)
from container_engine_accelerators_tpu_torch.parallel import data as D
from tests import torch_drivers
from tests.torch_drivers import RESNET_FLAGS


def _shards(tmp_path, sizes, dim=4, classes=10):
    """.npz shards with globally increasing labels; images[i] encodes
    its global index."""
    idx = 0
    for s, size in enumerate(sizes):
        images = np.stack([np.full((dim,), idx + i, np.float32)
                           for i in range(size)])
        labels = np.arange(idx, idx + size, dtype=np.int32) % classes
        np.savez(tmp_path / f"shard{s}.npz", images=images, labels=labels)
        idx += size
    return str(tmp_path)


def _same_as_jax(data_dir, **kwargs):
    """The port's batches, checked bitwise against the JAX reader's."""
    got = list(NpzShardDataset(data_dir, **kwargs))
    want = list(JaxNpzShardDataset(data_dir, **kwargs))
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    return got


def test_prefetch_preserves_order_and_values():
    source = [(np.full((2, 3), i, np.float32),
               np.full((2,), i, np.int32)) for i in range(7)]
    out = list(PrefetchLoader(iter(source)))
    assert len(out) == 7
    for i, (images, labels) in enumerate(out):
        np.testing.assert_array_equal(images, source[i][0])
        np.testing.assert_array_equal(labels, source[i][1])


def test_prefetch_wait_cb_reports_consumer_waits():
    def slow_source():
        for i in range(3):
            time.sleep(0.02)
            yield (np.full((1,), i, np.float32),
                   np.full((1,), i, np.int32))

    waits = []
    out = list(PrefetchLoader(slow_source(), wait_cb=waits.append))
    assert len(out) == 3
    assert len(waits) >= 3  # one per batch (+ the end-of-stream read)
    assert all(w >= 0 for w in waits)
    assert sum(waits) > 0


def test_prefetch_places_batches_on_the_device():
    """``device`` takes the place of the JAX loader's ``sharding``: a
    dict or tuple batch comes back as tensors on it, dtypes kept; no
    device leaves the numpy batch as it is."""
    source = [(np.ones((16, 3), np.float32), np.arange(16, dtype=np.int32)),
              {"x": np.zeros((2, 2), np.float32)}]
    first, second = list(PrefetchLoader(iter(source), device="cpu"))
    images, labels = first
    assert isinstance(images, torch.Tensor) and images.device.type == "cpu"
    assert images.dtype == torch.float32 and labels.dtype == torch.int32
    np.testing.assert_array_equal(labels.numpy(), source[0][1])
    assert isinstance(second["x"], torch.Tensor)
    (raw, _), _ = list(PrefetchLoader(iter(source)))
    assert raw is source[0][0]


def test_prefetch_propagates_source_error():
    def bad():
        yield (np.zeros(2), np.zeros(2))
        raise RuntimeError("disk on fire")

    it = PrefetchLoader(bad())
    next(it)
    with pytest.raises(RuntimeError, match="disk on fire"):
        next(it)


def test_prefetch_rejects_bad_depth():
    with pytest.raises(ValueError):
        PrefetchLoader(iter([]), prefetch=0)


def test_prefetch_error_is_sticky_not_deadlock():
    def bad():
        raise RuntimeError("boom")
        yield  # pragma: no cover

    it = PrefetchLoader(bad(), device="cpu")
    for _ in range(3):
        with pytest.raises(RuntimeError, match="boom"):
            next(it)


def test_prefetch_close_releases_stage_thread():
    def infinite():
        i = 0
        while True:
            yield (np.full((2,), i, np.float32),)
            i += 1

    loader = PrefetchLoader(infinite(), prefetch=2, device="cpu")
    next(loader)
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)


def test_prefetch_context_manager_closes():
    with PrefetchLoader(iter([(np.zeros(2),)] * 100)) as loader:
        next(loader)
    assert not loader._thread.is_alive()


def test_npz_shards_batches_span_shard_boundaries(tmp_path):
    # 5 + 3 + 6 = 14 samples; batch 4 -> 3 batches/epoch, 2 dropped.
    batches = _same_as_jax(_shards(tmp_path, [5, 3, 6]), batch_size=4,
                           epochs=1)
    assert len(batches) == 3
    seen = np.concatenate([b[0][:, 0] for b in batches])
    assert len(set(seen.tolist())) == 12
    for images, labels in batches:
        assert images.shape == (4, 4) and labels.shape == (4,)
        np.testing.assert_array_equal(images[:, 0].astype(np.int32) % 10,
                                      labels)


def test_npz_shards_epochs_and_determinism(tmp_path):
    data_dir = _shards(tmp_path, [4, 4])
    two = _same_as_jax(data_dir, batch_size=4, epochs=2)
    assert len(two) == 4
    again = list(NpzShardDataset(data_dir, batch_size=4, epochs=2))
    for (a, _), (b, _) in zip(two, again):
        np.testing.assert_array_equal(a, b)
    _same_as_jax(data_dir, batch_size=4, epochs=3, seed=5)


def test_npz_shards_no_duplicates_across_epochs(tmp_path):
    batches = _same_as_jax(_shards(tmp_path, [5, 3, 6]), batch_size=4,
                           epochs=2)
    assert len(batches) == 6
    for part in (batches[:3], batches[3:]):
        seen = np.concatenate([b[0][:, 0] for b in part])
        assert len(set(seen.tolist())) == 12


def test_npz_shards_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        NpzShardDataset(str(tmp_path), batch_size=2)


def test_npz_skip_batches_exact_with_aligned_shards(tmp_path):
    data_dir = _shards(tmp_path, [8, 8, 8])
    full = _same_as_jax(data_dir, batch_size=4, epochs=1)
    for k in (1, 2, 3, 5):
        resumed = _same_as_jax(data_dir, batch_size=4, epochs=1,
                               skip_batches=k)
        assert len(resumed) == len(full) - k
        for (gi, gl), (wi, wl) in zip(resumed, full[k:]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_npz_skip_batches_header_only_shard_skip(tmp_path):
    data_dir = _shards(tmp_path, [8, 8, 8])
    loaded = []
    real_load = np.load

    def spy_load(path, *a, **kw):
        loaded.append(str(path))
        return real_load(path, *a, **kw)

    with mock.patch.object(D.np, "load", side_effect=spy_load):
        out = list(D.NpzShardDataset(data_dir, batch_size=4, epochs=1,
                                     skip_batches=2))
    assert len(out) == 4
    assert len(loaded) == 2
    assert D._npz_rows(loaded[0]) == 8


def test_npz_skip_batches_unaligned_is_shard_conservative(tmp_path):
    data_dir = _shards(tmp_path, [10, 7, 9])
    a = _same_as_jax(data_dir, batch_size=4, epochs=1, skip_batches=3)
    full = list(NpzShardDataset(data_dir, batch_size=4, epochs=1))
    skipped = {float(x) for img, _ in full[:3] for x in img[:, 0]}
    resumed = {float(x) for img, _ in a for x in img[:, 0]}
    assert not (skipped & resumed)
    _same_as_jax(data_dir, batch_size=4, epochs=2, skip_batches=7)


def test_npz_rows_reads_each_header_version(tmp_path):
    from numpy.lib import format as npfmt

    for version in ((1, 0), (2, 0), (3, 0)):
        path = tmp_path / f"v{version[0]}.npz"
        with zipfile.ZipFile(path, "w") as zf:
            with zf.open("images.npy", "w") as f:
                npfmt.write_array(f, np.zeros((7, 2), np.float32),
                                  version=version)
        assert D._npz_rows(str(path)) == 7


def test_file_pipeline_feeds_trainer(tmp_path):
    """NpzShardDataset -> PrefetchLoader -> the port's train steps."""
    dim, classes = 8, 4
    data_dir = _shards(tmp_path, [20, 20], dim=dim, classes=classes)
    model = torch.nn.Linear(dim, classes)
    trainer = Trainer(model, cross_entropy_loss, Sgd(0.1))
    state = trainer.init_state()
    steps = 0
    with PrefetchLoader(NpzShardDataset(data_dir, batch_size=16, epochs=1),
                        device="cpu") as loader:
        for batch in loader:
            state, loss = trainer.train_step(state, batch)
            steps += 1
    assert steps == 2  # 40 samples / 16 -> 2 full batches
    assert state.step == 2 and np.isfinite(float(loss))


def test_train_driver_resnet_real_data(tmp_path):
    """The driver on shards: the demo driver writes its initial state
    (checkpoint_0), then it and the port's driver each take 3 steps of
    a ResNet-18 (width 8, f32) from it on the same 3 shards of 12 images
    (batches of 8 cross the shard boundaries); the port then resumes for
    2 more, past the batches taken."""
    import shutil

    rng = np.random.default_rng(0)
    shards = tmp_path / "shards"
    shards.mkdir()
    for s in range(3):
        np.savez(shards / f"s{s}.npz",
                 images=rng.standard_normal((12, 33, 33, 3)).astype(
                     np.float32),
                 labels=rng.integers(0, 10, size=(12,), dtype=np.int32))
    argv = [*RESNET_FLAGS, "--batch-size", "8", "--warmup-steps", "0",
            "--data-dir", str(shards)]
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    demo = torch_drivers.demo_train()
    seen = []
    with torch_drivers.f32_models():
        demo.main(argv + ["--steps", "0", "--model-dir", theirs])
        shutil.copytree(theirs, mine)
        want = demo.main(argv + ["--steps", "3", "--model-dir", theirs])
        result, _, state = port_train.run(
            port_train.parse_args(argv + [
                "--device", "cpu", "--steps", "3", "--model-dir", mine]),
            on_batch=lambda step, batch: seen.append(batch[1].numpy()))
        np.testing.assert_allclose(result["final_loss"], want["final_loss"],
                                   rtol=1e-5)
        assert result["data_wait_ms_mean"] >= 0
        assert len(seen) == 3
        stream = itertools.islice(JaxNpzShardDataset(str(shards), 8), 3)
        for labels, (_, expect) in zip(seen, stream):
            np.testing.assert_array_equal(labels, expect)
        got = torch_drivers.flat(convert.image_variables_to_flax(state.model))
        ref = torch_drivers.archive(tmp_path / "jax" / "checkpoint_3")
        for name, value in got.items():
            w = ref["".join(f"[{p!r}]" for p in name.split("/"))]
            if name.startswith("batch_stats"):
                assert np.abs(value - w).max() <= 1e-5 * np.abs(w).max(), name
            else:
                assert torch_drivers.rel_l2(value, w) <= 1e-4, name
        seen.clear()
        port_train.run(port_train.parse_args(argv + [
            "--device", "cpu", "--steps", "2", "--model-dir", mine]),
            on_batch=lambda step, batch: seen.append(batch[1].numpy()))
    skip = list(itertools.islice(
        JaxNpzShardDataset(str(shards), 8, skip_batches=3), 2))
    assert len(seen) == 2
    for labels, (_, expect) in zip(seen, skip):
        np.testing.assert_array_equal(labels, expect)


def test_chip_smoke_replay_shards_give_a_straight_run(tmp_path):
    """chip_smoke.py's phase 14 compares a resumed run with a straight
    run on shards that replay the resumed run's batches: NpzShardDataset
    reads them back in the given order (and the JAX reader too)."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(torch_drivers.REPO_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    data = _shards(tmp_path, [5, 5, 5, 5, 5], dim=3)
    first = list(itertools.islice(NpzShardDataset(data, 4), 4))
    resumed = list(itertools.islice(NpzShardDataset(data, 4,
                                                    skip_batches=4), 2))
    replay = tmp_path / "replay"
    replay.mkdir()
    cs.replay_shards(np, str(replay), first + resumed)
    got = _same_as_jax(str(replay), batch_size=4, epochs=1)
    assert len(got) == 6
    for (gi, gl), (wi, wl) in zip(got, first + resumed):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    # The resumed batches are not the straight stream's 5th and 6th.
    straight = list(itertools.islice(NpzShardDataset(data, 4), 6))
    assert not np.array_equal(straight[4][0], resumed[0][0])

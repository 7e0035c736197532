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

"""The port's checkpoints against the JAX package's, through both
training drivers.

For each case (mnist at a constant rate; mnist and a ResNet-18 of width
8 with BN under a schedule, a gradient clip and EMA; a tiny transformer
and a tiny MoE) the demo driver trains 2 steps into a directory; the
port's driver resumes there for 2 more, and so does the demo driver in
a copy. The two ``checkpoint_4``s have the same keys, shapes, dtypes
and meta keys, and agree within the trainers' tolerances
(tests/test_torch_train.py, tests/test_torch_image_train.py, f32):
LM parameters and EMA 1e-4 relative + 1e-5 absolute, image parameters
and EMA and every momentum trace 1e-4 relative L2, BN statistics 1e-5
of the largest value; step and update count exactly. Then the demo
driver restores the port's ``checkpoint_4``: every leaf it reads equals
the port's state exactly. Both drivers run in f32 compute
(tests/torch_drivers.py).

The manager's own contract (retention, background failure, save after
close, partial restore, EMA re-seeding) follows tests/test_elastic.py,
and the driver's checkpoint tests of tests/test_parallel.py run through
the port's driver.
"""

import functools
import os
import shutil
import threading

import jax
import numpy as np
import optax
import pytest
import torch

from container_engine_accelerators_tpu.parallel.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.parallel import (
    Sgd,
    SyntheticLoader,
    Trainer,
)
from container_engine_accelerators_tpu_torch.parallel import checkpoint
from container_engine_accelerators_tpu_torch.parallel.checkpoint import (
    CheckpointError,
    CheckpointManager,
    keystr_items,
    list_checkpoints,
    restore_state,
    state_payload,
)
from container_engine_accelerators_tpu_torch.ops import xent
from tests import torch_drivers, torch_parity
from tests.torch_drivers import LM_FLAGS, RESNET_FLAGS

COMMON = ["--batch-size", "8", "--warmup-steps", "0"]
SCHEDULE = ["--lr-warmup-steps", "3"]  # every update of both runs moves
CASES = {
    "mnist": ["--model", "mnist"],
    "mnist_schedule": ["--model", "mnist", "--lr-schedule", "cosine",
                       *SCHEDULE, "--grad-clip", "0.5", "--ema-decay",
                       "0.9"],
    "resnet": [*RESNET_FLAGS, "--lr-schedule", "linear", *SCHEDULE,
               "--grad-clip", "1.0", "--ema-decay", "0.9"],
    "transformer": ["--model", "transformer", *LM_FLAGS, "--lr-schedule",
                    "cosine", *SCHEDULE, "--ema-decay", "0.9"],
    "moe": ["--model", "moe", "--num-experts", "4", *LM_FLAGS,
            "--grad-clip", "1.0"],
}
LM_CASES = ("transformer", "moe")


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@functools.lru_cache(maxsize=None)
def _flow(case, root):
    """The case's runs; returns (port-written dir, demo-written dir,
    the port's final state and argv, the demo driver's state restored
    from the port's checkpoint)."""
    argv = CASES[case] + COMMON
    demo = torch_drivers.demo_train()
    mine = os.path.join(root, case, "port")
    theirs = os.path.join(root, case, "jax")
    read = os.path.join(root, case, "read")
    captured = {}
    real_restore = demo.restore_checkpoint

    def capture(model_dir, state, shardings=None):
        captured["state"] = real_restore(model_dir, state, shardings)
        return captured["state"]

    with torch_drivers.f32_models():
        demo.main(argv + ["--steps", "2", "--model-dir", mine])
        shutil.copytree(mine, theirs)
        args = port_train.parse_args(
            argv + ["--device", "cpu", "--steps", "2", "--model-dir", mine])
        _, _, state = port_train.run(args)
        demo.main(argv + ["--steps", "2", "--model-dir", theirs])
        shutil.copytree(mine, read)
        demo.restore_checkpoint = capture
        try:
            demo.main(argv + ["--steps", "0", "--model-dir", read])
        finally:
            demo.restore_checkpoint = real_restore
    return mine, theirs, state, args, captured["state"]


def _archives(case, root):
    mine, theirs, *_ = _flow(case, str(root))
    return (torch_drivers.archive(os.path.join(mine, "checkpoint_4")),
            torch_drivers.archive(os.path.join(theirs, "checkpoint_4")))


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_checkpoint_resumes_in_the_port(case, root):
    """The port resumes the demo driver's checkpoint_2 and takes the
    same two steps the demo driver takes from it."""
    got, want = _archives(case, root)
    assert int(got["['step']"]) == int(want["['step']"]) == 4
    for key in want:
        g, w = got[key], want[key]
        if key == "['step']" or key.endswith(".count"):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key.startswith("['batch_stats']"):
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), key
        elif case in LM_CASES and not key.startswith("['opt_state']"):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=key)
        else:
            assert torch_drivers.rel_l2(g, w) <= 1e-4, key
    # The resumed steps moved the weights and traces.
    first = torch_drivers.archive(os.path.join(
        _flow(case, str(root))[1], "checkpoint_2"))
    assert any(not np.array_equal(first[k], got[k]) for k in got
               if k.startswith("['params']"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_drivers_write_the_same_keys(case, root):
    got, want = _archives(case, root)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
    has = {part for part in ("['ema_params']", ".count", "['batch_stats']")
           if any(part in k for k in want)}
    flags = CASES[case]
    assert ("['ema_params']" in has) == ("--ema-decay" in flags)
    assert (".count" in has) == ("--lr-schedule" in flags)
    assert ("['batch_stats']" in has) == ("resnet" in flags)
    mine, theirs, *_ = _flow(case, str(root))
    meta = [CheckpointManager(d).manifest(4) for d in (mine, theirs)]
    assert set(meta[0]) == set(meta[1])
    for key in ("format_version", "step", "leaf_count", "keys", "bytes",
                "async"):
        assert meta[0][key] == meta[1][key], key
    assert set(meta[0]["identity"]) == set(meta[1]["identity"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_reads_the_port_checkpoint_exactly(case, root):
    """The demo driver's restore of the port's checkpoint_4 holds the
    port's final state, leaf for leaf, bit for bit."""
    _, _, state, args, restored = _flow(case, str(root))
    tree = {"step": restored.step, "params": restored.params,
            "opt_state": restored.opt_state,
            "batch_stats": restored.batch_stats}
    if restored.ema_params is not None:
        tree["ema_params"] = restored.ema_params
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    theirs = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    config, schedule = port_train._state_layout(args)
    mine = {k: checkpoint._host_copy(v) for k, v in
            keystr_items(state_payload(state, config, schedule))}
    assert sorted(mine) == sorted(theirs)
    for key, value in mine.items():
        assert value.dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(value, theirs[key], err_msg=key)


def test_keystr_matches_jax():
    """The port renders optax's and the demo's tree paths as
    ``jax.tree_util.keystr`` does: mapping keys, sequence indices, named
    fields; None and empty states hold no leaf."""
    leaf = np.zeros(2, np.float32)
    masked = optax.MaskedState(inner_state=optax.EmptyState())
    jax_tree = {"step": leaf, "b": {"k": leaf}, "n": {3: leaf},
                "opt_state": (optax.EmptyState(), masked,
                              (optax.TraceState(trace={"w": leaf}),
                               optax.ScaleByScheduleState(count=leaf))),
                "l": [leaf, None, (leaf,)]}
    port_tree = {"step": leaf, "b": {"k": leaf}, "n": {3: leaf},
                 "opt_state": (checkpoint.EmptyState(),
                               checkpoint.EmptyState(),
                               (checkpoint.TraceState(trace={"w": leaf}),
                                checkpoint.ScaleByScheduleState(count=leaf))),
                 "l": [leaf, None, (leaf,)]}
    flat, _ = jax.tree_util.tree_flatten_with_path(jax_tree)
    want = sorted(jax.tree_util.keystr(p) for p, _ in flat)
    assert sorted(k for k, _ in keystr_items(port_tree)) == want
    assert "['opt_state'][2][0].trace['w']" in want


def _mlp_trainer(ema=0.0, seed=0):
    """The port's MNIST MLP (hidden 32) with momentum SGD and the fused
    loss on the CPU."""
    model = torch_parity.port_image_model("mlp")
    convert.load_image_model(model, convert.init_flax_layout_image(
        model, seed))
    trainer = Trainer(model.train(), xent.mean_cross_entropy_loss,
                      Sgd(0.1, momentum=0.9), ema_decay=ema)
    return trainer, trainer.init_state()


def _resnet_trainer(ema=0.0, seed=0):
    model = torch_parity.port_image_model("resnet18")
    convert.load_image_model(model, convert.init_flax_layout_image(
        model, seed))
    trainer = Trainer(model.train(), xent.mean_cross_entropy_loss,
                      Sgd(0.1, momentum=0.9), ema_decay=ema)
    return trainer, trainer.init_state()


def _batches(shape, n):
    loader = SyntheticLoader(4, shape, 10, device="cpu")
    return [next(loader) for _ in range(n)]


def _state_tensors(state):
    """{name: tensor} of everything a checkpoint carries."""
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        out[f"momentum.{name}"] = state.optimizer.state[p][
            "momentum_buffer"]
    for name, v in (state.ema or {}).items():
        out[f"ema.{name}"] = v
    return out


@pytest.mark.parametrize("kind", ["mlp", "resnet18"])
def test_state_round_trip_is_exact(kind, tmp_path):
    """A save and a restore into a fresh state (other weights, an
    optimizer that has not stepped) carry every parameter, BN statistic,
    momentum trace, the EMA shadow and the step exactly."""
    make = _mlp_trainer if kind == "mlp" else _resnet_trainer
    shape = (28, 28, 1) if kind == "mlp" else (33, 33, 3)
    trainer, state = make(ema=0.9)
    for batch in _batches(shape, 2):
        state, _ = trainer.train_step(state, batch)
    mgr = CheckpointManager(tmp_path)
    mgr.save(state_payload(state), step=state.step, blocking=True)
    fresh_trainer, fresh = make(ema=0.9, seed=5)
    assert not fresh.optimizer.state
    fresh = restore_state(mgr, fresh)
    assert fresh.step == state.step == 2
    want, got = _state_tensors(state), _state_tensors(fresh)
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_resume_continues_bitwise(tmp_path):
    """Restored at step 2 into a fresh optimizer, the third step gives
    what the uninterrupted third step gives: optax's trace update from
    the restored trace."""
    shape = (28, 28, 1)
    batches = _batches(shape, 3)
    trainer, state = _mlp_trainer()
    mgr = CheckpointManager(tmp_path)
    for i, batch in enumerate(batches):
        state, _ = trainer.train_step(state, batch)
        if i == 1:
            mgr.save(state_payload(state), step=state.step, blocking=True)
    other, fresh = _mlp_trainer(seed=7)
    fresh = restore_state(mgr, fresh)
    fresh, _ = other.train_step(fresh, batches[2])
    want, got = _state_tensors(state), _state_tensors(fresh)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_async_save_archives_its_own_step(tmp_path):
    """The snapshot copies: an async save at step 1, then two in-place
    steps before the write runs, archives the values of step 1 (a
    snapshot that aliased the live CPU tensors would archive step
    3's)."""
    trainer, state = _mlp_trainer(ema=0.9)
    batches = _batches((28, 28, 1), 3)
    state, _ = trainer.train_step(state, batches[0])
    payload = state_payload(state)
    copy = {k: np.array(checkpoint._host_copy(v))
            for k, v in keystr_items(payload)}
    mgr = CheckpointManager(tmp_path)
    gate = threading.Event()
    write = mgr._write

    def gated(*args):
        gate.wait(30)
        return write(*args)

    mgr._write = gated
    mgr.save(payload, step=1)
    for batch in batches[1:]:
        state, _ = trainer.train_step(state, batch)
    gate.set()
    mgr.wait_until_finished()
    raw = torch_drivers.archive(tmp_path / "checkpoint_1")
    assert sorted(raw) == sorted(copy)
    for key in copy:
        np.testing.assert_array_equal(raw[key], copy[key], err_msg=key)
    live = {k: checkpoint._host_copy(v)
            for k, v in keystr_items(state_payload(state))}
    moved = [k for k in copy if not np.array_equal(live[k], copy[k])]
    assert any(k.startswith("['params']") for k in moved)
    assert any(".trace" in k for k in moved)


def test_checkpoint_async_retention_and_listing(tmp_path):
    """Async saves land after wait_until_finished; keep=2 prunes;
    unfinished dirs (tmp siblings, meta-less) never count."""
    trainer, state = _mlp_trainer()
    mgr = CheckpointManager(tmp_path, keep=2)
    for batch in _batches((28, 28, 1), 4):
        state, _ = trainer.train_step(state, batch)
        mgr.save(state_payload(state), step=state.step)
    mgr.wait_until_finished()
    assert mgr.steps() == [3, 4]
    (tmp_path / "checkpoint_9.tmp-1-0").mkdir()
    (tmp_path / "checkpoint_7").mkdir()  # no meta.json
    assert [s for s, _ in list_checkpoints(tmp_path)] == [3, 4]
    assert mgr.latest_step() == 4
    # The blocking snapshot was timed into the manager's report.
    assert mgr.last_blocked_s > 0
    meta = mgr.manifest()
    assert meta["step"] == 4 and meta["bytes"] > 0
    assert any("['params']" in k for k in meta["keys"])
    # The JAX manager lists and reads the port's directory the same.
    theirs = JaxCheckpointManager(tmp_path)
    assert theirs.steps() == [3, 4]
    assert theirs.manifest()["keys"] == meta["keys"]


def test_checkpoint_background_failure_surfaces(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save({"x": torch.ones(2)}, step=1)
    mgr.wait_until_finished()

    def boom(arrays, meta, path):
        raise OSError("disk gone")

    mgr._write = boom
    mgr.save({"x": torch.ones(2)}, step=2)
    with pytest.raises(CheckpointError, match="disk gone"):
        mgr.wait_until_finished()


def test_checkpoint_save_after_close_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save({"x": torch.ones(2)}, step=1)
    mgr.close()
    assert mgr.latest_step() == 1
    with pytest.raises(CheckpointError, match="closed"):
        mgr.save({"x": torch.ones(2)}, step=2)
    assert mgr.latest_step() == 1


def test_checkpoint_partial_and_missing_leaves(tmp_path):
    mgr = CheckpointManager(tmp_path)
    payload = {"params": {"w": torch.arange(4.0)},
               "opt_state": {"m": np.zeros((4,))}, "step": 3}
    mgr.save(payload, step=3, blocking=True)
    got = mgr.restore({"params": {"w": np.zeros((4,))}})
    np.testing.assert_array_equal(got["params"]["w"], np.arange(4.0))
    with pytest.raises(KeyError, match="no leaf"):
        mgr.restore({"params": {"nope": np.zeros(1)}})
    got = mgr.restore({"params": {"nope": np.ones(1)}},
                      missing="template")
    np.testing.assert_array_equal(got["params"]["nope"], [1.0])
    # The JAX manager restores the same partial template.
    theirs = JaxCheckpointManager(tmp_path).restore(
        {"params": {"w": jax.numpy.zeros((4,))}, "step": 0})
    np.testing.assert_array_equal(theirs["params"]["w"], np.arange(4.0))
    assert int(theirs["step"]) == 3


def test_restore_state_reseeds_ema_from_pre_ema_checkpoint(tmp_path):
    trainer, state = _mlp_trainer()
    state, _ = trainer.train_step(state, _batches((28, 28, 1), 1)[0])
    mgr = CheckpointManager(tmp_path)
    mgr.save(state_payload(state), step=1, blocking=True)
    assert not mgr.has_leaf("['ema_params']")
    _, template = _mlp_trainer(ema=0.9, seed=3)
    restored = restore_state(mgr, template)
    for name, param in restored.model.named_parameters():
        assert torch.equal(restored.ema[name], param), name
        assert torch.equal(param, state.model.get_parameter(name)), name


def _driver(argv, tmp_path, *extra):
    return port_train.main(
        ["--device", "cpu", "--model", "mnist", "--warmup-steps", "0",
         "--batch-size", "16", "--model-dir", str(tmp_path), *argv, *extra])


def test_train_driver_checkpoint_resume(tmp_path):
    """tests/test_parallel.py:188 through the port's driver: the second
    run resumes from step 3 and checkpoints at step 6."""
    result = _driver(["--steps", "3"], tmp_path)
    assert result["final_loss"] is not None
    assert any(n.startswith("checkpoint_") for n in os.listdir(tmp_path))
    _driver(["--steps", "3"], tmp_path)
    assert "checkpoint_6" in os.listdir(tmp_path)
    assert CheckpointManager(tmp_path).restore({"step": 0})["step"] == 6


def test_train_driver_async_periodic_checkpoints(tmp_path):
    """tests/test_parallel.py:285: every periodic async checkpoint is
    written and readable when main() returns, read from the archive
    files directly."""
    import json

    _driver(["--steps", "3", "--checkpoint-every", "1"], tmp_path)
    names = sorted(n for n in os.listdir(tmp_path)
                   if n.startswith("checkpoint_"))
    assert names == ["checkpoint_1", "checkpoint_2", "checkpoint_3"]
    for name in names:
        meta = json.loads((tmp_path / name / "meta.json").read_text())
        assert meta["step"] == int(name.rsplit("_", 1)[1])
        with np.load(tmp_path / name / "arrays.npz") as arc:
            assert int(arc["['step']"]) == meta["step"]
            assert meta["leaf_count"] == len(arc.files)
            assert any("['params']" in k for k in arc.files)
            assert any("['opt_state']" in k for k in arc.files)


def test_train_driver_checkpoint_retention(tmp_path):
    """tests/test_parallel.py:314: --keep-checkpoints prunes; in-flight
    and meta-less directories are ignored by listing."""
    result = _driver(["--steps", "4", "--checkpoint-every", "1",
                      "--keep-checkpoints", "2"], tmp_path)
    names = sorted(n for n in os.listdir(tmp_path)
                   if n.startswith("checkpoint_"))
    assert names == ["checkpoint_3", "checkpoint_4"]
    assert len(result["checkpoint_block_s"]) == 5  # 4 periodic + final
    (tmp_path / "checkpoint_9.tmp-123-0").mkdir()
    (tmp_path / "checkpoint_8").mkdir()  # no meta.json: unfinished
    assert list_checkpoints(str(tmp_path)) == [
        (3, "checkpoint_3"), (4, "checkpoint_4")]


def test_driver_warns_about_foreign_entries_as_jax_does(tmp_path, capsys):
    (tmp_path / "checkpoint_5").mkdir()  # another format's directory
    _driver(["--steps", "1"], tmp_path)
    err = capsys.readouterr().err
    torch_drivers.demo_train()._warn_foreign_checkpoints(str(tmp_path))
    want = capsys.readouterr().err
    assert want.startswith("WARNING: ") and want in err
    assert "checkpoint_1" in os.listdir(tmp_path)


def test_driver_gs_dir_warns_and_skips(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = port_train.main(
        ["--device", "cpu", "--model", "mnist", "--warmup-steps", "0",
         "--batch-size", "16", "--steps", "1", "--model-dir",
         "gs://bucket/run"])
    assert "skipping checkpointing" in capsys.readouterr().err
    assert "checkpoint_block_s" not in result
    assert os.listdir(tmp_path) == []


def test_chip_smoke_registers_the_checkpoint_phase(tmp_path):
    """Phase 14 is driven from main; its paths must launch the
    cross-entropy (real-data ResNet), every training kernel (the LM
    that writes the checkpoint) and #1 (dense serving from it); its raw
    archive reader gives the manager's tree."""
    import importlib.util
    import inspect

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(torch_drivers.REPO_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.PATH_KERNELS["ckpt_resnet"] == ("xent_fwd", "xent_bwd")
    assert cs.PATH_KERNELS["ckpt_dense_serving"] == ("flash_fwd",)
    assert len(cs.PATH_KERNELS["ckpt_lm_training"]) == 5
    assert "drive_checkpoints(" in inspect.getsource(cs.main)
    trainer, state = _resnet_trainer()
    mgr = CheckpointManager(tmp_path)
    mgr.save(state_payload(state), step=0, blocking=True)
    arrays = cs.archive_arrays(np, str(tmp_path / "checkpoint_0"))
    for collection in ("params", "batch_stats"):
        got = torch_drivers.flat(cs.archive_tree(arrays,
                                                 f"['{collection}']"))
        want = torch_drivers.flat(convert.image_variables_to_flax(
            state.model)[collection])
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])

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

"""The port's training driver as two processes started through the
plugin's env contract (TPU_WORKER_HOSTNAMES, TPU_WORKER_ID,
CEA_COORDINATOR_PORT on localhost; gloo on the CPU), as
tests/test_multihost.py boots the JAX package's: one checkpoint
writer (rank 0), a resume under another mesh (dp=2, then 1 x 2 tensor
parallel, as tests/test_parallel.py:427-444 resumes the demo driver),
and losses equal to the one-process run's. The MNIST MLP computes in
bf16, so two processes' halves of the batch round their products
apart from one process's whole batch: losses to rtol 2e-3; the
checkpoints in relative L2 norm over all their leaves, the parameters
to 2e-3 and the momentum traces (the last bf16 gradients) to 5e-2
(a CPU run measured 7.5e-4 and 2.0e-2 after the tensor-parallel
resume, 4.5e-5 and 1.4e-3 after the data-parallel run). The f32
trainers are held far tighter in test_torch_parallel.py."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.parallel.distributed import (
    free_local_port,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--model", "mnist", "--batch-size", "16",
        "--steps", "3", "--warmup-steps", "0", "--seed", "3"]


def _two_processes(model_dir, *extra):
    """Run the driver as workers 0 and 1 of a two-host slice; returns
    [(JSON result, stderr)] in rank order."""
    port = free_local_port()
    procs = []
    for wid in (0, 1):
        env = dict(os.environ, TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                   TPU_WORKER_ID=str(wid), CEA_COORDINATOR_PORT=str(port),
                   OMP_NUM_THREADS="2", PYTHONPATH=REPO_ROOT)
        env.pop("CEA_COORDINATOR_ADDRESS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "container_engine_accelerators_tpu_torch"
             ".train", *ARGS, "--model-dir", str(model_dir), *extra],
            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=240))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = []
    for proc, (stdout, stderr) in zip(procs, outputs):
        assert proc.returncode == 0, stderr[-3000:]
        out.append((json.loads(stdout.strip().splitlines()[-1]), stderr))
    return out


def _one_process(model_dir, *extra, monkeypatch):
    for name in ("TPU_WORKER_HOSTNAMES", "TPU_WORKER_ID"):
        monkeypatch.delenv(name, raising=False)
    return port_train.main([*ARGS, "--model-dir", str(model_dir), *extra])


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as arc:
        return {k: arc[k] for k in arc.files}


def _assert_archives_close(got_dir, want_dir):
    got, want = _arrays(got_dir), _arrays(want_dir)
    assert set(got) == set(want)
    for part, tol in (("params", 2e-3), ("opt_state", 5e-2)):
        keys = sorted(k for k in want if k.startswith(f"['{part}']"))
        a = np.concatenate([got[k].reshape(-1) for k in keys])
        b = np.concatenate([want[k].reshape(-1) for k in keys])
        err = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert err <= tol, (part, err)


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """Run A: two processes, a (2, 1) mesh, three steps, checkpoints."""
    model_dir = tmp_path_factory.mktemp("two_proc")
    return model_dir, _two_processes(model_dir, "--model-parallelism", "1",
                                     "--checkpoint-every", "1")


def test_two_processes_train_as_one(first_run, tmp_path, monkeypatch):
    model_dir, ranks = first_run
    one = _one_process(tmp_path, monkeypatch=monkeypatch)
    for result, _ in ranks:
        assert result["devices"] == 2
        assert result["mesh"] == {"data": 2, "model": 1}
        np.testing.assert_allclose(result["final_loss"], one["final_loss"],
                                   rtol=2e-3)
    assert ranks[0][0]["final_loss"] == ranks[1][0]["final_loss"]
    _assert_archives_close(os.path.join(model_dir, "checkpoint_3"),
                           os.path.join(tmp_path, "checkpoint_3"))


def test_one_writer(first_run):
    """Rank 0 saved every checkpoint; rank 1 wrote none (its saves are
    no-ops) and the directory holds only finished checkpoints."""
    model_dir, ranks = first_run
    assert ranks[0][1].count("saving checkpoint") == 4
    assert "saving checkpoint" not in ranks[1][1]
    assert ranks[0][0]["checkpoint_block_s"][0] is not None
    assert ranks[1][0]["checkpoint_block_s"] == [None] * 4
    assert sorted(os.listdir(model_dir)) == [
        "checkpoint_1", "checkpoint_2", "checkpoint_3"]


def test_resume_under_another_mesh(first_run, tmp_path, monkeypatch):
    """Run B resumes A's checkpoint_3 under a (1, 2) mesh (the MLP's
    512-wide kernels column-sharded over "model") and writes
    checkpoint_6; one process resuming a copy of the same checkpoint
    reaches the same loss and the same leaves."""
    model_dir, _ = first_run
    copy = tmp_path / "copy"
    shutil.copytree(model_dir, copy)
    ranks = _two_processes(model_dir, "--model-parallelism", "2")
    for result, stderr in ranks:
        assert "restored checkpoint step 3" in stderr
        assert result["mesh"] == {"data": 1, "model": 2}
    assert "checkpoint_6" in os.listdir(model_dir)
    one = _one_process(copy, monkeypatch=monkeypatch)
    np.testing.assert_allclose(ranks[0][0]["final_loss"], one["final_loss"],
                               rtol=2e-3)
    _assert_archives_close(os.path.join(model_dir, "checkpoint_6"),
                           os.path.join(copy, "checkpoint_6"))

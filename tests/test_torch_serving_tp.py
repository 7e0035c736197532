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

"""Tensor-parallel serving (serve.py --tensor-parallel, serving/
lockstep.py) on the CPU: tests/test_serving.py's
test_generate_tensor_parallel_params on four gloo ranks (vocab 512, E
512, so the wide kernels do shard over "model"), the greedy sequences
of rank 0's server equal to JAX decode's on the same converted weights
on both pools, with int8 weights and for the MoE family; then the
launcher with --device cpu --tensor-parallel 2 as processes: HTTP from
rank 0, SIGTERM draining every rank, and a SIGKILL'd follower failing
rank 0 within 60 s."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import MoETransformerLM
from container_engine_accelerators_tpu.models import TransformerLM
from container_engine_accelerators_tpu.models.decode import decode
from container_engine_accelerators_tpu.models.quantized import (
    convert_params_int8,
)
from container_engine_accelerators_tpu_torch.models import convert
from container_engine_accelerators_tpu_torch.models.decode import (
    greedy_decode,
)
from tests import torch_dist_cases as cases
from tests.torch_dist_pool import RankPool

N = 4
CONFIG = dict(vocab_size=512, embed_dim=512, num_layers=2, num_heads=4,
              max_seq_len=32)
PROMPTS = [[1, 2, 3, 4], [7, 300, 11], [5] * 9]
NEW = 6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(N)
    yield p
    p.close()


def _jax_decode(model, params, prompts, new):
    return [np.asarray(decode(model, params, jnp.asarray([p], jnp.int32),
                              new))[0, :len(p) + new].tolist()
            for p in prompts]


@pytest.mark.parametrize("case", ["paged", "dense", "int8", "moe",
                                  "drill"])
def test_generate_tensor_parallel_params(pool, case):
    """Rank 0's GenerationServer on a 1 x 4 mesh, its engine's calls
    replayed on ranks 1-3: the embedding, the output projections, both
    MLP kernels and the lm_head hold a quarter of their out-features a
    rank, and every greedy sequence equals JAX decode's on the same
    weights (f32): the paged pool (the default), the dense pool,
    weights quantized to int8 (the JAX tree's kernel_q/scale layout),
    and the MoE family (4 experts, ample capacity: routing is per token;
    its expert kernels, model-sharded by the rule, gathered at use).
    The drill installs one fault plan on every rank (the third decode
    step raises): rank 0 quarantines, rebuilds every rank's engine and
    replays, and the sequences still equal JAX's."""
    config = dict(CONFIG)
    if case == "moe":
        config.update(num_experts=4, capacity_factor=4.0)
        jax_model = MoETransformerLM(dtype=jnp.float32, **config)
    else:
        jax_model = TransformerLM(dtype=jnp.float32, **config)
    params = jax_model.init(jax.random.PRNGKey(1),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.tree_util.tree_map(np.asarray, params)
    weights = "native"
    if case == "int8":
        weights = "int8"
        jax_model = jax_model.clone(weights="int8")
        template = jax_model.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))["params"]
        params = convert_params_int8(template, params)
    want = _jax_decode(jax_model, params, PROMPTS, NEW)
    out = pool.run(cases.serve_tp, config, tree, PROMPTS, NEW,
                   paged=case != "dense", weights=weights,
                   fault_plan={"step": [2]} if case == "drill" else None)
    got = out[0]
    assert got["rebuilds"] == (1 if case == "drill" else 0)
    assert got["paged"] == (case != "dense")
    assert got["sequences"] == want
    sharded = set(got["sharded"])
    for name in ("tok_embed.weight", "blocks.0.attn.proj.weight",
                 "blocks.0.mlp_in.weight", "lm_head.weight"):
        assert name in sharded, name
    assert "blocks.0.attn.qkv.weight" not in sharded
    if case == "int8":
        # The int8 kernel is sharded; its scale stays whole, as the JAX
        # rule lays out a 1-D leaf, and is sliced with it at use.
        assert "blocks.0.mlp_in.scale" not in sharded
    if case == "moe":
        assert "blocks.1.moe.w_in" in sharded


# -- the launcher as processes ------------------------------------------------

FLAGS = ["--model=transformer", "--device=cpu", "--vocab-size=512",
         "--embed-dim=512", "--num-layers=2", "--num-heads=4",
         "--max-seq-len=32", "--max-new-tokens=8", "--max-batch=4",
         "--seed=3"]


def _children(pid):
    """The pids whose parent is ``pid``."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(entry))
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _tp_launcher(tmp_path, flags, env=None):
    """A serve.py --tensor-parallel 2 process (rank 0) on a free port
    with ``flags``, once /healthz answers 200; yields (process, port,
    follower pid). Killed at the end whatever happens."""
    from container_engine_accelerators_tpu_torch.parallel.distributed \
        import free_local_port

    port = free_local_port()
    log = open(tmp_path / "launcher.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.serving.serve"] + flags
        + ["--tensor-parallel=2", f"--port={port}"], cwd=REPO, stdout=log,
        stderr=subprocess.STDOUT,
        env=dict(os.environ, OMP_NUM_THREADS="1", **(env or {})))
    followers = []
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert proc.poll() is None, (tmp_path / "launcher.log").read_text()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=2):
                    break
            except OSError:
                time.sleep(0.2)
        followers = _children(proc.pid)
        assert len(followers) == 1, followers
        yield proc, port, followers[0]
    finally:
        for pid in [proc.pid] + followers:
            if _alive(pid):
                os.kill(pid, signal.SIGKILL)
        proc.wait()
        log.close()


@pytest.fixture
def launcher(tmp_path):
    yield from _tp_launcher(tmp_path, FLAGS)


def _generate(port, prompt, new):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/transformer:generate",
        data=json.dumps({"prompts": [prompt],
                         "max_new_tokens": new}).encode())
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["sequences"][0]


def test_launcher_tensor_parallel_serves_and_drains(launcher):
    """--device cpu --tensor-parallel 2: rank 0 answers HTTP with the
    greedy sequence of the same weights on one process
    (greedy_decode on the seed's model), and SIGTERM drains it: rank 0
    exits 0 and its follower ends with it."""
    proc, port, follower = launcher
    config = dict(vocab_size=512, embed_dim=512, num_layers=2, num_heads=4,
                  max_seq_len=32, pos_embedding="learned")
    model = convert.load_lm(config, convert.init_flax_layout_params(
        config, 3), device="cpu")
    for prompt in ([1, 2, 3], [9] * 12):
        want = greedy_decode(model, torch.tensor([prompt]), 5)[0].tolist()
        assert _generate(port, prompt, 5) == want
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 0
    deadline = time.monotonic() + 30
    while _alive(follower) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(follower)


def test_dead_follower_fails_rank_zero(launcher):
    """A SIGKILL'd follower makes rank 0 exit non-zero within 60 s
    (it never hangs on the dead peer)."""
    proc, port, follower = launcher
    assert _generate(port, [1, 2, 3], 2)[:3] == [1, 2, 3]
    os.kill(follower, signal.SIGKILL)
    t0 = time.monotonic()
    code = proc.wait(timeout=60)
    assert code != 0 and time.monotonic() - t0 < 60


@pytest.mark.parametrize("extra,env", [
    (["--speculative-k=4", "--attention-window=16", "--warm",
      "--system-prefix-ids=" + ",".join(map(str, range(3, 23)))], {}),
    (["--quantize-weights=int8", "--speculative-k=4"],
     {"CEA_TPU_PAGED_KV": "0", "CEA_TPU_KV_QUANT": "int4"})],
    ids=["spec-window-prefix-warm", "dense-int8-int4kv-spec"])
def test_launcher_tensor_parallel_composes(tmp_path, extra, env,
                                           monkeypatch):
    """What the JAX launcher composes with --tensor-parallel composes
    here: speculation (the E 128 draft replicated on each rank), the
    window, a pinned system prefix and warm-up on the paged pool; int8
    weights, int4 KV and speculation on the dense pool. Rank 0's greedy
    sequences and a stream equal the same flags' server without a group
    (bf16, one process), and SIGTERM exits 0."""
    from container_engine_accelerators_tpu_torch.serving import serve

    flags = FLAGS[:-1] + ["--max-seq-len=96"] + extra
    prompts = ([1, 2, 3], [9] * 12, [40, 41])
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    srv = serve.build_server(serve.parse_args(
        flags + ["--port=0", "--seed=0"]))
    srv.start()
    try:
        deadline = time.monotonic() + 120
        while not srv.ready and time.monotonic() < deadline:
            time.sleep(0.1)
        want = [_generate(srv.port, p, 6) for p in prompts]
    finally:
        srv.stop()
    for proc, port, _ in _tp_launcher(tmp_path, flags + ["--seed=0"], env):
        assert [_generate(port, p, 6) for p in prompts] == want
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/transformer:generate",
            data=json.dumps({"prompts": [list(prompts[0])],
                             "max_new_tokens": 6, "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            lines = [json.loads(ln) for ln in resp.read().splitlines()
                     if ln.strip()]
        streamed = [t for ln in lines for t in ln.get("tokens", [])]
        assert streamed == want[0][3:], lines
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0

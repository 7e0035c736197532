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

"""Serving trained weights: the port's launcher with ``--model-dir``
and ``--draft-model-dir`` against the demo launcher (the counterpart of
tests/test_serving.py's round trip, at tiny sizes).

The demo driver trains a tiny LM (rope, GQA), a tiny MoE, a tiny draft
(E 16, MHA) and a ResNet-18 of width 8 for 2 steps each. The port's
``load_checkpoint_variables`` and the demo launcher's restore the same
trees exactly. The port's launcher (f32 compute, tests/torch_drivers.py)
serves greedy tokens identical to a JAX ``GenerationServer`` built from
the demo launcher's restore, on the paged and the dense pool, with int8
weights (restored, then quantized, on both sides) and with the trained
draft at k 4; its ResNet predict server gives the classes of JAX's
``InferenceServer`` (scores within 1e-5). A directory with no finished
checkpoint, empty or holding another format's entries, keeps the
initialized weights with the demo launcher's message.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models.moe import MoETransformerLM
from container_engine_accelerators_tpu.models.quantized import (
    convert_params_int8,
)
from container_engine_accelerators_tpu.models.resnet import (
    make_apply_fn,
    resnet as jax_resnet,
)
from container_engine_accelerators_tpu.models.transformer import (
    TransformerLM,
)
from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu_torch.models import convert, decode
from container_engine_accelerators_tpu_torch.serving import serve
from tests import torch_drivers
from tests.torch_drivers import LM_FLAGS, RESNET_FLAGS

TRAIN = ["--batch-size", "8", "--warmup-steps", "0", "--steps", "2"]
LM = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
          num_kv_heads=2, pos_embedding="rope", max_seq_len=48)
DRAFT = dict(vocab_size=64, embed_dim=16, num_layers=2, num_heads=4,
             pos_embedding="rope", max_seq_len=48)
DRAFT_FLAGS = ["--vocab-size", "64", "--embed-dim", "16", "--num-layers",
               "2", "--num-heads", "4", "--pos-embedding", "rope",
               "--seq-len", "16"]
SERVE = ["--model", "transformer", "--model-name", "lm", "--vocab-size",
         "64", "--embed-dim", "32", "--num-layers", "2", "--num-heads", "4",
         "--num-kv-heads", "2", "--pos-embedding", "rope", "--max-seq-len",
         "48", "--max-new-tokens", "8", "--max-batch", "2", "--port", "0",
         "--device", "cpu"]
PROMPTS = [[5, 9, 1, 33, 2], [7] * 12, [3, 60, 41, 8, 8, 19, 22, 50, 2]]
SIZE = 33


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{kind: checkpoint directory} written by the demo driver."""
    root = tmp_path_factory.mktemp("served")
    runs = {"lm": ["--model", "transformer", *LM_FLAGS],
            "moe": ["--model", "moe", "--num-experts", "4", *LM_FLAGS],
            "draft": ["--model", "transformer", *DRAFT_FLAGS],
            "resnet": RESNET_FLAGS}
    out = {}
    with torch_drivers.f32_models():
        for kind, flags in runs.items():
            out[kind] = str(root / kind)
            torch_drivers.demo_train().main(flags + TRAIN + [
                "--model-dir", out[kind]])
    return out


def _flax_init(model, shape):
    """flax's own init of ``model`` (numpy leaves): images NHWC f32 for
    ResNet, token ids for an LM."""
    key = jax.random.PRNGKey(0)
    if len(shape) == 4:
        variables = model.init(key, jnp.zeros(shape, jnp.float32),
                               train=False)
    else:
        variables = model.init(key, jnp.zeros(shape, jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables)


@functools.lru_cache(maxsize=None)
def _jax_restored(kind, directory):
    """The demo launcher's restore of ``directory`` (numpy trees) and
    the flax model it serves."""
    if kind == "resnet":
        model = jax_resnet(depth=18, num_classes=10, dtype=jnp.float32,
                           width=8)
        init = dict(_flax_init(model, (1, SIZE, SIZE, 3)))
    else:
        if kind == "moe":
            model = MoETransformerLM(num_experts=4, dtype=jnp.float32, **LM)
        else:
            model = TransformerLM(dtype=jnp.float32,
                                  **(DRAFT if kind == "draft" else LM))
        init = {"params": _flax_init(model, (1, 8))["params"]}
    restored = torch_drivers.demo_serve().load_checkpoint_variables(
        directory, init)
    return model, jax.tree_util.tree_map(np.asarray, restored)


def _port_init(kind):
    if kind == "resnet":
        with torch_drivers.f32_models():
            model = serve.resnet(depth=18, device="meta")
        return convert.init_flax_layout_image(model, 0)
    config = dict(DRAFT if kind == "draft" else LM)
    if kind == "moe":
        config["num_experts"] = 4
    return {"params": convert.init_flax_layout_params(config, 0)}


@pytest.mark.parametrize("kind", ["lm", "moe", "draft", "resnet"])
def test_launcher_restores_the_jax_tree(kind, trained, capsys):
    got = serve.load_checkpoint_variables(trained[kind], _port_init(kind))
    mine_says = capsys.readouterr().err
    _, want = _jax_restored(kind, trained[kind])
    theirs_says = capsys.readouterr().err
    assert mine_says == theirs_says
    assert mine_says.startswith("serving weights from ")
    got, want = torch_drivers.flat(got), torch_drivers.flat(want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # The training moved them from any init.
    init = torch_drivers.flat(_port_init(kind))
    assert any(not np.array_equal(init[n], got[n]) for n in got)


def _build(argv, paged):
    prev = os.environ.pop(decode.PAGED_KV_ENV, None)
    os.environ[decode.PAGED_KV_ENV] = "1" if paged else "0"
    try:
        with torch_drivers.f32_models():
            return serve.build_server(serve.parse_args(argv))
    finally:
        os.environ.pop(decode.PAGED_KV_ENV, None)
        if prev is not None:
            os.environ[decode.PAGED_KV_ENV] = prev


def _jax_server(paged, int8=False, draft=None, **kwargs):
    model, tree = _jax_restored("lm", kwargs.pop("directory"))
    params = tree["params"]
    if int8:
        model = model.clone(weights="int8")
        params = convert_params_int8(
            model.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 8), jnp.int32))["params"], params)
    if draft is not None:
        draft_model, draft_tree = _jax_restored("draft", draft)
        kwargs.update(draft_model=draft_model,
                      draft_params=draft_tree["params"])
    prev = os.environ.pop(decode.PAGED_KV_ENV, None)
    os.environ[decode.PAGED_KV_ENV] = "1" if paged else "0"
    try:
        return jax_server.GenerationServer(
            "lm", model, params, port=0, max_new_tokens=8, max_batch=2,
            **kwargs)
    finally:
        os.environ.pop(decode.PAGED_KV_ENV, None)
        if prev is not None:
            os.environ[decode.PAGED_KV_ENV] = prev


def _sequences(srv):
    out = []
    for prompt in PROMPTS:
        code, body = srv._handle_post({"prompts": [prompt],
                                       "max_new_tokens": 6})
        assert code == 200, body
        out.append(body["sequences"][0])
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["native", "int8"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_restored_server_matches_jax(trained, paged, int8):
    """The port's launcher with --model-dir serves the archive's
    weights (restored before int8 quantization) and the JAX server's
    greedy tokens."""
    extra = ["--quantize-weights", "int8"] if int8 else []
    mine = _build(SERVE + ["--model-dir", trained["lm"]] + extra, paged)
    theirs = _jax_server(paged, int8, directory=trained["lm"])
    try:
        assert mine.engine.paged == paged
        config = dict(LM, weights="int8") if int8 else LM
        served = torch_drivers.flat(convert.params_to_flax(
            mine.engine._model, config))
        _, tree = _jax_restored("lm", trained["lm"])
        want = tree["params"]
        if int8:
            want = convert.quantize_lm(LM, want)
        want = torch_drivers.flat(want)
        assert sorted(served) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(served[name], want[name],
                                          err_msg=name)
        mine.start()
        theirs.start()
        assert _sequences(mine) == _sequences(theirs)
    finally:
        mine.stop()
        theirs.stop()


def test_draft_model_dir_matches_jax(trained):
    """--speculative-k 4 with the trained draft: the draft's weights are
    the archive's, the engine proposes, and the tokens are the JAX
    speculative server's."""
    mine = _build(SERVE + ["--model-dir", trained["lm"], "--speculative-k",
                           "4", "--draft-embed-dim", "16",
                           "--draft-model-dir", trained["draft"]], True)
    theirs = _jax_server(True, draft=trained["draft"], speculative_k=4,
                         directory=trained["lm"])
    try:
        draft = torch_drivers.flat(convert.params_to_flax(
            mine.engine._draft_model, DRAFT))
        want = torch_drivers.flat(_jax_restored("draft",
                                                trained["draft"])[1]["params"])
        for name in want:
            np.testing.assert_array_equal(draft[name], want[name],
                                          err_msg=name)
        mine.start()
        theirs.start()
        assert _sequences(mine) == _sequences(theirs)
        assert mine.stats()["spec_steps"] > 0
    finally:
        mine.stop()
        theirs.stop()


@pytest.mark.parametrize("foreign", [False, True], ids=["empty", "foreign"])
def test_dir_without_a_checkpoint_keeps_the_init(tmp_path, capsys, foreign):
    if foreign:
        (tmp_path / "checkpoint_3").mkdir()  # another format's entry
        (tmp_path / "checkpoint_3.tmp-1-0").mkdir()  # in flight: ignored
    init = _port_init("lm")
    got = serve.load_checkpoint_variables(str(tmp_path), init)
    mine_says = capsys.readouterr().err
    assert got is init
    theirs = {"params": {}}
    assert torch_drivers.demo_serve().load_checkpoint_variables(
        str(tmp_path), theirs) is theirs
    assert mine_says == capsys.readouterr().err
    assert ("WARNING: " in mine_says) == foreign
    assert "INITIALIZED" in mine_says or "initialized" in mine_says
    # The launcher serves the seed's weights then.
    s = _build(SERVE + ["--model-dir", str(tmp_path)], True)
    try:
        want = torch_drivers.flat(init["params"])
        served = torch_drivers.flat(convert.params_to_flax(s.engine._model,
                                                           LM))
        for name in want:
            np.testing.assert_array_equal(served[name], want[name])
    finally:
        s.stop()


def test_predict_server_from_checkpoint(trained):
    """The ResNet predict server of the port's launcher with
    --model-dir: BN statistics and weights from the archive, classes of
    JAX's InferenceServer on the demo launcher's restore."""
    mine = _build(["--model", "resnet", "--depth", "18", "--image-size",
                   str(SIZE), "--max-batch", "4", "--port", "0",
                   "--device", "cpu", "--model-dir", trained["resnet"]], True)
    model, variables = _jax_restored("resnet", trained["resnet"])
    theirs = jax_server.InferenceServer(
        "resnet", make_apply_fn(model),
        jax.tree_util.tree_map(jnp.asarray, variables), (SIZE, SIZE, 3),
        port=0, max_batch=4, max_wait_ms=2)
    try:
        served = torch_drivers.flat(convert.image_variables_to_flax(
            mine._model))
        want = torch_drivers.flat(variables)
        assert sorted(served) == sorted(want)
        assert any(k.startswith("batch_stats") for k in want)
        for name in want:
            np.testing.assert_array_equal(served[name], want[name],
                                          err_msg=name)
        mine.start()
        theirs.start()
        images = np.random.default_rng(3).standard_normal(
            (3, SIZE, SIZE, 3)).astype(np.float32)
        code, got = mine._handle_post({"instances": images.tolist()})
        assert code == 200, got
        code, ref = theirs._handle_post({"instances": images.tolist()})
        assert code == 200, ref
        assert ([p["class"] for p in got["predictions"]]
                == [p["class"] for p in ref["predictions"]])
        np.testing.assert_allclose(
            [p["score"] for p in got["predictions"]],
            [p["score"] for p in ref["predictions"]], atol=1e-5)
    finally:
        mine.stop()
        theirs.stop()

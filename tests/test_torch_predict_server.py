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

"""The port's image predict server against the JAX package's
``InferenceServer`` on the same variables: a small f32 ResNet-50 (width
8, 10 classes, 32x32x3; every BN scale, bias and running statistic
spread away from its init) in eval mode. Over HTTP both return the
same classes, and scores within 1e-5; a bad shape gets the same 400, a
full queue 503 with Retry-After, the metadata is the same; the server's
shared contract (/healthz, /readyz, /metrics, /stats, drain) holds;
and the launcher serves ResNet by default, taking
demo/serving/jax-serving.yaml's command line as written."""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
import yaml

from container_engine_accelerators_tpu.models.resnet import make_apply_fn
from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu_torch.models import moe
from container_engine_accelerators_tpu_torch.serving import serve
from container_engine_accelerators_tpu_torch.serving import server
from tests import torch_parity
from tests.conftest import REPO_ROOT

SHAPE = (32, 32, 3)
SCORE_TOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def resnet50():
    return torch_parity.flax_image("resnet50", "f32", seed=3)


@pytest.fixture(scope="module")
def servers(resnet50):
    flax_model, tree, port_model = resnet50
    variables = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    theirs = jax_server.InferenceServer(
        "resnet", make_apply_fn(flax_model), variables, SHAPE,
        port=0, max_batch=4, max_wait_ms=2)
    mine = server.InferenceServer("resnet", port_model, SHAPE, port=0,
                                  max_batch=4, max_wait_ms=2,
                                  host="127.0.0.1")
    theirs.start()
    mine.start()
    yield mine, theirs
    mine.stop()
    theirs.stop()


def _call(port, path, payload=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = None if payload is None else json.dumps(payload).encode()
    try:
        with urllib.request.urlopen(url, data=data, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _predict(srv, instances):
    return _call(srv.port, "/v1/models/resnet:predict",
                 {"instances": instances})


@pytest.mark.parametrize("batch", [1, 4, 6])
def test_predictions_match_the_jax_server(servers, batch):
    """1 instance, a full micro-batch, and 6 (a batch and a padded
    one): the same classes and scores within 1e-5."""
    mine, theirs = servers
    instances = torch_parity.images(batch, batch, SHAPE).tolist()
    code, _, got = _predict(mine, instances)
    assert code == 200
    want = _predict(theirs, instances)[2]
    assert len(got["predictions"]) == batch
    for a, b in zip(got["predictions"], want["predictions"]):
        assert a["class"] == b["class"]
        assert abs(a["score"] - b["score"]) <= SCORE_TOL
        assert 0.0 < a["score"] <= 1.0


def test_predictions_are_the_eval_forward(servers, resnet50):
    """The server's answer is the argmax and top softmax probability of
    the model's eval forward run directly (running BN statistics), for
    concurrent one-instance requests batched together too."""
    mine, _ = servers
    port_model = resnet50[2]
    images = torch_parity.images(7, 4, SHAPE)
    with torch.inference_mode():
        logits = port_model.eval()(torch.from_numpy(images))
    probs = torch.softmax(logits, -1)
    results = [None] * 4

    def client(i):
        results[i] = _predict(mine, [images[i].tolist()])

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for i, (code, _, body) in enumerate(results):
        pred = body["predictions"][0]
        assert code == 200
        assert pred["class"] == int(logits[i].argmax())
        assert abs(pred["score"] - float(probs[i].max())) <= SCORE_TOL


_BAD = [
    {"instances": [np.zeros((32, 32, 1)).tolist()]},
    {"instances": [np.zeros((16, 32, 3)).tolist()]},
    {"instances": [np.zeros(SHAPE).tolist(), [[1.0]]]},
    {"nope": []},
    [],
]


@pytest.mark.parametrize("case", range(len(_BAD)))
def test_bad_requests_get_the_jax_servers_400s(servers, case):
    mine, theirs = servers
    want = theirs._handle_post(_BAD[case]) if isinstance(
        _BAD[case], dict) else None
    got = _call(mine.port, "/v1/models/resnet:predict", _BAD[case])
    assert got[0] == 400
    if want is not None:
        assert (got[0], got[2]) == want


def test_full_queue_sheds_with_retry_after(resnet50):
    """A request that cannot fit the admission budget sheds whole: 503
    with Retry-After, the JAX server's body, and /stats counts it."""
    flax_model, tree, port_model = resnet50
    variables = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    theirs = jax_server.InferenceServer(
        "resnet", make_apply_fn(flax_model), variables, SHAPE,
        port=0, max_batch=2, max_queue=2)
    mine = server.InferenceServer("resnet", port_model, SHAPE, port=0,
                                  max_batch=2, max_queue=2,
                                  host="127.0.0.1")
    mine.start()
    try:
        payload = {"instances": torch_parity.images(1, 3, SHAPE).tolist()}
        assert mine._handle_post(payload) == theirs._handle_post(payload)
        code, headers, body = _predict(mine, payload["instances"])
        assert code == 503 and int(headers["Retry-After"]) >= 1
        assert body == {"error": "server overloaded; retry"}
        assert mine.stats()["shed"] == 2
        assert _predict(mine, payload["instances"][:2])[0] == 200
    finally:
        mine.stop()
        theirs.stop()


def test_metadata_and_the_shared_contract(servers):
    mine, theirs = servers
    code, _, meta = _call(mine.port, "/v1/models/resnet")
    assert code == 200
    assert meta == _call(theirs.port, "/v1/models/resnet")[2]
    assert meta["model_version_status"][0]["metadata"] == {
        "kind": "predict", "input_shape": [32, 32, 3], "max_batch": 4}
    assert _call(mine.port, "/healthz")[2] == {"status": "ok",
                                               "model": "resnet"}
    assert _call(mine.port, "/readyz")[:3:2] == (
        200, {"status": "ready", "model": "resnet"})
    assert _call(mine.port, "/debug/requests")[0] == 404
    _predict(mine, [np.zeros(SHAPE).tolist()])
    with urllib.request.urlopen(
            f"http://127.0.0.1:{mine.port}/metrics", timeout=30) as resp:
        text = resp.read().decode()
    assert 'serving_request_latency_seconds_bucket{le="+Inf",' \
           'model="resnet"}' in text
    stats = mine.stats()
    assert stats["requests"] >= 1 and stats["p50_ms"] is not None
    assert stats["device"] == "cpu"
    assert set(stats) >= {"engine_id", "identity", "requests", "shed",
                          "p50_ms", "p99_ms"}


def test_drain_answers_503_and_readyz_draining(resnet50):
    port_model = resnet50[2]
    srv = server.InferenceServer("resnet", port_model, SHAPE, port=0,
                                 max_batch=2, host="127.0.0.1")
    srv.start()
    try:
        assert srv.drain(grace_s=5) is True
        code, headers, body = _call(srv.port, "/readyz")
        assert code == 503 and body["state"] == "draining"
        assert int(headers["Retry-After"]) >= 1
        assert _call(srv.port, "/healthz")[0] == 200
        code, headers, body = _predict(srv, [np.zeros(SHAPE).tolist()])
        assert code == 503 and "request_id" in body
        assert int(headers["Retry-After"]) >= 1
    finally:
        srv.stop()


def _manifest_command():
    with open(os.path.join(REPO_ROOT, "demo", "serving",
                           "jax-serving.yaml")) as f:
        deployment = next(yaml.safe_load_all(f))
    return deployment["spec"]["template"]["spec"]["containers"][0]["command"]


def test_launcher_serves_resnet_by_default():
    """jax-serving.yaml's command line parses as written into ResNet-50
    at 224x224x3 on the card; cut to depth 18 at 32x32 on the CPU it
    builds the predict server, which answers as the model's eval
    forward."""
    command = _manifest_command()
    assert command[:2] == ["python3", "/demos/serving/serve.py"]
    args = serve.parse_args(command[2:])
    assert (args.model, args.model_name, args.port, args.depth,
            args.image_size, args.device) == (
                "resnet", "resnet", 8500, 50, 224, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            serve.build_server(args)
    small = ["--port=0", "--depth=18", "--image-size=32",
             "--max-batch=2", "--device=cpu"]
    srv = serve.build_server(serve.parse_args(command[2:] + small))
    srv.start()
    try:
        assert isinstance(srv, server.InferenceServer)
        image = torch_parity.images(5, 1, SHAPE)
        code, _, body = _predict(srv, image.tolist())
        assert code == 200
        with torch.inference_mode():
            logits = srv._model(torch.from_numpy(image))
        assert body["predictions"][0]["class"] == int(logits[0].argmax())
        assert srv._model.depth == 18 and not srv._model.training
    finally:
        srv.stop()
    # --model moe is ported: the launcher serves a MoETransformerLM.
    lm = serve.build_server(serve.parse_args([
        "--model", "moe", "--num-experts", "4", "--vocab-size", "64",
        "--embed-dim", "32", "--num-layers", "2", "--num-heads", "4",
        "--max-seq-len", "32", "--max-new-tokens", "4", "--max-batch",
        "2", "--port", "0",
        "--device", "cpu"]))
    try:
        assert isinstance(lm, server.GenerationServer)
        assert isinstance(lm.engine._model, moe.MoETransformerLM)
        assert lm.engine._model.num_experts == 4
    finally:
        lm.stop()


@pytest.mark.parametrize("argv, message", [
    (["--system-prefix", "hi", "--system-prefix-ids", "1,2"],
     "not both"),
    (["--model", "transformer", "--system-prefix-ids", "1,x"],
     "comma-separated integers"),
    (["--model", "transformer", "--system-prefix", "hi"],
     "requires --tokenizer"),
    (["--system-prefix-ids", "1,2"], "apply only to LM models"),
])
def test_launcher_checks_prefix_flags_at_parse_time(argv, message,
                                                    capsys):
    with pytest.raises(SystemExit) as err:
        serve.parse_args(argv)
    assert err.value.code == 2
    assert message in capsys.readouterr().err
    with pytest.raises(SystemExit, match=message):
        serve.build_server(serve.build_parser().parse_args(argv))


def test_inference_server_warms_before_serving(resnet50, monkeypatch):
    """One padded batch runs in the constructor, before any traffic."""
    calls = []
    real = server.InferenceServer.predict

    def spy(self, images):
        calls.append(images.shape)
        return real(self, images)

    monkeypatch.setattr(server.InferenceServer, "predict", spy)
    srv = server.InferenceServer("resnet", resnet50[2], SHAPE, port=0,
                                 max_batch=3, host="127.0.0.1")
    try:
        assert calls == [(3, *SHAPE)]
        assert srv.ready
    finally:
        srv.stop()

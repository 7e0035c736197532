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

"""The port's /stats against the JAX server's, key set for key set, on
the CPU: the generate server on the paged pool, on the dense pool and
with a draft (speculative_k 4), and the predict server. Each pair
serves the same request first.

The only keys allowed to differ: the JAX server's ``plugin_devices``
(present when a device plugin answers) and the port's listed extras.
"""

import json
import urllib.request

import jax
import pytest
import torch

from container_engine_accelerators_tpu.models.resnet import make_apply_fn
from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu_torch.serving import server
from tests import torch_parity

# JAX-only: the device plugin's answer.
JAX_ONLY = {"plugin_devices"}
# Port-only: its device, its flash kernel's launch count, the pool's
# name and the tokens it generated.
PORT_ONLY = {"device", "flash_fwd_launches", "kv_pool",
             "tokens_generated"}
IMAGE_SHAPE = (32, 32, 3)


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _lm(seed, embed=32, layers=2, heads=4):
    return torch_parity.flax_lm_of(seed, vocab_size=64, embed_dim=embed,
                                   num_layers=layers, num_heads=heads,
                                   max_seq_len=48)


def _served_stats(theirs, mine, path, payload):
    """Start both, serve ``payload`` on each, return both /stats."""
    out = []
    for srv in (theirs, mine):
        srv.start()
    try:
        for srv in (theirs, mine):
            _post(srv.port, path, payload)
            out.append(_get(srv.port, "/stats"))
    finally:
        for srv in (theirs, mine):
            srv.stop()
    return out


def _assert_keys_agree(want, got):
    missing = set(want) - set(got) - JAX_ONLY
    extra = set(got) - set(want) - PORT_ONLY
    assert not missing and not extra, (sorted(missing), sorted(extra))


def _generate_pair(paged, draft, monkeypatch):
    monkeypatch.setenv("CEA_TPU_PAGED_KV", "1" if paged else "0")
    model, tree, config = _lm(1)
    port_model = torch_parity.port_lm(config, tree)
    kwargs, port_kwargs = {}, {}
    if draft:
        dmodel, dtree, dconfig = _lm(2, embed=16, layers=1, heads=2)
        kwargs = dict(draft_model=dmodel, draft_params=dtree,
                      speculative_k=4)
        port_kwargs = dict(draft_model=torch_parity.port_lm(dconfig, dtree),
                           speculative_k=4)
    theirs = jax_server.GenerationServer(
        "lm", model, tree, port=0, max_new_tokens=8, max_batch=2,
        buckets=[8], **kwargs)
    mine = server.GenerationServer(
        "lm", port_model, port=0, max_new_tokens=8, max_batch=2,
        buckets=[8], host="127.0.0.1", **port_kwargs)
    return theirs, mine


@pytest.mark.parametrize("paged,draft", [(True, False), (False, False),
                                         (True, True)],
                         ids=["paged", "dense", "paged_draft"])
def test_generate_stats_keys_match_the_jax_server(paged, draft,
                                                  monkeypatch):
    theirs, mine = _generate_pair(paged, draft, monkeypatch)
    want, got = _served_stats(
        theirs, mine, "/v1/models/lm:generate",
        {"prompts": [[1, 2, 3, 4, 5]], "max_new_tokens": 4})
    _assert_keys_agree(want, got)
    assert set(got) - set(want) == PORT_ONLY
    assert got["platform"] == "cpu" and got["devices"] == ["cpu"]
    assert got["kv_pool"] == ("paged" if paged else "dense")


def test_predict_stats_keys_match_the_jax_server():
    flax_model, tree, port_model = torch_parity.flax_image("resnet18")
    variables = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    theirs = jax_server.InferenceServer(
        "resnet", make_apply_fn(flax_model), variables, IMAGE_SHAPE,
        port=0, max_batch=2, max_wait_ms=2)
    mine = server.InferenceServer("resnet", port_model, IMAGE_SHAPE,
                                  port=0, max_batch=2, max_wait_ms=2,
                                  host="127.0.0.1")
    image = torch_parity.images(0, 1, IMAGE_SHAPE)[0]
    want, got = _served_stats(theirs, mine, "/v1/models/resnet:predict",
                              {"instances": [image.tolist()]})
    _assert_keys_agree(want, got)
    assert set(got) - set(want) == {"device"}
    assert got["platform"] == "cpu" and got["devices"] == ["cpu"]


def test_platform_and_devices_are_captured_once():
    """Both come from the device the server was built on, not from a
    later look: /stats serves the values of the construction."""
    _, tree, config = _lm(1)
    mine = server.GenerationServer(
        "lm", torch_parity.port_lm(config, tree), port=0,
        max_new_tokens=8, max_batch=2, buckets=[8], host="127.0.0.1")
    try:
        stats = mine.stats()
        assert (stats["platform"], stats["devices"]) == ("cpu", ["cpu"])
        assert stats["device"] == "cpu"
    finally:
        mine.stop()

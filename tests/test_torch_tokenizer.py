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

"""A local Hugging Face tokenizer in the port, against the JAX
package's ``load_tokenizer``.

The tokenizer directory is built here, offline
(``torch_drivers.hf_tokenizer_dir``): a small byte-level BPE trained
with the ``tokenizers`` package on a few sentences, wrapped in
``transformers.PreTrainedTokenizerFast`` and saved with
``save_pretrained``. Both packages' ``load_tokenizer`` give the same
vocab size, ids and text; a port ``GenerationServer`` with it answers
text requests with the JAX server's bodies (f32); a missing directory
raises what the JAX side raises. The port imports, and serves the byte
codec, without ``transformers``.
"""

import os
import subprocess
import sys

import pytest
import torch

from container_engine_accelerators_tpu.serving import server as jax_server
from container_engine_accelerators_tpu.serving import (
    tokenizer as jax_tokenizer,
)
from container_engine_accelerators_tpu_torch.serving import server
from container_engine_accelerators_tpu_torch.serving import tokenizer
from tests import torch_drivers, torch_parity
from tests.conftest import REPO_ROOT

pytest.importorskip("transformers")

VOCAB = 320  # the model's; the tokenizer's is below it
TEXTS = ["Hello, world", "naïve 東京 ✓", "the quick brown fox", "",
         "a\nb\tc  spaced"]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    return torch_drivers.hf_tokenizer_dir(tmp_path_factory.mktemp("tok"))


def test_local_tokenizer_is_the_jax_one(tok_dir):
    ours = tokenizer.load_tokenizer(tok_dir)
    theirs = jax_tokenizer.load_tokenizer(tok_dir)
    assert isinstance(ours, tokenizer._HFTokenizer)
    assert ours.vocab_size == theirs.vocab_size
    assert 256 < ours.vocab_size <= VOCAB
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == theirs.encode(text)
        assert ours.decode(ids) == theirs.decode(ids) == text
    # Merges: a corpus word takes fewer ids than its bytes.
    assert len(ours.encode("hello world")) < len(b"hello world")
    special = ours.vocab_size - 1
    assert ours.decode([special, 104]) == theirs.decode([special, 104])


def test_missing_directory_raises_as_jax_does(tmp_path):
    for path in (str(tmp_path / "nope"), "/models/llama-tokenizer"):
        with pytest.raises(Exception) as ours:
            tokenizer.load_tokenizer(path)
        with pytest.raises(Exception) as theirs:
            jax_tokenizer.load_tokenizer(path)
        assert type(ours.value) is type(theirs.value)


def test_server_with_the_tokenizer_answers_as_jax(tok_dir):
    model, tree, config = torch_parity.flax_lm("rope_gqa", vocab=VOCAB)
    port = torch_parity.port_lm(config, tree)
    mine = server.GenerationServer(
        "lm", port, port=0, max_new_tokens=8, max_batch=2,
        host="127.0.0.1", tokenizer=tokenizer.load_tokenizer(tok_dir))
    theirs = jax_server.GenerationServer(
        "lm", model, tree, port=0, max_new_tokens=8, max_batch=2,
        tokenizer=jax_tokenizer.load_tokenizer(tok_dir))
    mine.start()
    theirs.start()
    try:
        for payload in ({"text": ["hello world", "the lazy"],
                         "max_new_tokens": 6},
                        {"text": ["naïve café"], "max_new_tokens": 4}):
            got = mine._handle_post(dict(payload))
            assert got[0] == 200, got
            assert got == theirs._handle_post(dict(payload))
    finally:
        mine.stop()
        theirs.stop()


def test_port_imports_and_serves_bytes_without_transformers():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('transformers', 'tokenizers'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import container_engine_accelerators_tpu_torch.serving.serve\n"
        "from container_engine_accelerators_tpu_torch.serving import "
        "tokenizer as t\n"
        "assert t.load_tokenizer('byte').encode('hi') == [104, 105]\n"
        "try:\n"
        "    t.load_tokenizer('/models/tok')\n"
        "except ImportError as e:\n"
        "    print('REFUSED', e)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "REFUSED blocked: transformers" in proc.stdout

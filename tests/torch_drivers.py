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

"""Both training drivers and both launchers side by side on the CPU.

The demo driver (demo/tpu-training/train.py) and the demo launcher
(demo/serving/serve.py) are loaded by path. ``f32_models()`` makes both
sides build their models in f32 compute (the drivers' default is bf16)
and ResNet at width 8, by swapping the constructors the drivers and
launchers call; the flags and everything else run as written. The
tolerances of the comparisons are those of tests/test_torch_train.py
and tests/test_torch_image_train.py, which hold the two Trainers to
each other in f32.
"""

import contextlib
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import torch

from container_engine_accelerators_tpu.models.mlp import MnistMLP
from container_engine_accelerators_tpu.models.moe import MoETransformerLM
from container_engine_accelerators_tpu.models.resnet import (
    resnet as jax_resnet,
)
from container_engine_accelerators_tpu.models.transformer import (
    TransformerLM,
)
from container_engine_accelerators_tpu_torch import train as port_train
from container_engine_accelerators_tpu_torch.models import convert, mlp
from container_engine_accelerators_tpu_torch.models.resnet import resnet
from container_engine_accelerators_tpu_torch.serving import serve

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 8

# Tiny LM flags for both drivers (tests/torch_parity.py's TINY, rope
# and GQA); the MoE's layer 1 is its routed one.
LM_FLAGS = ["--vocab-size", "64", "--embed-dim", "32", "--num-layers",
            "2", "--num-heads", "4", "--num-kv-heads", "2",
            "--pos-embedding", "rope", "--seq-len", "16"]
RESNET_FLAGS = ["--model", "resnet", "--depth", "18", "--image-size", "33",
                "--num-classes", "10"]


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO_ROOT, *path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def demo_train():
    """demo/tpu-training/train.py, loaded by path."""
    return _load("_drivers_demo_train", "demo", "tpu-training", "train.py")


@functools.lru_cache(maxsize=None)
def demo_serve():
    """demo/serving/serve.py, loaded by path."""
    return _load("_drivers_demo_serve", "demo", "serving", "serve.py")


@contextlib.contextmanager
def f32_models():
    """Both drivers and the port's launcher build f32-compute models,
    ResNet at width 8 (the launcher's at 10 classes), for the
    duration."""
    demo = demo_train()
    swaps = [
        (demo, "resnet", functools.partial(
            jax_resnet, dtype=jnp.float32, width=WIDTH)),
        (demo, "MnistMLP", functools.partial(MnistMLP, dtype=jnp.float32)),
        (demo, "TransformerLM", functools.partial(TransformerLM,
                                                  dtype=jnp.float32)),
        (demo, "MoETransformerLM", functools.partial(
            MoETransformerLM, dtype=jnp.float32)),
        (port_train, "resnet", functools.partial(
            resnet, dtype=torch.float32, width=WIDTH)),
        (mlp, "MnistMLP", functools.partial(mlp.MnistMLP,
                                            dtype=torch.float32)),
        (convert, "load_lm", functools.partial(convert.load_lm,
                                               dtype=torch.float32)),
        (serve, "load_lm", functools.partial(serve.load_lm,
                                             dtype=torch.float32)),
        (serve, "resnet", functools.partial(
            resnet, dtype=torch.float32, width=WIDTH, num_classes=10)),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, value in swaps:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def flat(tree, prefix=()):
    """{"a/b/c": f32-or-native numpy leaf} of a nested mapping."""
    out = {}
    for key in sorted(tree):
        if hasattr(tree[key], "keys"):
            out.update(flat(tree[key], prefix + (key,)))
        else:
            out["/".join(prefix + (key,))] = np.asarray(tree[key])
    return out


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def archive(path):
    """{key: array} of a checkpoint directory's arrays.npz."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


TOKENIZER_CORPUS = ["the quick brown fox jumps over the lazy dog",
                    "hello world, hello tokenizer", "serving text in and out",
                    "naïve café 東京 ✓"] * 4


def hf_tokenizer_dir(path):
    """A local Hugging Face tokenizer directory at ``path``, built
    offline: a byte-level BPE of 300 ids (the 256 bytes, merges,
    ``<eos>``) trained with ``tokenizers`` on a few sentences, saved
    through ``transformers.PreTrainedTokenizerFast.save_pretrained``.
    Returns the path."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers import trainers
    from transformers import PreTrainedTokenizerFast

    bpe = Tokenizer(models.BPE())
    bpe.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    bpe.decoder = decoders.ByteLevel()
    bpe.train_from_iterator(TOKENIZER_CORPUS, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<eos>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(tokenizer_object=bpe,
                            eos_token="<eos>").save_pretrained(str(path))
    return str(path)

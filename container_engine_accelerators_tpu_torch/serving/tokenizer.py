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

"""Tokenizers for text-in/text-out serving (the port's own copy of the
JAX package's serving/tokenizer.py).

The serving core works on token ids; tokenization is a host-side codec
in front of it:

- ``ByteTokenizer``: the dependency-free byte-level codec (id = utf-8
  byte, any vocab_size >= 256).
- ``load_tokenizer(spec)``: "byte", or a LOCAL path to a pretrained
  Hugging Face tokenizer directory (``transformers`` is imported only
  then, with ``local_files_only=True``: it never downloads, and the
  package imports without it).
"""


class ByteTokenizer:
    """id = utf-8 byte value (0..255). Lossless for any text."""

    vocab_size = 256

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        # Ids outside the byte range (a model vocab may exceed 256)
        # become U+FFFD rather than silently vanishing.
        out = []
        run = bytearray()
        for i in ids:
            if 0 <= i < 256:
                run.append(i)
            else:
                out.append(run.decode("utf-8", errors="replace"))
                run = bytearray()
                out.append("\ufffd")
        out.append(run.decode("utf-8", errors="replace"))
        return "".join(out)


class _HFTokenizer:
    """Thin adapter over a local pretrained Hugging Face tokenizer."""

    def __init__(self, path):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(
            path, local_files_only=True)
        # len() counts added and special tokens, .vocab_size does not:
        # an added token would then pass the server's model-vocab
        # guard.
        self.vocab_size = int(len(self._tok))

    def encode(self, text):
        return list(self._tok.encode(text, add_special_tokens=False))

    def decode(self, ids):
        return self._tok.decode(list(ids), skip_special_tokens=True)


def load_tokenizer(spec):
    """"byte" -> ByteTokenizer; anything else is a local Hugging Face
    tokenizer directory (a missing one raises what ``transformers``
    raises)."""
    if spec == "byte":
        return ByteTokenizer()
    return _HFTokenizer(spec)

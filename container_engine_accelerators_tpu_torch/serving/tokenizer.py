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
in front of it. ``ByteTokenizer`` is the dependency-free byte-level
codec (id = utf-8 byte, any vocab_size >= 256). A Hugging Face
tokenizer directory is not ported: it loads files from outside the
repository through ``transformers``.
"""

from ..utils import not_ported


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


def load_tokenizer(spec):
    """"byte" -> ByteTokenizer; a Hugging Face tokenizer path raises."""
    if spec == "byte":
        return ByteTokenizer()
    raise not_ported(f"tokenizer {spec!r} (a Hugging Face tokenizer "
                     f"directory)")

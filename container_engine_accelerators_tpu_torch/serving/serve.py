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

"""Launch the PyTorch LM generation server.

    python -m container_engine_accelerators_tpu_torch.serving.serve \
        --device cuda --num-kv-heads 2 --pos-embedding rope \
        --max-new-tokens 128 --port 8500

The ``--model transformer`` flags of demo/serving/serve.py that the
port supports, plus ``--device`` (cuda by default; there is no CPU
fallback) and ``--seed`` for the random weights. Weights are made in
the flax layout from the seed and carried over by models/convert.py;
loading a checkpoint (``--model-dir``) waits for the checkpoint-format
port, as do the int8 KV cache and int8 weights.
"""

import argparse
import signal
import sys
import threading

import torch

from ..models.convert import init_flax_layout_params, load_lm
from .server import GenerationServer


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["transformer"],
                   default="transformer")
    p.add_argument("--model-name", default="")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--embed-dim", type=int, default=512)
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--num-kv-heads", type=int, default=0,
                   help="grouped-query attention: K/V heads (must "
                        "divide --num-heads). 0 = MHA")
    p.add_argument("--pos-embedding", choices=["learned", "rope"],
                   default="learned")
    p.add_argument("--attention-window", type=int, default=0,
                   help="sliding-window attention (not yet ported: "
                        "only 0 is accepted)")
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--kv-cache-dtype", choices=["bfloat16", "int8"],
                   default="bfloat16",
                   help="int8 is not yet ported")
    p.add_argument("--quantize-weights", choices=["native", "int8"],
                   default="native", help="int8 is not yet ported")
    p.add_argument("--model-dir", default="",
                   help="checkpoint restore is not yet ported; empty "
                        "serves random weights made from --seed")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def build_server(args):
    """The GenerationServer the parsed ``args`` describe."""
    if args.model_dir:
        raise SystemExit("--model-dir is not yet ported to the PyTorch "
                         "server; omit it to serve random weights")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    config = dict(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                  num_layers=args.num_layers, num_heads=args.num_heads,
                  num_kv_heads=args.num_kv_heads or None,
                  pos_embedding=args.pos_embedding,
                  max_seq_len=args.max_seq_len)
    model = load_lm(
        dict(config, attention_window=args.attention_window,
             kv_cache_dtype=(None if args.kv_cache_dtype == "bfloat16"
                             else args.kv_cache_dtype),
             weights=args.quantize_weights),
        init_flax_layout_params(config, args.seed), device=args.device)
    return GenerationServer(args.model_name or args.model, model,
                            port=args.port,
                            max_new_tokens=args.max_new_tokens,
                            max_batch=args.max_batch)


def main(argv=None):
    server = build_server(build_parser().parse_args(argv))

    def _shutdown(signum, frame):
        print(f"signal {signum}; stopping", file=sys.stderr)
        threading.Thread(target=server.shutdown,
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    try:
        server.serve_forever()
    finally:
        server.stop()


if __name__ == "__main__":
    main()

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

"""One tiny LM engine for fleet tests: the port's counterpart of
``tools/serve_fleet.py --worker``.

    python -m container_engine_accelerators_tpu_torch.serving.fleet_worker \
        --port-file /tmp/engine0.port --seed 0 --device cpu

Builds the port's GenerationServer ("lm", warmed up) on a tiny
TransformerLM (by default the JAX worker's shape: vocab 48, E 32, 2
layers, 4 heads, max_seq_len 64, 24 new tokens, 4 slots; f32) whose
weights come from ``init_flax_layout_params(config, --seed)``, so a
JAX engine loaded with the same numpy tree serves the same greedy
tokens. ``serving.serve_fleet --spawn`` and ``router_check`` start
their engines with it. Once warm it writes its port to
``--port-file`` (atomically); SIGUSR1 starts a drain (POSTs 503,
/readyz unready), SIGTERM and SIGINT stop it.
"""

import argparse
import os
import signal
import threading

import torch

from .. import obs
from ..models.convert import init_flax_layout_params, load_lm
from .server import GenerationServer


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--port-file", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vocab-size", type=int, default=48)
    p.add_argument("--embed-dim", type=int, default=32)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--max-seq-len", type=int, default=64)
    p.add_argument("--max-new-tokens", type=int, default=24)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-queue", type=int, default=None,
                   help="admission queue bound (default 8 x "
                        "--max-batch; 0 = unbounded)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def config_of(args):
    """The worker's TransformerLM config (flax keyword arguments)."""
    return dict(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                num_layers=args.num_layers, num_heads=args.num_heads,
                max_seq_len=args.max_seq_len)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    obs.set_role("serving")
    config = config_of(args)
    model = load_lm(config, init_flax_layout_params(config, args.seed),
                    device=args.device, dtype=torch.float32)
    srv = GenerationServer("lm", model, port=0,
                           max_new_tokens=args.max_new_tokens,
                           max_batch=args.max_batch,
                           max_queue=args.max_queue, warm=True)
    srv.start()
    stop = threading.Event()
    signal.signal(signal.SIGUSR1, lambda *_: srv.begin_drain())
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(srv.port))
    os.replace(tmp, args.port_file)
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

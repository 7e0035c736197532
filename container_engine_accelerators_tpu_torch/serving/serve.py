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

"""Launch the PyTorch model server.

    python -m container_engine_accelerators_tpu_torch.serving.serve \
        --model-name=resnet --port=8500

    python -m container_engine_accelerators_tpu_torch.serving.serve \
        --model=transformer --model-name=lm --port=8500 \
        --max-seq-len=2048 --max-new-tokens=128 --kv-cache-dtype=int8 \
        --num-kv-heads=2 --pos-embedding=rope --quantize-weights=int8 \
        --tokenizer=byte --warm

The flags of demo/serving/serve.py that the port supports (the lines
above are demo/serving/jax-serving.yaml's and lm-serving.yaml's), plus
``--device`` (cuda by default; there is no CPU fallback) and ``--seed``
for the random weights. ``--model`` defaults to resnet, as in the demo:
the image predict server (``InferenceServer``) on ResNet v1.5 of
``--depth`` (50) at ``--image-size`` (224) x 3, 1000 classes, bf16
compute, in eval mode. ``--model transformer`` serves the LM
(``GenerationServer``); ``--model moe`` is not ported yet. Weights are
made in the flax layout from the seed and carried over by
models/convert.py; ``--quantize-weights=int8`` quantizes the LM's tree
at load, as the demo launcher does. Loading a checkpoint
(``--model-dir``, ``--draft-model-dir``) waits for the checkpoint-format
port, and ``--warm-filters`` is validated and then ignored, as in the
demo.

``--speculative-k N`` serves with a draft model, as the demo does: a
TransformerLM of ``--draft-layers`` layers, ``--draft-embed-dim`` and
``--draft-num-heads`` heads (0: the target's; MHA), the target's vocab,
position embedding and max_seq_len, native weights made from seed
``--seed + 1`` (the target's from ``--seed``). A random draft almost
never agrees with the target: it shows the path, not the speed-up.

``--system-prefix`` (text, needs ``--tokenizer``) or
``--system-prefix-ids`` (comma-separated ids) pins a system prompt in
the paged arena: clients send only their suffix. Both are checked when
the command line is parsed, with the demo's messages.

SIGTERM and SIGINT drain: new POSTs answer 503 with Retry-After and
/readyz turns unready while in-flight requests finish (within
``CEA_TPU_DRAIN_GRACE_S``, 30 s by default), then the server stops and
the process exits 0. SIGUSR1 starts the same drain and keeps the
process up (a fleet router then steers around the replica, as it does
around ``serving.fleet_worker``).
"""

import argparse
import json
import signal
import sys
import threading

import torch

from .. import obs
from ..models import convert
from ..models.convert import init_flax_layout_params, load_lm, quantize_lm
from ..models.resnet import resnet
from .server import GenerationServer, InferenceServer
from .tokenizer import load_tokenizer


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=["resnet", "transformer", "moe"],
                   default="resnet")
    p.add_argument("--model-name", default="")
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--image-size", type=int, default=224)
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
                   help="sliding-window attention width (0 = full "
                        "causal); the engine's slots hold full-length "
                        "band-masked caches")
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--warm", action="store_true",
                   help="warm every bucket up in the background; "
                        "/healthz answers 503 until done")
    p.add_argument("--warm-filters", default="",
                   help="JSON list of sampling-option dicts, accepted "
                        "for the demo launcher's command line and "
                        "ignored (every variant runs the warm rows' "
                        "kernels)")
    p.add_argument("--kv-cache-dtype", choices=["bfloat16", "int8"],
                   default="bfloat16",
                   help="int8 halves KV-cache residency per replica")
    p.add_argument("--tokenizer", default="",
                   help="'byte' serves text in and out (a Hugging Face "
                        "tokenizer path is not yet ported); empty "
                        "serves token ids only")
    p.add_argument("--quantize-weights", choices=["native", "int8"],
                   default="native",
                   help="int8: weight-only quantization of the "
                        "attention and MLP kernels at load time")
    p.add_argument("--model-dir", default="",
                   help="checkpoint restore is not yet ported; empty "
                        "serves random weights made from --seed")
    p.add_argument("--speculative-k", type=int, default=0,
                   help="N > 0: greedy rows without a repetition penalty "
                        "decode speculatively in the engine, a draft "
                        "model proposing N-1 tokens a step (identical "
                        "output); N 1 serves without a draft")
    p.add_argument("--draft-layers", type=int, default=2)
    p.add_argument("--draft-embed-dim", type=int, default=128)
    p.add_argument("--draft-num-heads", type=int, default=0,
                   help="0 = the target's --num-heads (must divide "
                        "--draft-embed-dim)")
    p.add_argument("--draft-model-dir", default="",
                   help="checkpoint restore is not yet ported; empty "
                        "serves a random draft made from --seed + 1")
    p.add_argument("--system-prefix", default="",
                   help="shared system-prompt text, pinned once at "
                        "startup; clients then send only their suffix. "
                        "Requires --tokenizer")
    p.add_argument("--system-prefix-ids", default="",
                   help="shared system prompt as comma-separated token "
                        "ids (mutually exclusive with --system-prefix)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (the draft's: "
                        "seed + 1)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def prefix_args_error(args):
    """The demo launcher's parse-time check of the system-prefix flags:
    None, or the message to refuse the command line with. Sets
    ``args.prefix_ids`` (None, or the parsed id list)."""
    args.prefix_ids = None
    if args.system_prefix and args.system_prefix_ids:
        return "pass --system-prefix or --system-prefix-ids, not both"
    if args.system_prefix_ids:
        try:
            args.prefix_ids = [int(t) for t in
                               args.system_prefix_ids.split(",")]
        except ValueError:
            return ("--system-prefix-ids must be comma-separated "
                    "integers")
    if args.system_prefix and not args.tokenizer:
        return ("--system-prefix is text and requires --tokenizer; "
                "pass ids via --system-prefix-ids")
    if ((args.system_prefix or args.prefix_ids)
            and args.model not in ("transformer", "moe")):
        return ("--system-prefix/--system-prefix-ids apply only to LM "
                "models (--model transformer|moe)")
    return None


def parse_args(argv=None):
    """The command line, with the system-prefix flags checked as the
    demo launcher checks them (argparse's usage error)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    error = prefix_args_error(args)
    if error:
        parser.error(error)
    return args


def build_image_server(args):
    """The InferenceServer ``args`` describe: ResNet v1.5 of
    ``--depth`` on ``--device`` with flax-layout weights made from
    ``--seed``, in eval mode."""
    model = resnet(depth=args.depth, device="meta")
    variables = convert.init_flax_layout_image(model, args.seed)
    model = convert.load_image_model(model.to_empty(device=args.device),
                                     variables)
    return InferenceServer(args.model_name or args.model, model,
                           (args.image_size, args.image_size, 3),
                           port=args.port, max_batch=args.max_batch)


def build_server(args):
    """The server the parsed ``args`` describe."""
    error = prefix_args_error(args)
    if error:
        raise SystemExit(error)
    if args.model == "moe":
        raise SystemExit("--model moe is not yet ported to the PyTorch "
                         "server")
    if args.model_dir:
        raise SystemExit("--model-dir is not yet ported to the PyTorch "
                         "server; omit it to serve random weights")
    if args.draft_model_dir:
        raise SystemExit("--draft-model-dir is not yet ported to the "
                         "PyTorch server; omit it to serve a random "
                         "draft")
    warm_filters = None
    if args.warm_filters:
        warm_filters = json.loads(args.warm_filters)
        # A malformed spec fails startup, not the warm-up thread.
        if (not isinstance(warm_filters, list)
                or not all(isinstance(f, dict) for f in warm_filters)):
            raise SystemExit("--warm-filters must be a JSON list of "
                             f"dicts, got: {args.warm_filters!r}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    if args.model == "resnet":
        return build_image_server(args)
    tokenizer = load_tokenizer(args.tokenizer) if args.tokenizer else None
    config = dict(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                  num_layers=args.num_layers, num_heads=args.num_heads,
                  num_kv_heads=args.num_kv_heads or None,
                  pos_embedding=args.pos_embedding,
                  max_seq_len=args.max_seq_len)
    tree = init_flax_layout_params(config, args.seed)
    if args.quantize_weights == "int8":
        tree = quantize_lm(config, tree)
    model = load_lm(
        dict(config, attention_window=args.attention_window,
             kv_cache_dtype=(None if args.kv_cache_dtype == "bfloat16"
                             else args.kv_cache_dtype),
             weights=args.quantize_weights),
        tree, device=args.device)
    draft = None
    if args.speculative_k:
        draft_heads = args.draft_num_heads or args.num_heads
        if args.draft_embed_dim % draft_heads:
            raise SystemExit(
                f"--draft-embed-dim {args.draft_embed_dim} not divisible "
                f"by draft heads {draft_heads}; set --draft-num-heads")
        draft_config = dict(vocab_size=args.vocab_size,
                            embed_dim=args.draft_embed_dim,
                            num_layers=args.draft_layers,
                            num_heads=draft_heads,
                            pos_embedding=args.pos_embedding,
                            max_seq_len=args.max_seq_len)
        draft = load_lm(draft_config,
                        init_flax_layout_params(draft_config, args.seed + 1),
                        device=args.device)
    prefix_tokens = args.prefix_ids
    if args.system_prefix:
        prefix_tokens = tokenizer.encode(args.system_prefix)
    return GenerationServer(args.model_name or args.model, model,
                            port=args.port,
                            max_new_tokens=args.max_new_tokens,
                            max_batch=args.max_batch, tokenizer=tokenizer,
                            warm=args.warm, warm_async=True,
                            warm_filters=warm_filters, draft_model=draft,
                            speculative_k=args.speculative_k,
                            prefix_tokens=prefix_tokens)


def main(argv=None):
    args = parse_args(argv)
    obs.set_role("serving")
    server = build_server(args)
    draining = threading.Event()

    def _drain_then_shutdown():
        if not server.drain():
            print("drain grace expired with requests in flight",
                  file=sys.stderr)
        server.shutdown()

    def _on_signal(signum, frame):
        if draining.is_set():
            return
        draining.set()
        print(f"signal {signum}; draining then stopping", file=sys.stderr)
        threading.Thread(target=_drain_then_shutdown, name="drain",
                         daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGUSR1, lambda *_: server.begin_drain())
    # The bound port (--port 0 picks a free one), for whoever started
    # the process.
    print(f"serving {args.model_name or args.model!r} on port "
          f"{server.port}", file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    finally:
        server.stop()


if __name__ == "__main__":
    main()

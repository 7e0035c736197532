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
(``GenerationServer``), ``--model moe`` the MoETransformerLM of
``--num-experts`` experts (top-2 routing at capacity factor 1.25, the
demo's defaults; a dropping router, so ``--speculative-k`` refuses it
at startup, as the demo's engine does). Weights are made in the flax
layout from the seed and carried over by models/convert.py;
``--quantize-weights=int8`` quantizes the LM's tree at load, as the
demo launcher does (the MoE's expert kernels stay native).
``--warm-filters`` is validated and then ignored, as in the demo.

``--model-dir`` (default ``$MODEL_DIR``) serves the weights of the
newest finished checkpoint there, as the training drivers (the port's
and the demo's) write it: the LM's or the MoE's ``params``, ResNet's
``params`` and ``batch_stats``; the LM's are restored before
``--quantize-weights=int8`` quantizes them, as in the demo. A directory
with no finished checkpoint serves the initialized weights with the
demo's message (a warning when it holds entries of another format).

    python -m container_engine_accelerators_tpu_torch.serving.serve \
        --model=transformer --model-dir=/ckpt/lm --tokenizer=/models/tok

``--tokenizer`` takes "byte" or a local Hugging Face tokenizer
directory (``transformers`` loads it without a download).

``--speculative-k N`` serves with a draft model, as the demo does: a
TransformerLM of ``--draft-layers`` layers, ``--draft-embed-dim`` and
``--draft-num-heads`` heads (0: the target's; MHA), the target's vocab,
position embedding and max_seq_len, native weights made from seed
``--seed + 1`` (the target's from ``--seed``), or restored from
``--draft-model-dir``. A random draft almost never agrees with the
target: it shows the path, not the speed-up; a trained one (the
driver's ``--model transformer`` at the draft's widths) can.

``--system-prefix`` (text, needs ``--tokenizer``) or
``--system-prefix-ids`` (comma-separated ids) pins a system prompt in
the paged arena: clients send only their suffix. Both are checked when
the command line is parsed, with the demo's messages.

``--tensor-parallel N`` (the LM) shards the wide parameters over a 1 x
N ("data", "model") mesh, column-parallel as the JAX layout has them
(``parallel/spmd.py``), and serves from N ranks in lockstep
(``serving/lockstep.py``): this process is rank 0 and serves HTTP; it
starts ranks 1..N-1 as processes of the same command (cuda:r each
under NCCL, gloo ranks with ``--device cpu``), and the world meets on
a free localhost port. Under the plugin's env contract
(``TPU_WORKER_HOSTNAMES``, one process a host) the world it gives is
the group and each host's process takes its rank from it. Every rank
builds and quantizes the same weights and keeps its shard; the
followers replay rank 0's engine calls. A follower that exits makes
rank 0 exit 1; rank 0's drain stops every rank.

SIGTERM and SIGINT drain: new POSTs answer 503 with Retry-After and
/readyz turns unready while in-flight requests finish (within
``CEA_TPU_DRAIN_GRACE_S``, 30 s by default), then the postmortem
capture writes the journal and the flight-record state (the drained
requests already retired into ``serving_requests``, the KV block pool,
the memory watermarks) to ``CEA_TPU_TRACE_FILE`` when it is set, then
the server stops and the process exits 0. SIGUSR1 starts the same
drain and keeps the process up (a fleet router then steers around the
replica, as it does around ``serving.fleet_worker``).
"""

import argparse
import datetime
import json
import os
import signal
import subprocess
import sys
import threading

import torch

from .. import obs
from ..obs import postmortem
from ..models import convert
from ..models.convert import init_flax_layout_params, load_lm, quantize_lm
from ..models.resnet import resnet
from ..parallel.checkpoint import (
    CheckpointManager,
    warn_unrecognized_checkpoints,
)
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
    p.add_argument("--num-experts", type=int, default=8,
                   help="MoE expert count (--model moe)")
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
                   help="text-in/text-out serving: 'byte' (the "
                        "dependency-free byte-level codec) or a LOCAL "
                        "Hugging Face tokenizer path; empty serves token "
                        "ids only")
    p.add_argument("--quantize-weights", choices=["native", "int8"],
                   default="native",
                   help="int8: weight-only quantization of the "
                        "attention and MLP kernels at load time")
    p.add_argument("--model-dir", default=os.environ.get("MODEL_DIR", ""),
                   help="restore weights from the newest checkpoint_N "
                        "under this directory (as the training drivers "
                        "write it); empty serves random weights made "
                        "from --seed (load-testing only)")
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
                   help="checkpoint directory of the draft (the driver's "
                        "--model transformer at the draft's widths); "
                        "empty serves a random draft made from --seed + "
                        "1 (load-testing only)")
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
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="N > 1: shard the LM's wide parameters over an "
                        "N-way model axis, one rank a device (cuda:0.."
                        "N-1, or gloo ranks with --device cpu); this "
                        "process serves HTTP as rank 0 and starts the "
                        "N-1 others. 1 = a one-device replica")
    # A follower's place in a --tensor-parallel group (set by rank 0
    # when it starts the followers).
    p.add_argument("--lockstep-rank", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--lockstep-port", type=int, default=None,
                   help=argparse.SUPPRESS)
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


def load_checkpoint_variables(model_dir, init_variables):
    """``{"params"[, "batch_stats"]}`` (flax-layout numpy trees) from
    the newest finished checkpoint_N under ``model_dir``; the given
    ``init_variables`` when the directory has none. Only the model's
    variables are read: the optimizer state stays on disk."""
    mgr = CheckpointManager(model_dir)
    step = mgr.latest_step()
    if step is None:
        foreign = warn_unrecognized_checkpoints(
            model_dir, "serving INITIALIZED weights instead")
        if not foreign:
            print(f"no checkpoints under {model_dir!r}; serving "
                  f"initialized weights", file=sys.stderr)
        return init_variables
    template = {"params": init_variables["params"]}
    if "batch_stats" in init_variables:
        template["batch_stats"] = init_variables["batch_stats"]
    restored = mgr.restore(template, step=step)
    print(f"serving weights from {mgr.manifest(step)['path']}",
          file=sys.stderr)
    return restored


def build_image_server(args):
    """The InferenceServer ``args`` describe: ResNet v1.5 of
    ``--depth`` on ``--device`` with flax-layout weights made from
    ``--seed`` or restored from ``--model-dir``, in eval mode."""
    model = resnet(depth=args.depth, device="meta")
    variables = convert.init_flax_layout_image(model, args.seed)
    if args.model_dir:
        variables = load_checkpoint_variables(args.model_dir, variables)
    model = convert.load_image_model(model.to_empty(device=args.device),
                                     variables)
    return InferenceServer(args.model_name or args.model, model,
                           (args.image_size, args.image_size, 3),
                           port=args.port, max_batch=args.max_batch)


def build_lm_models(args, device=None):
    """(model, draft or None): the LM ``args`` describe on ``device``
    (default ``--device``), flax-layout weights made from ``--seed`` or
    restored from ``--model-dir`` and quantized by
    ``--quantize-weights``, as the demo launcher does, and the draft of
    ``--speculative-k``."""
    device = device or args.device
    config = dict(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                  num_layers=args.num_layers, num_heads=args.num_heads,
                  num_kv_heads=args.num_kv_heads or None,
                  pos_embedding=args.pos_embedding,
                  max_seq_len=args.max_seq_len)
    if args.model == "moe":
        config["num_experts"] = args.num_experts
    tree = init_flax_layout_params(config, args.seed)
    if args.model_dir:
        # Restore, then quantize, as the demo launcher does.
        tree = load_checkpoint_variables(args.model_dir,
                                         {"params": tree})["params"]
    if args.quantize_weights == "int8":
        tree = quantize_lm(config, tree)
    model = load_lm(
        dict(config, attention_window=args.attention_window,
             kv_cache_dtype=(None if args.kv_cache_dtype == "bfloat16"
                             else args.kv_cache_dtype),
             weights=args.quantize_weights),
        tree, device=device)
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
        draft_tree = init_flax_layout_params(draft_config, args.seed + 1)
        if args.draft_model_dir:
            draft_tree = load_checkpoint_variables(
                args.draft_model_dir, {"params": draft_tree})["params"]
        draft = load_lm(draft_config, draft_tree, device=device)
    return model, draft


def build_server(args, models=None, lockstep=None):
    """The server the parsed ``args`` describe. ``models``: the LM and
    its draft already built (``build_lm_models``; a tensor-parallel
    rank's shard); ``lockstep``: the tensor-parallel group's channel,
    this process serving as its rank 0."""
    error = prefix_args_error(args)
    if error:
        raise SystemExit(error)
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
    model, draft = models if models is not None else build_lm_models(args)
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
                            prefix_tokens=prefix_tokens, lockstep=lockstep)


def serve(server, name, on_exit=None):
    """Serve until SIGTERM or SIGINT has drained the server (SIGUSR1
    drains and keeps serving); ``on_exit`` runs after the server
    stops."""
    draining = threading.Event()

    def _drain_then_shutdown(signum):
        if not server.drain():
            print("drain grace expired with requests in flight",
                  file=sys.stderr)
        postmortem.capture("signal:" + signal.Signals(signum).name)
        server.shutdown()

    def _on_signal(signum, frame):
        if draining.is_set():
            return
        draining.set()
        print(f"signal {signum}; draining then stopping", file=sys.stderr)
        threading.Thread(target=_drain_then_shutdown, args=(signum,),
                         name="drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGUSR1, lambda *_: server.begin_drain())
    # The bound port (--port 0 picks a free one), for whoever started
    # the process.
    print(f"serving {name!r} on port {server.port}", file=sys.stderr,
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.stop()
        if on_exit is not None:
            on_exit()


def _fatal(message):
    """A tensor-parallel rank that cannot go on: say why and exit 1 at
    once (a collective with a dead peer would never return)."""
    print(message, file=sys.stderr, flush=True)
    os._exit(1)


def _start_followers(args, argv, port):
    """Rank 0 of a one-host group: start ranks 1..N-1 as processes of
    this command with their place in the group (their own device each
    under --device cuda)."""
    procs = []
    for rank in range(1, args.tensor_parallel):
        cmd = [sys.executable, "-m", __spec__.name] + list(argv) + [
            "--lockstep-rank", str(rank), "--lockstep-port", str(port)]
        procs.append(subprocess.Popen(cmd))
    return procs


def _watch_followers(procs, stopping):
    """Rank 0: fail the moment a follower exits before ``stopping``."""
    def watch():
        while not stopping.wait(0.5):
            for rank, proc in enumerate(procs, 1):
                code = proc.poll()
                if code is not None and not stopping.is_set():
                    _fatal(f"tensor-parallel rank {rank} exited with "
                           f"{code}; stopping")

    threading.Thread(target=watch, name="lockstep-watch",
                     daemon=True).start()


def serve_tensor_parallel(args, argv):
    """``--tensor-parallel N``: this process's rank of the group (module
    docstring of ``serving/lockstep.py``). Under the plugin's env
    contract (``distributed.initialize_from_plugin_env``, one process a
    host) the world it gives is the group; otherwise rank 0 starts the
    followers on this host and the world meets on a free localhost
    port. Every rank builds the same LM and keeps its shard of it; rank
    0 serves, the followers replay its engine calls."""
    import torch.distributed as dist

    from ..parallel import distributed
    from ..parallel.mesh import MeshSpec, build_mesh
    from ..parallel.spmd import Spmd
    from .lockstep import Channel, follow

    n = args.tensor_parallel
    rank, procs = args.lockstep_rank or 0, []
    device = args.device
    if args.lockstep_rank is None and distributed.initialize_from_plugin_env(
            device=device):
        rank = dist.get_rank()
        if dist.get_world_size() != n:
            raise SystemExit(
                f"--tensor-parallel {n} but the plugin's world has "
                f"{dist.get_world_size()} ranks")
    else:
        port = args.lockstep_port or distributed.free_local_port()
        if rank == 0:
            procs = _start_followers(args, argv, port)
        if device == "cuda":
            device = f"cuda:{rank}"
        distributed.start_process_group(
            backend=distributed.backend_for(device),
            init_method=f"tcp://127.0.0.1:{port}", world_size=n,
            rank=rank, timeout=datetime.timedelta(minutes=10),
            device=device)
    if rank > 0:
        # Drain and stop are rank 0's: a follower ends when it says so.
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    model, draft = build_lm_models(args, device)
    with torch.no_grad():
        Spmd(build_mesh(MeshSpec(data=1, model=n)), model)
    channel = Channel()
    if rank > 0:
        try:
            follow(channel, model, draft)
        except Exception as e:
            _fatal(f"tensor-parallel rank {rank}: {type(e).__name__}: {e}")
        distributed.shutdown()
        return
    stopping = threading.Event()
    _watch_followers(procs, stopping)
    channel.start_heartbeat(lambda e: _fatal(
        f"tensor-parallel group lost a follower: {e}"))
    server = build_server(args, models=(model, draft), lockstep=channel)

    def stop_group():
        stopping.set()
        channel.stop()
        for proc in procs:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
        distributed.shutdown()

    serve(server, args.model_name or args.model, on_exit=stop_group)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    obs.set_role("serving")
    if args.tensor_parallel < 1:
        raise SystemExit(f"--tensor-parallel must be >= 1: "
                         f"{args.tensor_parallel}")
    if args.tensor_parallel > 1 and args.model in ("transformer", "moe"):
        serve_tensor_parallel(args, argv)
        return
    serve(build_server(args), args.model_name or args.model)


if __name__ == "__main__":
    main()

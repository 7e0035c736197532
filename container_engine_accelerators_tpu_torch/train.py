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


"""Training driver of the port: image classification and LM training
on one card, or as one rank of a data x model mesh.

    python -m container_engine_accelerators_tpu_torch.train \
        --model resnet --depth 50 --batch-size 128 --steps 12
    python -m container_engine_accelerators_tpu_torch.train \
        --model transformer --seq-len 2048 --batch-size 8 --steps 12
    python -m container_engine_accelerators_tpu_torch.train \
        --model moe --num-experts 8 --seq-len 2048 --batch-size 8

Counterpart of demo/tpu-training/train.py: the same flag names and
defaults (``--model`` defaults to resnet), plus ``--device`` (cuda
unless the caller asks for cpu; no fallback). Weights are random, made
from ``--seed`` with numpy in the flax layout (``models/convert.py``);
data is the synthetic image or token loader. The optimizer is the
demo's ``build_tx``: --grad-clip, weight decay on the leaves that are
rank >= 2 in the flax tree, SGD with momentum under one of three
--lr-schedule's. mnist and resnet train on the fused cross-entropy,
inception on the plain loss, as the demo does. ``--data-dir`` trains an
image model on ``.npz`` shards (``NpzShardDataset`` through
``PrefetchLoader``; the LM ignores it, as the demo does), else on the
synthetic loader. --remat, --grad-accum,
--augment (image models; the LM ignores it with a message),
--ema-decay and --eval-batches (top-1/top-5 through the eval step)
follow the demo.

Prints the demo's JSON result line (model, depth, devices,
global_batch, steps, images_per_sec, images_per_sec_per_chip,
final_loss, tokens_per_sec for the LM, eval accuracies) with the
kernels' launch counts and the efficiency readings added: ``train_mfu``
(the Trainer's FLOPs a step, counted on the first step, times the
timed steps over their synchronized wall time and the card's peak;
None where no peak is known, as on the CPU unless CEA_TPU_PEAK_FLOPS
rates it), ``flops_per_step``, and the goodput books at the end of the
run (``goodput_ratio``, ``goodput_wall_s`` and ``goodput_buckets_s``,
every second of the Trainer's life in one bucket: compile, productive,
data_wait, checkpoint, restart, straggler_stall, other).
``--profile-dir D`` traces the timed steps (after --warmup-steps)
with torch.profiler, CPU and CUDA activity, into the Chrome trace
``D/trace.json``. ``--attention-window`` trains the LM
with sliding-window attention (the flash kernels' band). ``--model moe``
trains the MoETransformerLM (``--num-experts``, top-2 routing at
capacity factor 1.25 on the odd layers) on the next-token loss plus
0.01 times the router's aux loss, as the demo's build_lm.

``--model-dir`` (default ``$MODEL_DIR``) checkpoints in the JAX
package's format (``parallel/checkpoint.py``): the newest finished
checkpoint there is restored before the first step (parameters, BN
statistics, momentum, step, EMA) and a real-data run skips the batches
it already took; saves every ``--checkpoint-every`` steps and at the
end, asynchronously, keeping ``--keep-checkpoints``; a ``gs://``
directory warns and turns checkpointing off, as in the demo. A
checkpoint the demo driver wrote resumes here and the reverse.

    python -m container_engine_accelerators_tpu_torch.train \
        --model resnet --data-dir /data/shards --model-dir /ckpt \
        --checkpoint-every 100 --keep-checkpoints 3

``--fsdp`` and ``--model-parallelism M`` train on a ("data", "model")
mesh over the process group's ranks (``parallel/mesh.py``): the data
axis is the world size over M. The group comes from the plugin's env
contract (``parallel.distributed.initialize_from_plugin_env``: NCCL on
the card, gloo with ``--device cpu``; one process per host); a caller
that has started a group already keeps it, and a single process asked
for either flag starts a one-rank group of its own. Every rank takes
the same global batch and trains on its slice; rank 0 alone writes
checkpoints, which hold whole leaves, so a run resumes under another
mesh.

    TPU_WORKER_HOSTNAMES=h0,h1 TPU_WORKER_ID=0 \
    python -m container_engine_accelerators_tpu_torch.train \
        --model transformer --fsdp --model-parallelism 1 ...

``--context-parallelism P --attention ring|ulysses`` trains the LM
on a ("data", "context") mesh (``parallel/context.py``): each context
rank runs its S/P slice of the sequence, and the attention is the
ring or Ulysses schedule over the axis. ``--expert-parallelism P``
trains ``--model moe`` on a ("data", "expert") mesh
(``parallel/expert.py``): each rank holds E/P experts, and the routed
slots travel by all-to-all. Both need a world the axis divides (one
process a rank, as for --fsdp). The demo's rules hold, with its
messages: context parallelism for the LMs only, expert parallelism
for --model moe only, --attention ring/ulysses if and only if
--context-parallelism > 1, context, expert and DCN mutually
exclusive, and no --model-parallelism with the first two.

    for r in 0 1; do TPU_WORKER_HOSTNAMES=127.0.0.1,127.0.0.1 \
      TPU_WORKER_ID=$r python -m \
      container_engine_accelerators_tpu_torch.train --model transformer \
      --context-parallelism 2 --attention ring ... & done

``--dcn-granules G`` lays the ("data", "model") mesh over G granules
(``mesh.build_hybrid_mesh``: the model axis inside a granule, the data
axis granule-major; the ranks cut into G even, rank-ordered granules).

``--pipeline-parallelism K`` (K > 1) trains the PipelinedLM
(``parallel/pipeline_lm.py``: the transformer blocks as circular
pipeline stages over a ("data", "pipe") mesh, K ranks a pipe,
``--num-microbatches`` a step) with its own step, as the demo's
run_pipeline_lm: --remat, --pallas-loss and --label-smoothing apply,
the flags that assume the Trainer's state are refused with the demo's
message, and --model-dir checkpoints its {step, params, opt_state}
payload (whole leaves, rank 0 writing; either driver resumes the
other's). ``--pipeline-parallelism 1`` takes the Trainer path, as in
the demo; ``run_pipeline_lm`` runs a one-rank pipe too.

    for r in 0 1; do TPU_WORKER_HOSTNAMES=127.0.0.1,127.0.0.1 \
      TPU_WORKER_ID=$r python -m \
      container_engine_accelerators_tpu_torch.train --model transformer \
      --pipeline-parallelism 2 --num-microbatches 4 ... & done
"""

import argparse
import functools
import json
import math
import os
import sys
import time

import torch

import torch.distributed as dist

from . import obs
from .models import convert, mlp
from .models.decode import logits_of
from .models.inception import InceptionV3
from .models.moe import with_router_loss
from .models.resnet import resnet
from .models.transformer import next_token_loss_fn
from .ops import attention, xent
from .ops.augment import make_augment_fn
from .ops.xent import mean_cross_entropy_loss
from .parallel import (
    CheckpointManager,
    NpzShardDataset,
    PrefetchLoader,
    Sgd,
    SyntheticLoader,
    SyntheticTokenLoader,
    Trainer,
    cross_entropy_loss,
    restore_state,
    state_payload,
)
from .parallel import distributed
from .parallel.checkpoint import warn_unrecognized_checkpoints
from .parallel.context import (
    CONTEXT_AXIS,
    build_context_mesh,
    ring_attention,
    ulysses_attention,
)
from .parallel.expert import build_expert_mesh
from .parallel.mesh import (
    DATA_AXIS,
    axis_index,
    build_hybrid_mesh,
    build_mesh,
    default_spec,
)
from .parallel import pipeline_lm
from .parallel.pipeline import PIPELINE_AXIS, build_pipeline_mesh
from .parallel.pipeline_lm import PipelinedLM
from .obs import efficiency, profiler
from .utils import wall_sync

IMAGE_MODELS = ("mnist", "resnet", "inception")
LM_MODELS = ("transformer", "moe")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Training on one card "
                                            "(PyTorch port)")
    p.add_argument("--model",
                   choices=["mnist", "resnet", "inception",
                            "transformer", "moe"],
                   default="resnet")
    p.add_argument("--depth", type=int, default=50,
                   help="ResNet depth (18/34/50/101/152)")
    p.add_argument("--seq-len", type=int, default=512,
                   help="LM sequence length")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--embed-dim", type=int, default=512)
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--num-kv-heads", type=int, default=0,
                   help="grouped-query attention (0 = MHA)")
    p.add_argument("--pos-embedding", choices=["learned", "rope"],
                   default="learned")
    p.add_argument("--attention-window", type=int, default=0,
                   help="sliding-window attention width (0 = full "
                        "causal)")
    p.add_argument("--num-experts", type=int, default=8,
                   help="MoE expert count (--model moe)")
    p.add_argument("--expert-parallelism", type=int, default=1)
    p.add_argument("--context-parallelism", type=int, default=1)
    p.add_argument("--attention", choices=["flash", "ring", "ulysses"],
                   default="flash")
    p.add_argument("--batch-size", type=int, default=256,
                   help="global batch size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--lr-schedule",
                   choices=["constant", "cosine", "linear"],
                   default="constant")
    p.add_argument("--lr-warmup-steps", type=int, default=0)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--grad-clip", type=float, default=0.0,
                   help="clip gradients to this global L2 norm before "
                        "the update (0 = off)")
    p.add_argument("--seed", type=int, default=0,
                   help="parameter-init seed")

    def _smoothing(v):
        v = float(v)
        if not 0.0 <= v < 1.0:
            raise argparse.ArgumentTypeError(
                f"label smoothing must be in [0, 1): {v}")
        return v

    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--label-smoothing", type=_smoothing, default=0.0)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--warmup-steps", type=int, default=5,
                   help="steps excluded from throughput timing")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--model-parallelism", type=int, default=1)
    p.add_argument("--pipeline-parallelism", type=int, default=1)
    p.add_argument("--num-microbatches", type=int, default=4)
    p.add_argument("--dcn-granules", type=int, default=0)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--crop-padding", type=int, default=4)
    p.add_argument("--pallas-loss", action="store_true", default=True,
                   help="the fused cross-entropy kernel (the default)")
    p.add_argument("--no-pallas-loss", dest="pallas_loss",
                   action="store_false",
                   help="the plain cross_entropy_loss instead")
    p.add_argument("--json", action="store_true",
                   help="print a single JSON result line (always done)")
    p.add_argument("--data-dir", default="",
                   help="directory of .npz shards (images/labels "
                        "arrays) for real-data image training; empty "
                        "uses the synthetic loader")
    p.add_argument("--model-dir", default=os.environ.get("MODEL_DIR", ""),
                   help="checkpoint directory (local path): restore the "
                        "newest checkpoint_N there, save into it")
    p.add_argument("--profile-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="also checkpoint every N steps (0 = end only)")
    p.add_argument("--keep-checkpoints", type=int, default=0,
                   help="retain only the newest N finished "
                        "checkpoints (0 = keep all)")
    p.add_argument("--eval-batches", type=int, default=0)
    p.add_argument("--compilation-cache-dir", default="",
                   help="the demo's XLA compile cache; accepted and "
                        "unused (the port compiles no programs)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda unless cpu is "
                        "asked for; no fallback)")
    return p.parse_args(argv)


def check_ported(args):
    """Refuse the demo driver's flag combinations with its messages
    (SystemExit)."""
    if args.context_parallelism > 1 and args.model not in LM_MODELS:
        raise SystemExit(
            "--context-parallelism only applies to the LM models")
    if args.expert_parallelism > 1 and args.model != "moe":
        raise SystemExit(
            "--expert-parallelism only applies to --model moe")
    if (args.attention != "flash") != (args.context_parallelism > 1):
        raise SystemExit(
            "--attention ring/ulysses and --context-parallelism > 1 "
            "go together: sequence-parallel schedules need a context "
            "axis, and a context axis needs one of them")
    exclusive = {
        "--expert-parallelism": args.expert_parallelism > 1,
        "--context-parallelism": args.context_parallelism > 1,
        "--dcn-granules": args.dcn_granules > 1,
    }
    chosen = [flag for flag, on in exclusive.items() if on]
    if len(chosen) > 1:
        raise SystemExit(
            f"{' and '.join(chosen)} cannot combine: each builds its "
            f"own mesh axes")
    if args.model_parallelism > 1 and chosen and \
            chosen != ["--dcn-granules"]:
        raise SystemExit(
            f"--model-parallelism cannot combine with {chosen[0]}: "
            f"that mesh has no 'model' axis")


def lm_config(args):
    """TransformerLM keyword arguments from the flags (the demo's
    build_lm); ``num_experts`` too for --model moe (the
    MoETransformerLM's, with its default top_k and capacity_factor)."""
    config = dict(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                  num_layers=args.num_layers, num_heads=args.num_heads,
                  num_kv_heads=args.num_kv_heads or None,
                  pos_embedding=args.pos_embedding,
                  attention_window=args.attention_window,
                  max_seq_len=args.seq_len)
    if args.model == "moe":
        config["num_experts"] = args.num_experts
    return config


def linear_schedule(init_value, end_value, transition_steps):
    """optax.linear_schedule (transition_begin 0)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        count = min(max(count, 0), transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def join_schedules(schedules, boundaries):
    """optax.join_schedules: schedule i runs from boundary i - 1 and
    sees the count since it."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def build_tx(args, config=None, decay_mask=None):
    """The demo's optimizer (--lr-schedule + --grad-clip + weight decay
    on flax-rank >= 2 leaves + SGD/momentum) as an ``Sgd``. ``config``:
    the TransformerLM config the decay mask reads the flax ranks of
    (default: from the flags). An image model's flax ranks are its
    torch ranks: conv and linear weights decay, BN and biases do
    not. ``decay_mask`` replaces the mask (the pipeline's, whose
    blocks are stacked)."""
    if args.lr_schedule == "constant":
        lr = args.lr
    elif args.lr_schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, warmup, decay).
        warmup = args.lr_warmup_steps
        lr = join_schedules(
            [linear_schedule(0.0, args.lr, warmup),
             cosine_decay_schedule(
                 args.lr, max(args.steps, warmup + 1) - warmup)],
            [warmup])
    else:  # linear
        lr = join_schedules(
            [linear_schedule(0.0, args.lr, args.lr_warmup_steps),
             linear_schedule(args.lr, 0.0,
                             max(args.steps - args.lr_warmup_steps, 1))],
            [args.lr_warmup_steps])
    if args.model in IMAGE_MODELS:
        def mask(_name, param):
            return param.dim() >= 2
    elif decay_mask is None:
        shapes = convert.flax_shapes(config or lm_config(args))

        def mask(name, _param):
            # The flax leaf's rank, not the torch tensor's: the
            # attention biases are [3, H, D] / [H, D] / [2, Hkv, D]
            # there and decay.
            return len(shapes[name][1]) >= 2

    return Sgd(lr, momentum=args.momentum,
               weight_decay=args.weight_decay,
               decay_mask=mask if decay_mask is None else decay_mask,
               grad_clip=args.grad_clip)


def build_lm(args, device, mesh=None):
    """(model, loss_fn): the port's TransformerLM (MoETransformerLM for
    --model moe) with random weights from --seed (trainable, f32
    parameters, bf16 compute) and the next-token loss (fused kernel, or
    the plain loss), with the router's aux loss added for the MoE. As
    the demo's build_lm: with --context-parallelism the attention is
    the --attention schedule over ``mesh``'s context axis, and with
    --expert-parallelism the MoE is bound to ``mesh``."""
    config = lm_config(args)
    tree = convert.init_flax_layout_params(config, args.seed)
    model = convert.load_lm(config, tree, device=device, trainable=True)
    if args.context_parallelism > 1:
        if args.attention_window:
            # The model's refusal of a window on another schedule.
            raise ValueError(
                "window (sliding-window attention) needs an attention_fn "
                "that takes window=; this one does not")
        schedule = (ulysses_attention if args.attention == "ulysses"
                    else ring_attention)
        attention_fn = functools.partial(
            schedule, mesh, axis_name=CONTEXT_AXIS, batch_axis=DATA_AXIS)
        for block in model.blocks:
            block.attn.attention_fn = attention_fn
    if args.model == "moe" and args.expert_parallelism > 1:
        model.bind_mesh(mesh)
    loss = functools.partial(
        mean_cross_entropy_loss if args.pallas_loss else cross_entropy_loss,
        label_smoothing=args.label_smoothing)
    loss_fn = next_token_loss_fn(loss)
    if args.model == "moe":
        loss_fn = with_router_loss(loss_fn)
    return model, loss_fn


def build_model(args, device):
    """(model, image_shape, num_classes) of an image model, as the
    demo's build_model (MnistMLP at 28x28x1 and 10 classes, whatever
    --image-size and --num-classes say; Inception-v3; ResNet at
    --depth), with random weights from --seed in the flax layout, in
    train mode."""
    # Built on the meta device: the flax-layout tree sets every weight
    # and statistic, so the modules' own initializers need not run.
    if args.model == "mnist":
        shape, classes = mlp.IMAGE_SHAPE, 10
        model = mlp.MnistMLP(num_classes=classes, device="meta")
    else:
        shape = (args.image_size, args.image_size, 3)
        classes = args.num_classes
        if args.model == "inception":
            model = InceptionV3(num_classes=classes, device="meta")
        else:
            model = resnet(args.depth, classes, device="meta")
    variables = convert.init_flax_layout_image(model, args.seed)
    model = convert.load_image_model(model.to_empty(device=device),
                                     variables)
    return model.train(), shape, classes


# The process group this module started (the bootstrap's, or a one-rank
# group), which ``run`` tears down at its end; a caller's group stays.
_own_group = False


def setup_mesh(args, device):
    """The ("data", "model") mesh of the run, or None for one device
    without a group. Starts the process group from the plugin's env
    contract unless one is up; with --fsdp or --model-parallelism and
    still no group, starts a one-rank group of this process on a free
    localhost port. The data axis is the world over
    --model-parallelism."""
    global _own_group
    if not dist.is_initialized():
        _own_group = distributed.initialize_from_plugin_env(
            device=device)
    if not dist.is_initialized():
        if not (args.fsdp or args.model_parallelism > 1
                or args.expert_parallelism > 1
                or args.context_parallelism > 1
                or args.dcn_granules > 1):
            return None
        distributed.start_local_group(device)
        _own_group = True
    if args.model == "moe" and args.expert_parallelism > 1:
        return build_expert_mesh(expert=args.expert_parallelism)
    if args.context_parallelism > 1:
        return build_context_mesh(context=args.context_parallelism)
    if args.dcn_granules > 1:
        return build_hybrid_mesh(model=args.model_parallelism,
                                 num_granules=args.dcn_granules)
    return build_mesh(default_spec(dist.get_world_size(),
                                   args.model_parallelism))


def teardown_group():
    """Tear down the process group ``setup_mesh`` started, if any."""
    global _own_group
    if _own_group:
        distributed.shutdown()
        _own_group = False


def is_primary():
    """Whether this process writes checkpoints (rank 0, or no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def build_trainer(args, device):
    """(trainer, state, loader) from the flags, after checking that
    they name a ported path and that ``device`` exists. The loader is
    None for an image model with ``--data-dir``: ``real_data_loader``
    makes it once the restored step is known."""
    check_ported(args)
    device = torch.device(device)
    check_device(device)
    if device.type == "cuda":
        # cuDNN picks each convolution's algorithm by timing in the
        # first steps (XLA autotunes at compile); --warmup-steps keeps
        # them out of the throughput.
        torch.backends.cudnn.benchmark = True
    augment_fn = None
    if args.model in IMAGE_MODELS:
        model, shape, classes = build_model(args, device)
        fused = args.pallas_loss and args.model != "inception"
        loss_fn = functools.partial(
            mean_cross_entropy_loss if fused else cross_entropy_loss,
            label_smoothing=args.label_smoothing)
        loader = None if args.data_dir else SyntheticLoader(
            args.batch_size, shape, classes, device=device)
        if args.augment:
            augment_fn = make_augment_fn(flip=True,
                                         crop_padding=args.crop_padding)
        mesh = setup_mesh(args, device)
    else:
        mesh = setup_mesh(args, device)
        model, loss_fn = build_lm(args, device, mesh)
        loader = SyntheticTokenLoader(args.batch_size, args.seq_len,
                                      args.vocab_size, device=device)
        if args.augment:
            print("--augment only applies to image models; ignoring",
                  file=sys.stderr)
    trainer = Trainer(model, loss_fn, build_tx(args), mesh=mesh,
                      fsdp=args.fsdp, remat=args.remat,
                      grad_accum=args.grad_accum, augment_fn=augment_fn,
                      ema_decay=args.ema_decay)
    return trainer, trainer.init_state(), loader


def real_data_loader(args, device, skip, wait_cb=None):
    """``--data-dir``'s loader: the shards' batches staged onto
    ``device``, past the ``skip`` batches a restored run already took
    (``NpzShardDataset``'s per-shard fast-forward)."""
    return PrefetchLoader(
        NpzShardDataset(args.data_dir, args.batch_size, skip_batches=skip),
        device=device, wait_cb=wait_cb)


# One CheckpointManager per directory for this process: repeated runs
# in one process share its writer thread, as the demo's do.
_managers = {}


def _manager(model_dir, keep=None, goodput=None):
    """The directory's manager; explicit keep/goodput reconfigure it,
    None leaves a setting alone (the restore path passes neither). Only
    the primary rank writes (``is_primary``)."""
    model_dir = os.path.abspath(model_dir)
    mgr = _managers.get(model_dir)
    if mgr is None:
        mgr = _managers[model_dir] = CheckpointManager(
            model_dir, keep=keep or 0, goodput=goodput,
            primary=is_primary())
    else:
        mgr.configure(keep=keep, goodput=goodput, primary=is_primary())
    return mgr


def _state_layout(args):
    """state_payload's (config, schedule) for the flags."""
    config = None if args.model in IMAGE_MODELS else lm_config(args)
    return config, args.lr_schedule != "constant"


def save_checkpoint(args, trainer, state):
    """Checkpoint the TrainState into --model-dir, its leaves whole
    (``Trainer.full_state``; every rank takes part, rank 0 writes).
    Returns once the state is copied to the host, with the seconds that
    took (also the Trainer's goodput checkpoint bucket; None on a rank
    that writes nothing); the write (and the retention prune) finishes
    in the background (``finalize_checkpoints`` waits for it)."""
    config, schedule = _state_layout(args)
    mgr = _manager(args.model_dir, keep=args.keep_checkpoints,
                   goodput=trainer.goodput)
    with trainer.full_state(state):
        path = mgr.save(state_payload(state, config, schedule),
                        step=state.step)
    if path is None:
        return None
    print(f"saving checkpoint {path} (async)", file=sys.stderr)
    return mgr.last_blocked_s


def finalize_checkpoints():
    """Block until every async checkpoint write has landed."""
    for mgr in _managers.values():
        mgr.wait_until_finished()


def restore_checkpoint(args, trainer, state):
    """Resume from the newest checkpoint in --model-dir, if any (else
    warn about entries of another format there). Every rank reads the
    whole leaves and keeps its shards of them."""
    mgr = _manager(args.model_dir)
    if mgr.latest_step() is None:
        warn_unrecognized_checkpoints(
            args.model_dir,
            "they will NOT be restored, and saves at the same step "
            "numbers will replace them")
        return state
    config, schedule = _state_layout(args)
    with trainer.full_state(state):
        state = restore_state(mgr, state, config=config,
                              schedule=schedule)
    print(f"restored checkpoint step {state.step} from "
          f"{args.model_dir}", file=sys.stderr)
    return state


def stop_profile(prof, profile_dir):
    """Stop ``prof`` and write its Chrome trace; returns the path."""
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, profiler.TRACE_NAME)
    prof.export_chrome_trace(path)
    print(f"wrote profiler trace to {path}", file=sys.stderr)
    return path


def train_mfu(trainer, device, steps, elapsed):
    """The timed steps' MFU: the Trainer's FLOPs a step times ``steps``
    over ``elapsed`` (a synchronized wall time) and the device's peak;
    None where a term is unknown."""
    flops = trainer.flops_per_step()
    peak = efficiency.peak_flops_per_chip(efficiency.device_kind(device))
    if not (flops and peak and steps and elapsed > 0):
        return None
    return flops * steps / elapsed / peak


def kernel_launches():
    return {k.name: k.launches for k in attention.KERNELS + xent.KERNELS}


def evaluate(trainer, state, loader, args):
    """Top-1 and top-5 accuracy over --eval-batches through the eval
    step (next-token accuracy for the LM). The counts stay on the
    device until the end. Returns (top1, top5)."""
    correct = correct5 = None
    total = 0
    for _, (inputs, labels) in zip(range(args.eval_batches), loader):
        logits = logits_of(trainer.eval_step(state, inputs))
        if args.model in IMAGE_MODELS:
            want = labels
        else:
            logits, want = logits[:, :-1], labels[:, 1:]
        k = min(5, logits.shape[-1])
        top = logits.topk(k, dim=-1).indices
        hit1 = (top[..., 0] == want).sum()
        hit5 = (top == want[..., None]).any(-1).sum()
        correct = hit1 if correct is None else correct + hit1
        correct5 = hit5 if correct5 is None else correct5 + hit5
        total += want.numel()
    if not total:
        return 0.0, 0.0
    return int(correct) / total, int(correct5) / total


def run(args, on_step=None, on_batch=None):
    """Train as the flags say; returns (result dict, trainer, state).
    ``on_step(step, loss)``, if given, is called after every step with
    the step's loss as a device tensor (no host sync);
    ``on_batch(step, batch)`` before every step with its batch."""
    device = torch.device(args.device)
    trainer, state, loader = build_trainer(args, device)
    if args.model_dir.startswith("gs://"):
        print("WARNING: gs:// model dirs need a GCS-enabled image; "
              "skipping checkpointing", file=sys.stderr)
        args.model_dir = ""
    if args.model_dir:
        t_restore = time.perf_counter()
        state = restore_checkpoint(args, trainer, state)
        if state.step > 0:
            # A restored run spent this wall time on recovery: the
            # goodput ledger's restart bucket, and the journal event
            # the offline goodput replay reads.
            recovery_s = time.perf_counter() - t_restore
            trainer.record_badput("restart", recovery_s)
            obs.event("train.restart", step=state.step,
                      recovery_s=round(recovery_s, 6))
    waits = []
    if loader is None:
        # Deferred: the fast-forward needs the restored step, and the
        # loader starts staging the moment it exists.
        def on_wait(seconds):
            waits.append(seconds)
            trainer.record_data_wait(seconds)

        loader = real_data_loader(args, device, state.step,
                                  wait_cb=on_wait)
    before = kernel_launches()
    losses, blocked = [], []
    warmup = max(args.warmup_steps, 0)
    prof = None

    def start_timed_region():
        nonlocal prof
        if args.profile_dir:
            prof = profiler.start_profiler()
        return time.perf_counter()

    t_start = start_timed_region() if warmup == 0 else None
    for step, batch in zip(range(args.steps), loader):
        if on_batch is not None:
            on_batch(step, batch)
        state, loss = trainer.train_step(state, batch)
        if on_step is not None:
            on_step(step, loss)
        if t_start is None and step == warmup - 1:
            wall_sync(loss)
            t_start = start_timed_region()
        if step % 20 == 0 or step == args.steps - 1:
            loss_val = float(loss)
            losses.append(loss_val)
            print(f"step {step} loss {loss_val:.4f}", file=sys.stderr)
        if (args.model_dir and args.checkpoint_every
                and (step + 1) % args.checkpoint_every == 0):
            blocked.append(save_checkpoint(args, trainer, state))
    wall_sync(state.model)
    t_end = time.perf_counter()
    if hasattr(loader, "close"):
        # Staged batches would otherwise stay in device memory through
        # the final checkpoint.
        loader.close()
    trace = stop_profile(prof, args.profile_dir) if prof else None
    timed_steps = max(args.steps - warmup, 0)
    elapsed = t_end - t_start if t_start is not None else 0.0
    if t_start is None or timed_steps == 0:
        per_sec = 0.0
    else:
        per_sec = (args.batch_size * timed_steps / elapsed
                   if elapsed > 0 else 0.0)
    after = kernel_launches()
    devices = dist.get_world_size() if dist.is_initialized() else 1
    result = {
        "model": args.model,
        "depth": args.depth if args.model == "resnet" else None,
        "devices": devices,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "global_batch": args.batch_size,
        "steps": args.steps,
        "images_per_sec": round(per_sec, 2),
        "images_per_sec_per_chip": round(per_sec / devices, 2),
        "final_loss": losses[-1] if losses else None,
    }
    if args.model not in IMAGE_MODELS:
        result["tokens_per_sec"] = round(per_sec * args.seq_len, 2)
    result["kernel_launches"] = {name: after[name] - before[name]
                                 for name in after}
    if waits:
        # The consumer's mean wait for a staged batch a step.
        result["data_wait_ms_mean"] = 1e3 * sum(waits) / len(waits)
    if args.eval_batches:
        top1, top5 = evaluate(trainer, state, loader, args)
        result["eval_accuracy"] = round(top1, 4)
        result["eval_top5_accuracy"] = round(top5, 4)
        print(f"eval accuracy top1 {result['eval_accuracy']} "
              f"top5 {result['eval_top5_accuracy']}", file=sys.stderr)
    if trace is not None:
        result["profile_trace"] = trace
    if trainer.mesh is not None:
        result["mesh"] = dict(zip(trainer.mesh.mesh_dim_names,
                                  trainer.mesh.mesh.shape))
        result["fsdp"] = bool(args.fsdp)
    if args.model_dir:
        blocked.append(save_checkpoint(args, trainer, state))
        finalize_checkpoints()
        # Each save's blocking seconds (its host copy), in order.
        result["checkpoint_block_s"] = blocked
    result["flops_per_step"] = trainer.flops_per_step()
    result["train_mfu"] = train_mfu(trainer, device, timed_steps, elapsed)
    books = trainer.goodput.publish()
    result["goodput_ratio"] = books["goodput_ratio"]
    result["goodput_wall_s"] = books["wall_s"]
    result["goodput_buckets_s"] = books["buckets"]
    return result, trainer, state


def check_device(device):
    """Refuse --device cuda without a card (no fallback)."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() "
                           "is False (pass --device cpu to run the plain "
                           "versions on the CPU)")


PIPELINE_UNSUPPORTED = (
    ("--model-parallelism", lambda a: a.model_parallelism > 1),
    ("--context-parallelism", lambda a: a.context_parallelism > 1),
    ("--expert-parallelism", lambda a: a.expert_parallelism > 1),
    ("--dcn-granules", lambda a: a.dcn_granules > 1),
    ("--fsdp", lambda a: a.fsdp),
    ("--grad-accum", lambda a: a.grad_accum > 1),
    ("--ema-decay", lambda a: a.ema_decay > 0),
    ("--eval-batches", lambda a: a.eval_batches > 0),
    ("--data-dir", lambda a: bool(a.data_dir)),
    ("--num-kv-heads", lambda a: a.num_kv_heads > 0),
    ("--attention-window", lambda a: a.attention_window > 0),
    ("--pos-embedding rope", lambda a: a.pos_embedding == "rope"),
    ("--attention ring/ulysses", lambda a: a.attention != "flash"),
)


def build_pipeline(args, device):
    """(model, optimizer, tx, mesh) of ``run_pipeline_lm``, after the
    demo's flag checks (SystemExit with its messages). Starts the
    process group from the plugin's env contract unless one is up; with
    none, the pipe is this one process (``mesh`` None)."""
    global _own_group
    pp = args.pipeline_parallelism
    if args.model != "transformer":
        raise SystemExit(
            "--pipeline-parallelism applies to --model transformer")
    on = [flag for flag, bad in PIPELINE_UNSUPPORTED if bad(args)]
    if on:
        raise SystemExit(
            f"--pipeline-parallelism does not support {', '.join(on)}")
    check_device(device)
    if not dist.is_initialized():
        _own_group = distributed.initialize_from_plugin_env(device=device)
    devices = dist.get_world_size() if dist.is_initialized() else 1
    if devices % pp != 0:
        raise SystemExit(f"{devices} devices do not fold onto pipe={pp}")
    mesh = (build_pipeline_mesh(pp, data=devices // pp)
            if dist.is_initialized() else None)
    stage = 0 if mesh is None else axis_index(mesh, PIPELINE_AXIS)
    lm = PipelinedLM(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                     num_layers=args.num_layers, num_heads=args.num_heads,
                     max_seq_len=args.seq_len, pipe=pp, remat=args.remat,
                     stage=stage, device=device)
    lm.load(lm.init(args.seed)).train()
    tx = build_tx(args, lm.config(),
                  decay_mask=pipeline_lm.decay_mask(lm))
    return lm, tx.init(lm), tx, mesh


def save_pipeline_checkpoint(args, lm, optimizer, step, mesh):
    """Checkpoint the pipeline payload ({step, params, opt_state}, whole
    leaves: the block rows gathered over the pipe axis, every rank
    entering, rank 0 writing) into --model-dir, under the same
    checkpoint_N naming as the Trainer path. Returns the path (None on
    a rank that writes nothing)."""
    mgr = _manager(args.model_dir, keep=args.keep_checkpoints)
    path = mgr.save(pipeline_lm.pipeline_payload(
        lm, optimizer, step, mesh, schedule=args.lr_schedule != "constant"),
        step=step)
    if path is not None:
        print(f"saving checkpoint {path} (async)", file=sys.stderr)
    return path


def restore_pipeline_checkpoint(args, lm, optimizer, mesh):
    """Load the newest finished checkpoint in --model-dir into this
    rank's rows; returns its step, or None when the directory holds
    none (after warning about entries of another format)."""
    mgr = _manager(args.model_dir)
    if mgr.latest_step() is None:
        warn_unrecognized_checkpoints(
            args.model_dir,
            "they will NOT be restored, and saves at the same step "
            "numbers will replace them")
        return None
    template = pipeline_lm.pipeline_payload(
        lm, optimizer, 0, mesh, schedule=args.lr_schedule != "constant",
        whole=False)
    return pipeline_lm.load_payload(lm, optimizer, mgr.restore(template))


def run_pipeline_lm(args, on_step=None):
    """Train the PipelinedLM as the flags say (the module docstring; the
    demo's run_pipeline_lm); returns (result dict, model, optimizer).
    ``on_step(step, loss)`` as in ``run``. Each rank takes the global
    batch and trains on its data rank's rows; the gradients are
    averaged over the data axis, the reported loss too."""
    device = torch.device(args.device)
    lm, optimizer, tx, mesh = build_pipeline(args, device)
    pp, m = args.pipeline_parallelism, args.num_microbatches
    devices = dist.get_world_size() if dist.is_initialized() else 1
    if args.model_dir.startswith("gs://"):
        print("WARNING: gs:// model dirs need a GCS-enabled image; "
              "skipping checkpointing", file=sys.stderr)
        args.model_dir = ""
    step0 = 0
    if args.model_dir:
        restored = restore_pipeline_checkpoint(args, lm, optimizer, mesh)
        if restored is not None:
            step0 = restored
            print(f"restored checkpoint step {step0} from "
                  f"{args.model_dir}", file=sys.stderr)
    loader = SyntheticTokenLoader(args.batch_size, args.seq_len,
                                  args.vocab_size, device=device)
    lm_loss = next_token_loss_fn(functools.partial(
        mean_cross_entropy_loss if args.pallas_loss else cross_entropy_loss,
        label_smoothing=args.label_smoothing))

    def train_step(count, tokens):
        optimizer.zero_grad(set_to_none=True)
        tokens = pipeline_lm.local_batch(mesh, tokens)
        loss = lm_loss(lm.apply(tokens, mesh=mesh, num_microbatches=m),
                       tokens)
        loss.backward()
        pipeline_lm.reduce_grads(lm, mesh)
        norm = (pipeline_lm.grad_norm(lm, mesh) if tx.grad_clip > 0
                else None)
        tx.update(optimizer, count, norm=norm)
        return pipeline_lm.mean_over_data(loss, mesh)

    before = kernel_launches()
    losses = []
    warmup = max(args.warmup_steps, 0)
    t_start = time.perf_counter() if warmup == 0 else None
    for step, (tokens, _) in zip(range(args.steps), loader):
        loss = train_step(step0 + step, tokens)
        if on_step is not None:
            on_step(step, loss)
        if t_start is None and step == warmup - 1:
            wall_sync(loss)
            t_start = time.perf_counter()
        if step % 20 == 0 or step == args.steps - 1:
            loss_val = float(loss)
            losses.append(loss_val)
            print(f"step {step} loss {loss_val:.4f}", file=sys.stderr)
        if (args.model_dir and args.checkpoint_every
                and (step + 1) % args.checkpoint_every == 0):
            save_pipeline_checkpoint(args, lm, optimizer, step0 + step + 1,
                                     mesh)
    wall_sync(lm)
    t_end = time.perf_counter()
    timed_steps = max(args.steps - warmup, 0)
    elapsed = (t_end - t_start) if t_start is not None else 0.0
    seqs_per_sec = (args.batch_size * timed_steps / elapsed
                    if elapsed > 0 and timed_steps else 0.0)
    if args.model_dir:
        save_pipeline_checkpoint(args, lm, optimizer, step0 + args.steps,
                                 mesh)
        finalize_checkpoints()
    after = kernel_launches()
    result = {
        "model": "transformer",
        "pipeline_parallelism": pp,
        "num_microbatches": m,
        "devices": devices,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "global_batch": args.batch_size,
        "steps": args.steps,
        "images_per_sec": round(seqs_per_sec, 2),
        "images_per_sec_per_chip": round(seqs_per_sec / devices, 2),
        "tokens_per_sec": round(seqs_per_sec * args.seq_len, 2),
        "final_loss": losses[-1] if losses else None,
        "kernel_launches": {name: after[name] - before[name]
                            for name in after},
    }
    return result, lm, optimizer


def main(argv=None, on_step=None):
    """Train and print the JSON result line; returns it as a dict.
    ``on_step`` as in ``run``. A process group this run started is
    torn down before it returns."""
    obs.set_role("train")
    args = parse_args(argv)
    try:
        if args.pipeline_parallelism > 1:
            result, _, _ = run_pipeline_lm(args, on_step)
        else:
            result, _, _ = run(args, on_step)
    finally:
        teardown_group()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

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


"""Training driver of the port: LM training on one card.

    python -m container_engine_accelerators_tpu_torch.train \
        --model transformer --seq-len 2048 --batch-size 8 --steps 12

Counterpart of demo/tpu-training/train.py for ``--model transformer``:
the same flag names and defaults (``--model`` defaults to transformer,
the one model ported), plus ``--device`` (cuda unless the caller asks
for cpu; no fallback). Weights are random, made from ``--seed`` with
numpy in the flax layout (``models/convert.py``); data is the
synthetic token loader. The optimizer is the demo's ``build_tx``:
--grad-clip, weight decay on the leaves that are rank >= 2 in the flax
tree, SGD with momentum under one of three --lr-schedule's.

Prints the demo's JSON result line (model, devices, global_batch,
steps, images_per_sec, images_per_sec_per_chip, tokens_per_sec,
final_loss) with the kernels' launch counts added. Every flag of the
demo's other paths (other models, parallelism, checkpoints, profiles,
eval, augmentation, EMA, remat, gradient accumulation, the attention
window) raises "not yet ported".
"""

import argparse
import functools
import json
import math
import os
import sys
import time

import torch

from .models import convert
from .models.transformer import next_token_loss_fn
from .ops import attention, xent
from .ops.xent import mean_cross_entropy_loss
from .parallel import Sgd, SyntheticTokenLoader, Trainer, cross_entropy_loss
from .utils import not_ported, wall_sync


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="LM training on one card "
                                            "(PyTorch port)")
    p.add_argument("--model",
                   choices=["mnist", "resnet", "inception",
                            "transformer", "moe"],
                   default="transformer")
    p.add_argument("--depth", type=int, default=50,
                   help="ResNet depth (not ported)")
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
                   help="sliding-window width (not ported)")
    p.add_argument("--num-experts", type=int, default=8,
                   help="MoE expert count (moe is not ported)")
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
    p.add_argument("--data-dir", default="")
    p.add_argument("--model-dir", default=os.environ.get("MODEL_DIR", ""))
    p.add_argument("--profile-dir", default="")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--keep-checkpoints", type=int, default=0)
    p.add_argument("--eval-batches", type=int, default=0)
    p.add_argument("--compilation-cache-dir", default="",
                   help="the demo's XLA compile cache; accepted and "
                        "unused (the port compiles no programs)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda unless cpu is "
                        "asked for; no fallback)")
    return p.parse_args(argv)


def check_ported(args):
    """Raise "not yet ported" for every flag of a path this slice does
    not carry."""
    if args.model != "transformer":
        raise not_ported(f"--model {args.model}")
    unported = {
        "--attention-window": args.attention_window > 0,
        "--expert-parallelism": args.expert_parallelism > 1,
        "--context-parallelism": args.context_parallelism > 1,
        "--attention ring/ulysses": args.attention != "flash",
        "--model-parallelism": args.model_parallelism > 1,
        "--pipeline-parallelism": args.pipeline_parallelism > 1,
        "--dcn-granules": args.dcn_granules > 1,
        "--remat": args.remat,
        "--fsdp": args.fsdp,
        "--grad-accum": args.grad_accum > 1,
        "--augment": args.augment,
        "--ema-decay": args.ema_decay > 0,
        "--data-dir": bool(args.data_dir),
        "--model-dir": bool(args.model_dir),
        "--profile-dir": bool(args.profile_dir),
        "--eval-batches": args.eval_batches > 0,
    }
    on = [flag for flag, bad in unported.items() if bad]
    if on:
        raise not_ported(", ".join(on))


def lm_config(args):
    """TransformerLM keyword arguments from the flags (the demo's
    build_lm)."""
    return dict(vocab_size=args.vocab_size, embed_dim=args.embed_dim,
                num_layers=args.num_layers, num_heads=args.num_heads,
                num_kv_heads=args.num_kv_heads or None,
                pos_embedding=args.pos_embedding,
                max_seq_len=args.seq_len)


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


def build_tx(args, config=None):
    """The demo's optimizer (--lr-schedule + --grad-clip + weight decay
    on flax-rank >= 2 leaves + SGD/momentum) as an ``Sgd``. ``config``:
    the TransformerLM config the decay mask reads the flax ranks of
    (default: from the flags)."""
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
    shapes = convert.flax_shapes(config or lm_config(args))

    def decay_mask(name, _param):
        # The flax leaf's rank, not the torch tensor's: the attention
        # biases are [3, H, D] / [H, D] / [2, Hkv, D] there and decay.
        return len(shapes[name][1]) >= 2

    return Sgd(lr, momentum=args.momentum,
               weight_decay=args.weight_decay, decay_mask=decay_mask,
               grad_clip=args.grad_clip)


def build_lm(args, device):
    """(model, loss_fn): the port's TransformerLM with random weights
    from --seed (trainable, f32 parameters, bf16 compute) and the
    next-token loss (fused kernel, or the plain loss)."""
    config = lm_config(args)
    tree = convert.init_flax_layout_params(config, args.seed)
    model = convert.load_lm(config, tree, device=device, trainable=True)
    loss = functools.partial(
        mean_cross_entropy_loss if args.pallas_loss else cross_entropy_loss,
        label_smoothing=args.label_smoothing)
    return model, next_token_loss_fn(loss)


def build_trainer(args, device):
    """(trainer, state, loader) from the flags, after checking that
    they name the ported path and that ``device`` exists."""
    check_ported(args)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() "
                           "is False (pass --device cpu to run the plain "
                           "versions on the CPU)")
    model, loss_fn = build_lm(args, device)
    trainer = Trainer(model, loss_fn, build_tx(args))
    loader = SyntheticTokenLoader(args.batch_size, args.seq_len,
                                  args.vocab_size, device=device)
    return trainer, trainer.init_state(), loader


def kernel_launches():
    return {k.name: k.launches for k in attention.KERNELS + xent.KERNELS}


def main(argv=None, on_step=None):
    """Train and print the JSON result line; returns it as a dict.
    ``on_step(step, loss)``, if given, is called after every step with
    the step's loss as a device tensor (no host sync)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    trainer, state, loader = build_trainer(args, device)
    before = kernel_launches()
    losses = []
    warmup = max(args.warmup_steps, 0)
    t_start = time.perf_counter() if warmup == 0 else None
    for step, batch in zip(range(args.steps), loader):
        state, loss = trainer.train_step(state, batch)
        if on_step is not None:
            on_step(step, loss)
        if t_start is None and step == warmup - 1:
            wall_sync(loss)
            t_start = time.perf_counter()
        if step % 20 == 0 or step == args.steps - 1:
            loss_val = float(loss)
            losses.append(loss_val)
            print(f"step {step} loss {loss_val:.4f}", file=sys.stderr)
    wall_sync(state.model)
    t_end = time.perf_counter()
    timed_steps = max(args.steps - warmup, 0)
    if t_start is None or timed_steps == 0:
        seqs_per_sec = 0.0
    else:
        elapsed = t_end - t_start
        seqs_per_sec = (args.batch_size * timed_steps / elapsed
                        if elapsed > 0 else 0.0)
    after = kernel_launches()
    result = {
        "model": args.model,
        "depth": None,
        "devices": 1,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "global_batch": args.batch_size,
        "steps": args.steps,
        "images_per_sec": round(seqs_per_sec, 2),
        "images_per_sec_per_chip": round(seqs_per_sec, 2),
        "final_loss": losses[-1] if losses else None,
        "tokens_per_sec": round(seqs_per_sec * args.seq_len, 2),
        "kernel_launches": {name: after[name] - before[name]
                            for name in after},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

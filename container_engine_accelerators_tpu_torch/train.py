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
on one card.

    python -m container_engine_accelerators_tpu_torch.train \
        --model resnet --depth 50 --batch-size 128 --steps 12
    python -m container_engine_accelerators_tpu_torch.train \
        --model transformer --seq-len 2048 --batch-size 8 --steps 12

Counterpart of demo/tpu-training/train.py: the same flag names and
defaults (``--model`` defaults to resnet), plus ``--device`` (cuda
unless the caller asks for cpu; no fallback). Weights are random, made
from ``--seed`` with numpy in the flax layout (``models/convert.py``);
data is the synthetic image or token loader. The optimizer is the
demo's ``build_tx``: --grad-clip, weight decay on the leaves that are
rank >= 2 in the flax tree, SGD with momentum under one of three
--lr-schedule's. mnist and resnet train on the fused cross-entropy,
inception on the plain loss, as the demo does. --remat, --grad-accum,
--augment (image models; the LM ignores it with a message),
--ema-decay and --eval-batches (top-1/top-5 through the eval step)
follow the demo.

Prints the demo's JSON result line (model, depth, devices,
global_batch, steps, images_per_sec, images_per_sec_per_chip,
final_loss, tokens_per_sec for the LM, eval accuracies) with the
kernels' launch counts added. The flags of the demo's other paths
(moe, parallelism, checkpoints, profiles, real data, the attention
window) raise "not yet ported".
"""

import argparse
import functools
import json
import math
import os
import sys
import time

import torch

from .models import convert, mlp
from .models.inception import InceptionV3
from .models.resnet import resnet
from .models.transformer import next_token_loss_fn
from .ops import attention, xent
from .ops.augment import make_augment_fn
from .ops.xent import mean_cross_entropy_loss
from .parallel import (
    Sgd,
    SyntheticLoader,
    SyntheticTokenLoader,
    Trainer,
    cross_entropy_loss,
)
from .utils import not_ported, wall_sync

IMAGE_MODELS = ("mnist", "resnet", "inception")


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
    """Raise "not yet ported" for every flag of a path the port does
    not carry."""
    unported = {
        "--model moe": args.model == "moe",
        "--attention-window": args.attention_window > 0,
        "--expert-parallelism": args.expert_parallelism > 1,
        "--context-parallelism": args.context_parallelism > 1,
        "--attention ring/ulysses": args.attention != "flash",
        "--model-parallelism": args.model_parallelism > 1,
        "--pipeline-parallelism": args.pipeline_parallelism > 1,
        "--dcn-granules": args.dcn_granules > 1,
        "--fsdp": args.fsdp,
        "--data-dir": bool(args.data_dir),
        "--model-dir": bool(args.model_dir),
        "--profile-dir": bool(args.profile_dir),
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
    (default: from the flags). An image model's flax ranks are its
    torch ranks: conv and linear weights decay, BN and biases do
    not."""
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
        def decay_mask(_name, param):
            return param.dim() >= 2
    else:
        shapes = convert.flax_shapes(config or lm_config(args))

        def decay_mask(name, _param):
            # The flax leaf's rank, not the torch tensor's: the
            # attention biases are [3, H, D] / [H, D] / [2, Hkv, D]
            # there and decay.
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


def build_trainer(args, device):
    """(trainer, state, loader) from the flags, after checking that
    they name a ported path and that ``device`` exists."""
    check_ported(args)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() "
                           "is False (pass --device cpu to run the plain "
                           "versions on the CPU)")
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
        loader = SyntheticLoader(args.batch_size, shape, classes,
                                 device=device)
        if args.augment:
            augment_fn = make_augment_fn(flip=True,
                                         crop_padding=args.crop_padding)
    else:
        model, loss_fn = build_lm(args, device)
        loader = SyntheticTokenLoader(args.batch_size, args.seq_len,
                                      args.vocab_size, device=device)
        if args.augment:
            print("--augment only applies to image models; ignoring",
                  file=sys.stderr)
    trainer = Trainer(model, loss_fn, build_tx(args), remat=args.remat,
                      grad_accum=args.grad_accum, augment_fn=augment_fn,
                      ema_decay=args.ema_decay)
    return trainer, trainer.init_state(), loader


def kernel_launches():
    return {k.name: k.launches for k in attention.KERNELS + xent.KERNELS}


def evaluate(trainer, state, loader, args):
    """Top-1 and top-5 accuracy over --eval-batches through the eval
    step (next-token accuracy for the LM). The counts stay on the
    device until the end. Returns (top1, top5)."""
    correct = correct5 = None
    total = 0
    for _, (inputs, labels) in zip(range(args.eval_batches), loader):
        logits = trainer.eval_step(state, inputs)
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


def run(args, on_step=None):
    """Train as the flags say; returns (result dict, trainer, state).
    ``on_step(step, loss)``, if given, is called after every step with
    the step's loss as a device tensor (no host sync)."""
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
        per_sec = 0.0
    else:
        elapsed = t_end - t_start
        per_sec = (args.batch_size * timed_steps / elapsed
                   if elapsed > 0 else 0.0)
    after = kernel_launches()
    result = {
        "model": args.model,
        "depth": args.depth if args.model == "resnet" else None,
        "devices": 1,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "global_batch": args.batch_size,
        "steps": args.steps,
        "images_per_sec": round(per_sec, 2),
        "images_per_sec_per_chip": round(per_sec, 2),
        "final_loss": losses[-1] if losses else None,
    }
    if args.model not in IMAGE_MODELS:
        result["tokens_per_sec"] = round(per_sec * args.seq_len, 2)
    result["kernel_launches"] = {name: after[name] - before[name]
                                 for name in after}
    if args.eval_batches:
        top1, top5 = evaluate(trainer, state, loader, args)
        result["eval_accuracy"] = round(top1, 4)
        result["eval_top5_accuracy"] = round(top5, 4)
        print(f"eval accuracy top1 {result['eval_accuracy']} "
              f"top5 {result['eval_top5_accuracy']}", file=sys.stderr)
    return result, trainer, state


def main(argv=None, on_step=None):
    """Train and print the JSON result line; returns it as a dict.
    ``on_step`` as in ``run``."""
    result, _, _ = run(parse_args(argv), on_step)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

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


"""Where a training step's device time goes, by torch.profiler.

    python -m container_engine_accelerators_tpu_torch.train_profile \
        [train.py flags...]

Builds the trainer as ``train.py`` does (same flags and defaults;
``--steps`` is the number of profiled steps, after ``--warmup-steps``
unprofiled ones), times as many steps without the profiler, profiles
the steps with torch.profiler (CPU and CUDA activity), and prints one
JSON line: the window's wall time beside the unprofiled steps' (host
clock around synced work; the gap is the profiler's host cost), the
device's busy time (the sum of kernel times; one stream, so kernels do
not overlap) and idle share, and kernel time per step by category
(cuDNN's convolutions, the port's five kernels by name, matrix
products, elementwise, reductions, copies, other) with the top kernels
by time. Any model of the driver: ``--model resnet`` (the default)
profiles the image step, whose BatchNorm is plain PyTorch and lands in
the reductions (its statistics) and elementwise work (its
normalisation, beside ReLU, the residual adds and the SGD update);
``--model transformer`` the LM's. Details go to
chiprun_out/train_profile.json. Runs on the card; it fails if the
profiler records no device time.
"""

import json
import os
import sys
import time

import torch

from . import train

_CATEGORIES = (
    # cuDNN's convolutions (forward, data and weight gradients) and
    # their layout transforms come before the products: both have
    # sm90_/xmma in their names.
    ("convolution", ("fprop", "dgrad", "wgrad", "implicit_convolve",
                     "conv2d", "convolve", "nchwToNhwc", "nhwcToNchw",
                     "cudnn")),
    ("flash_fwd", ("flash_fwd_tc_kernel", "flash_fwd_f32_kernel")),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel", "flash_bwd_dq_tc_kernel")),
    ("flash_bwd_dkv", ("flash_bwd_dkv_kernel", "flash_bwd_dkv_tc_kernel")),
    ("xent_fwd", ("xent_fwd_kernel",)),
    ("xent_bwd", ("xent_bwd_kernel",)),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "splitK")),
    ("reduction", ("reduce", "Reduce", "norm", "softmax")),
    ("copy", ("copy", "Copy", "Memcpy", "Memset", "cat_", "Cat")),
    ("elementwise", ("elementwise", "Elementwise", "vectorized")),
)


def category(name):
    for label, needles in _CATEGORIES:
        if any(n in name for n in needles):
            return label
    return "other"


def device_kernels(prof):
    """{kernel name: (total µs, count)} of the CUDA kernels the
    profiler recorded."""
    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(evt, "self_device_time_total", None)
              or getattr(evt, "self_cuda_time_total", 0))
        if us > 0:
            out[evt.key] = (us, evt.count)
    return out


def main(argv=None):
    args = train.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda":
        raise RuntimeError("train_profile runs on the card (--device cuda)")
    trainer, state, loader = train.build_trainer(args, device)
    for _ in range(max(args.warmup_steps, 1)):
        state, loss = trainer.train_step(state, next(loader))
    torch.cuda.synchronize()
    # The same number of steps without the profiler: its per-operation
    # host cost can leave the device idle where the plain run does not.
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, loss = trainer.train_step(state, next(loader))
    torch.cuda.synchronize()
    unprofiled_ms = 1e3 * (time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, loss = trainer.train_step(state, next(loader))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    if args.model in train.IMAGE_MODELS:
        shape = {"image_size": args.image_size,
                 "depth": args.depth if args.model == "resnet" else None}
    else:
        shape = {"seq_len": args.seq_len}
    kernels = device_kernels(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy_ms = sum(us for us, _ in kernels.values()) / 1e3
    per_step = {}
    for name, (us, _) in kernels.items():
        label = category(name)
        per_step[label] = per_step.get(label, 0.0) + us / 1e3 / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "device": torch.cuda.get_device_name(device),
        "model": args.model, "steps": args.steps,
        "global_batch": args.batch_size,
        **shape,
        "wall_ms_per_step": wall_ms / args.steps,
        "wall_ms_per_step_unprofiled": unprofiled_ms / args.steps,
        "busy_ms_per_step": busy_ms / args.steps,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "ms_per_step_by_category": dict(sorted(
            per_step.items(), key=lambda kv: -kv[1])),
        "final_loss": float(loss),
        "top_kernels": [{"name": name[:120], "ms_per_step":
                         us / 1e3 / args.steps, "calls": count}
                        for name, (us, count) in top],
    }
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "train_profile.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k != "top_kernels"}))
    for row in result["top_kernels"]:
        print(json.dumps(row), file=sys.stderr)
    return result


if __name__ == "__main__":
    main()

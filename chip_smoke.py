#!/usr/bin/env python3
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

"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (name, count, power limit);
2. builds every CUDA kernel of the port from ops/csrc (one nvcc per
   source, all at once) and reads each kernel's registers and spills
   from ``-Xptxas -v``: a tensor-core kernel (the Hopper wgmma kernels
   included) must not spill, and ptxas must neither serialize a wgmma
   ("Potential Performance Loss") nor ignore a setmaxnreg;
3. holds each kernel against its plain PyTorch version on the card
   (flash forward, dQ, dK/dV, cross-entropy forward and backward; the
   cross-entropy gradient element by element, scaled by its mean):
   the bf16 flash forward, dQ and dK/dV (Hopper kernels: wgmma, TMA)
   at head dims 16, 40, 64 and 128, lengths 17 and 1000, the window
   band, B 1 at S 1920, grids with one and with several consumer
   warpgroups a block, and on q/k/v/dO rows that do not start on 16
   bytes (the mma.sync kernels, ``attention.tma_rows``); launches the
   three tensor-core kernels (bf16 flash forward, dQ, dK/dV) twice on
   the same inputs at the training and the serving prefill's shapes
   and requires bitwise-equal outputs; and counts the tensor-core
   instructions in their SASS (cuobjdump): HMMA or HGMMA in every
   ``*_tc_kernel``, HGMMA in each wgmma kernel, and all three wgmma
   kernels present;
4. times each kernel at its path's shapes beside its bound, its plain
   version and one PyTorch library call (flash forward at the serving
   prefill widths, at the demo draft's D 16 and at the training shape;
   the backward and the cross-entropy at the training shapes, the
   cross-entropy also at ResNet-50's logits), the flash kernels by
   CUDA-graph replay (device time; ``launch_ms`` launched back to back)
   beside the mma.sync design's time where one was taken
   (``MMA_SYNC_MS``), and the next-token objective's logits copy
   alone;
5. serves the full-width LM (the architecture of
   demo/serving/lm-serving.yaml without its int8 options: vocab 32000,
   E 512, 8 layers, 8 heads, 2 KV heads, rope, max_seq_len 2048; bf16,
   random weights from a seed) through the port's GenerationServer on
   a localhost port, on the dense pool (``CEA_TPU_PAGED_KV=0`` while
   the server is built): greedy requests in several buckets,
   concurrent requests that batch in the slots, one sampled request.
   Every greedy response must equal greedy_decode on the same prompt,
   and the flash kernel must have launched once per layer per
   admission;
6. times the engine's admission prefill at four bucket widths and one
   decode step with every slot active (host clock around synced work);
   then serves the same model on the paged pool, the server's default
   (slot_len 2048, block 16: 1024 usable blocks and the trash block):
   a 1000-token system prompt, 8 concurrent requests of that prefix
   and a 3-30-token suffix, 4 cold prompts, the prefix again once
   every row is released (a revival). /stats must say "paged" with at
   least 8 prefix hits, every hit row admits at a width of at most 32,
   no flash kernel launches (the paged prefill attends the cache, as
   the JAX engine's does), and the pool is clean when the server is
   idle. Each greedy stream must equal greedy_decode's or first differ
   where the oracle's top two logits lie within 2e-2 of its largest
   logit (the bf16 limit: the paged prefill rounds at other points than
   the flash prefill). An engine with a small arena spills the prefix
   to the host tier and rehydrates it bitwise. Informational: a decode
   step with 8 rows on the paged and the dense pool, the admission of
   a 1003-token prompt cold and on a prefix hit, the rehydrate. Then
   the deployment phase: demo/serving/lm-serving.yaml's command line
   as written (int8 KV cache, int8 weights, byte tokenizer, --warm),
   with --port=0 added, through the port's launcher. /healthz must
   answer 503 first and 200 once warm-up is done; text, token-id and
   ndjson-stream requests (the stream equal to the same request
   unstreamed) and the demo's load generator, plain and --stream, are
   served with no kernel launch and the pool clean after; each greedy
   stream equals greedy_decode on the int8 model or first differs at a
   near tie (the rule above). The same command line on the dense pool
   (CEA_TPU_PAGED_KV=0): 8 flash launches an admission and every
   greedy response equal to greedy_decode. Reported: arena bytes and
   usable blocks (the deployed pool, and at equal memory in bf16, int8
   and int4), projection weight bytes, an engine-level int4 run, and
   in turns the paged step (bf16, int8 cache, the deployment), the
   dense admission (bf16 against int8) and one projection at decode
   width (Int8Linear against the bf16 Linear);
7. trains the same architecture at full width and depth (f32
   parameters, bf16 compute, f32 logits, sequence 2048, the demo
   driver's SGD defaults; global batch 8, cut from 256) for 12 steps
   through the driver's ``run`` (what ``python -m
   container_engine_accelerators_tpu_torch.train`` runs before it
   prints its result line): every loss finite, the last below the
   first, exactly 8 flash_fwd, 8 dQ, 8 dK/dV, 1 cross-entropy
   forward and 1 backward launch per step,
   and the driver's JSON result in agreement; then one batch-2 step
   held against the same step through the plain versions (plain
   attention_fn and plain loss): loss and every gradient's relative
   L2 error;
8. trains the image models through the same driver: ResNet-50 at full
   width (224x224x3, 1000 classes, bf16 compute, f32 parameters and
   logits, batch 128, bench.py's configuration) for 12 steps: every
   loss finite, the last below the first, exactly 1 cross-entropy
   forward and 1 backward launch a step and no attention launch, every
   BN's running statistics moved, the eval step's logits finite; then
   one step through the fused loss held against the same step through
   the plain loss (and against itself, bitwise or not, reported);
   MNIST at the demo's shapes (28x28x1, 10 classes, batch 256) for a
   few steps with the same launch counts; Inception-v3 at 299x299,
   batch 32, 3 steps on the plain loss (no kernel launch). Phases 3
   and 4 also hold and time the cross-entropy kernels at the image
   logits' shapes ([128, 1000] and [256, 10] f32);
9. runs phase 5-7's architecture with a sliding window of W 512: (a)
   6 training steps through ``train.run`` with ``--attention-window 512``
   (sequence 2048, batch 8: 8/8/8/1/1 launches a step, the loss falls)
   and one batch-2 step against the plain step with the band (phase
   7's limits); on the same weights and tokens, the windowed logits
   equal the causal model's before position 512 (bf16 limit) and
   differ after it; (b) ``decode()`` on the ring (prompts of 1500 and
   16 tokens, 128 new tokens each): 8 flash_fwd launches a call, ring
   leaves of [1, 512, 2, 64], every greedy token the argmax of one
   cache-free windowed forward over the generated sequence or at a
   near tie (PERF.md §2's 2e-2 rule), ``stream_decode`` (chunks of 16)
   and ``beam_search(num_beams=1)`` equal to decode() or held to the
   same rule; (c) ``serve.py --attention-window 512`` on the paged
   pool (2 short and 4 long requests of up to 1500 tokens, concurrent)
   and on the dense pool (4 requests): no kernel launch, each greedy
   stream equal to decode() on the ring (greedy_decode, on the ring
   too) or first differing at a near tie, the pool clean when idle;
   (d) informational: the three flash kernels at [8, 2048, 8, 64] with
   the band beside their bounds and SDPA with the band as a boolean
   mask, the ring's KV bytes a row against the full-length cache, and
   a decode step on each;
10. runs speculation at full width, k 4, with two drafts: the demo
   launcher's default (2 layers, E 128, the target's 8 heads, MHA,
   rope, seed 1) and the target itself (a self-draft). (a)
   ``speculative_decode`` on prompts of 1500 and 16 tokens, 128 new
   tokens each: 16 flash_fwd launches a self-draft call and 10 a
   demo-draft call (the two one-shot prefills) and nothing else; each
   greedy stream equal to greedy_decode's or first differing at a near
   tie (PERF.md §2's 2e-2 rule); self-draft acceptance at least 0.9;
   one sampled call finite and reproducible from its generator; the
   windowed target (W 512) with its self-draft on rings of [1, 516, 2,
   64] under the same rule; (b) ``serve.py --speculative-k 4`` (the
   demo draft) on the paged pool, 6 concurrent greedy requests and 1
   sampled: exactly 2 flash_fwd launches a greedy admission (the
   draft's prefill) and 0 for the sampled one, the streams under the
   rule, /stats with the speculation fields, pool and draft arena
   clean when idle; the same flags on the dense pool, 10 launches a
   greedy admission; an engine with the self-draft driven directly,
   its acceptance at least 0.5 (the JAX tool's floor); (c)
   informational: a decode step with 8 rows plain, with the demo draft
   and with the self-draft, tokens committed a step, the draft arena's
   bytes;
11. runs the serving contract: (a) demo/serving/jax-serving.yaml's
   command line (``--model-name=resnet --port=8500``, ``--port=0``
   added) through the port's launcher in its own process: the default
   model, ResNet-50 v1.5 at 224x224x3 (bf16, seed 0, eval mode,
   micro-batches padded to 8); /readyz 200; 8 instances in one request
   and 8 one-instance requests at once must return the classes of the
   same ResNet-50's eval forward run here on the same batch (or differ
   at a near tie, the 2e-2 rule) and scores within 2e-2;
   informational p50 latency at 1 and 8 images, images/s; exit 0 on
   SIGTERM. (b) a fault drill on the dense and the paged pool of the
   GenerationServer: ``CEA_TPU_FAULT_PLAN`` {"step": [8]}, then
   {"prefill": [3]}, with 6 concurrent greedy requests of 16-1500
   tokens: each plan exactly one quarantine, naming an InjectedFault
   (any other error fails the phase), and one rebuild; every stream
   equal to greedy_decode's or first differing at a near tie; 8
   flash_fwd launches a replay admission on the dense pool, 0 on the
   paged pool; the pool clean. (c) SIGTERM to a launcher process (the
   LM) with 3 streams in flight: /readyz 503 {"state": "draining"}, a
   new POST 503 with Retry-After, the streams finish, exit 0. (d)
   ``--system-prefix-ids`` with 1000 ids, alone and with
   ``--speculative-k 4``: 4 prefix hits each, suffix streams against
   greedy_decode over prefix + suffix (the near-tie rule), no launch
   alone and 2 a greedy draft admission with speculation. (e) on the
   first prefix server: /metrics with the TTFT buckets,
   /debug/requests records summing to their wall time, and a request
   sent with a traceparent and a request id lands in one
   ``serving.request`` span under that trace, with the id in its
   ledger record.
12. runs the fleet front door: lm-serving.yaml's architecture in two
   launcher processes (started before phase 11, warmed up while it
   runs) behind the port's FleetCollector and RouterServer: A on the
   paged pool (deploy/fleet/engine.yaml's), B on the dense pool
   (``CEA_TPU_PAGED_KV=0``). (a) 8 greedy streams of 128 tokens through
   the router, 4 of 16-1000 tokens and 4 on a shared 1000-token prefix
   whose first request is pinned to A and whose repeats land there by
   affinity (``tpu_router_routed_total{reason="affinity"}``); every
   stream equal to greedy_decode's or first differing at a near tie.
   (b) SIGKILL A with at least 2 of the repeats mid-flight: every
   stream completes through the router, each spliced tail equals B's
   direct answer for prompt + the tokens delivered before the kill
   (exact), the failover counter moves, and B's flash_fwd launches
   grow by 8 a splice admission (kernel #1 on the fleet path). (c) B
   quiesces with its slots free and every admitted request retired.
   (d) each spliced journey is one router record with one trace id,
   under which B's ``serving.request`` span for the resubmit parents.
   (e) SIGUSR1 drains B: the router's /readyz turns 503 and new work
   gets 503 with Retry-After. The ``fleet:`` line holds each stream's
   first divergence, the splices, #1's launches, the router overhead
   (its own buckets of a splice-free journey) and the phase's seconds.

Where a training step's device time goes is measured by
``container_engine_accelerators_tpu_torch.train_profile`` (a
torch.profiler trace), not here.

Any failure exits nonzero. Without a CUDA device it exits 2 before
printing any result. The last three lines of output are the
``{"kernels": [...]}`` line, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO_ROOT, "chiprun_out")

# One full-width model the repo serves (demo/serving/lm-serving.yaml).
MODEL = dict(vocab_size=32000, embed_dim=512, num_layers=8, num_heads=8,
             num_kv_heads=2, pos_embedding="rope", max_seq_len=2048)
MAX_NEW = 128
MAX_BATCH = 8
SEED = 0
# The paged phase: a 1000-token system prompt (62 full blocks of 16 and
# 8 tokens, so the boundary block forks) and 64 new tokens a request.
PAGED_PREFIX = 1000
PAGED_NEW = 64
PAGED_COLD = (100, 700)   # cold prompt lengths
# The deployment phase: demo/serving/lm-serving.yaml's command line as
# written, through the port's launcher, with --port=0 added.
MANIFEST = os.path.join(REPO_ROOT, "demo", "serving", "lm-serving.yaml")
DEPLOY_NEW = 32                      # new tokens a greedy request
DEPLOY_PROMPTS = (16, 100, 700, 1500)
PREFILL_WIDTHS = (16, 128, 1024, 1920)   # timed admission widths
# The training slice: sequence 2048 at global batch 8 (the demo
# driver's default batch, 256, cut to keep the run short).
TRAIN_SEQ = 2048
TRAIN_BATCH = 8
TRAIN_STEPS = 12
TRAIN_WARMUP = 2
PLAIN_BATCH = 2  # the plain attention's [B, H, S, S] f32 scores fit
# The window phase (9): the same architecture with a sliding window of
# W 512, a quarter of the context. No public configuration of this
# architecture fixes a width; at 512 the serving buckets 1024 and 1920
# wrap the ring while 16 and 128 do not, and at S 2048 the band keeps
# 917 760 of the 2 098 176 causal pairs, so the kernels skip tiles.
WINDOW = 512
WINDOW_STEPS = 6
WINDOW_WARMUP = 2
WINDOW_PROMPTS = (1500, 16)        # decode() on the ring
WINDOW_SERVE = (16, 100, 1024, 1200, 1350, 1500)   # 2 short, 4 long
WINDOW_DENSE = (16, 100, 1024, 1500)
WINDOW_NEW = 32
WINDOW_STEP_POS = 1600             # the timed decode step's position
# The speculation phase (10): k 4; the demo launcher's default draft
# (demo/serving/serve.py: 2 layers, E 128, the target's heads, MHA,
# rope, the target's vocab and max_seq_len; seed SEED + 1 as the port's
# launcher makes it) and the self-draft.
SPEC_K = 4
SPEC_DRAFT = dict(MODEL, embed_dim=128, num_layers=2, num_kv_heads=None)
SPEC_PROMPTS = (1500, 16)
SPEC_SERVE = (16, 64, 100, 300, 700, 1500)     # concurrent greedy
SPEC_DENSE = (16, 100, 700, 1500)
SPEC_ENGINE = (16, 32, 64, 100, 200, 300, 500, 700)
SPEC_ENGINE_NEW = 64
SPEC_NEW = 32
SPEC_ACCEPT_SINGLE = 0.9   # single-request self-draft: no draft holes
SPEC_ACCEPT_ENGINE = 0.5   # tools/bench_serving_occupancy.py's floor
# The serving-contract phase (11): demo/serving/jax-serving.yaml's
# predict server (ResNet-50 at 224x224x3, the launcher's --max-batch 8);
# a fault drill of 6 concurrent greedy requests of 16-1500 tokens on
# both pools under a step plan and a prefill plan (the step fault lands
# mid-stream, the prefill fault on the fourth admission); drain; a
# 1000-id system prefix with 4 suffixes of 3-500 tokens.
PREDICT_MANIFEST = os.path.join(REPO_ROOT, "demo", "serving",
                                "jax-serving.yaml")
PREDICT_DEPTH = 50
PREDICT_BATCH = 8
DRILL_LENGTHS = (16, 64, 300, 700, 1000, 1500)
DRILL_NEW = 24
DRILL_PLANS = ({"step": [8]}, {"prefill": [3]})
PREFIX_IDS = 1000
PREFIX_SUFFIXES = (3, 30, 200, 500)
DRAIN_PROMPTS = (16, 100, 700)     # streams in flight at SIGTERM
# The kernel step against the plain step: loss within 1e-3 relative,
# each gradient within 5e-2 relative L2. Both steps compute in bf16
# with f32 sums but round at different points (the flash forward's
# online softmax against one dense softmax, the fused cross-entropy's
# gradient against log_softmax's), so single values differ by a bf16
# unit (2**-8) here and there, and the differences grow through 8
# layers of backward: on the card the worst gradient sits near 2%
# (the last layer's q projection, whose gradient is small) and the
# median near 0.7%. A wrong mask or tile bound moves a gradient by
# O(1).
STEP_LOSS_TOL = 1e-3
STEP_GRAD_TOL = 5e-2

# The image slice (phase 8): bench.py's ResNet-50 at full width, the
# demo driver's MNIST, Inception-v3 at its 299 input with the batch
# cut from 256 to 32 and 3 steps to keep the phase short.
RESNET_BATCH = 128
RESNET_SIZE = 224
RESNET_CLASSES = 1000
RESNET_STEPS = 12
RESNET_WARMUP = 2
MNIST_BATCH = 256
MNIST_STEPS = 5
INCEPTION_BATCH = 32
INCEPTION_STEPS = 3
# The fused-loss step against the plain-loss step, same weights and
# batch: the forward is the same cuDNN work on the same inputs, so the
# logits agree and the two losses differ only in the f32 summation
# order of 1000-class rows (a few f32 units): 1e-5 relative. The
# gradients enter the bf16 backward from dlogits that differ by f32
# units, so a bf16 rounding flips here and there and cuDNN's backward
# algorithms may sum in another order; each gradient within 5e-2
# relative L2, as the LM step (a wrong softmax or label moves them by
# O(1)).
IMAGE_LOSS_TOL = 1e-5
IMAGE_GRAD_TOL = 5e-2

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by
# input type (bf16 on the tensor cores, f32 outside them).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
TOL = {"torch.bfloat16": 2e-2, "torch.float32": 1e-4}


def log(*args):
    print(*args, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean time of ``fn`` on the card by CUDA events, after warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, reps=5):
    """Mean device time of ``fn`` by CUDA events around replays of a
    CUDA graph of ``iters`` calls: the kernels' own time, without the
    host's launch cost (which bounds back-to-back calls at small
    shapes)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound_ms(nbytes, flops, dtype):
    """The least time for ``nbytes`` of memory traffic and ``flops``
    operations of input type ``dtype``: (ms, "bytes"|"operations")."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def kept_pairs(s, causal, window):
    """(query, key) pairs the masks keep in one head."""
    if causal and window:
        return sum(min(i + 1, window) for i in range(s))
    if causal:
        return s * (s + 1) // 2
    return s * s


def attention_bound_ms(b, s, h, d, dtype, causal, window, role="fwd"):
    """Least time for one flash kernel's work on these inputs. Bytes:
    each input read once, each output written once (fwd: q, k, v in,
    o and lse out; dq: q, k, v, dO, lse, delta in, dQ out; dkv: the
    same in, dK and dV out). Operations over the kept score pairs:
    fwd QK^T and PV (4*D a pair), dq also dO.V^T (6*D), dkv also the
    dV and dK products (8*D); against the input type's peak."""
    item = 2 if dtype == "torch.bfloat16" else 4
    tensor = b * s * h * d * item
    rows = b * s * h * 4
    nbytes, per_pair = {
        "fwd": (4 * tensor + rows, 4),
        "dq": (5 * tensor + 2 * rows, 6),
        "dkv": (6 * tensor + 2 * rows, 8),
    }[role]
    flops = per_pair * d * b * h * kept_pairs(s, causal, window)
    return bound_ms(nbytes, flops, dtype)


def xent_bound_ms(n, c, role):
    """Least time for the cross-entropy kernels on f32 logits [n, c]
    with int64 labels: fwd reads logits and labels and writes the
    loss; bwd also reads g and writes dlogits. About 4 (fwd) and 6
    (bwd) f32 operations per logit against the f32 peak."""
    if role == "fwd":
        return bound_ms(n * c * 4 + n * 8 + n * 4, 4 * n * c,
                        "torch.float32")
    return bound_ms(2 * n * c * 4 + n * 8 + n * 4, 6 * n * c,
                    "torch.float32")


def attn_operands(torch, shape, dtype, n, gen, misaligned=False):
    """n random [B, S, H, D] operands. misaligned: slices of one fused
    [B, S, n*H*D + 1] projection starting one element in, so no row
    starts on 16 bytes (the kernels' narrow-load staging)."""
    if not misaligned:
        return [torch.randn(shape, generator=gen, device="cuda",
                            dtype=dtype) for _ in range(n)]
    b, s, h, d = shape
    fused = torch.randn((b, s, n * h * d + 1), generator=gen,
                        device="cuda", dtype=dtype)
    return [fused[:, :, 1 + i * h * d:1 + (i + 1) * h * d].unflatten(
        -1, (h, d)) for i in range(n)]


# Phase 3's attention cases: (shape, dtype, causal, window, misaligned
# rows). bf16 runs the Hopper forward, dQ and dK/dV (wgmma, TMA): head
# dims 16 (the demo draft's), 40 (not a multiple of 16), 64 and 128;
# lengths 17 and 1000 (not multiples of a tile); the window band; one
# and two consumer warpgroups a block (the grid's 128-row tiles below
# and above the card's 132 SMs); and rows that do not start on 16
# bytes, which take the mma.sync forward, dQ and dK/dV
# (``attention.tma_rows``). f32 runs the FMA kernels.
BF16_TC_CASES = [((2, 333, 4, 128), "bfloat16", True, 0, False),
                 ((2, 200, 4, 40), "bfloat16", False, 0, False),
                 ((1, 300, 4, 64), "bfloat16", True, 64, False),
                 ((2, 150, 4, 64), "bfloat16", True, 0, True),
                 ((2, 17, 8, 16), "bfloat16", True, 0, False),
                 ((1, 1920, 8, 16), "bfloat16", True, 0, False),
                 ((2, 1000, 4, 40), "bfloat16", True, 0, False),
                 ((1, 1000, 8, 64), "bfloat16", True, 512, False),
                 ((4, 1000, 8, 128), "bfloat16", True, 256, False),
                 ((8, 512, 8, 64), "bfloat16", False, 0, False),
                 ((2, 150, 4, 128), "bfloat16", True, 64, True)]

# The bf16 forward's, dQ's and dK/dV's times on the mma.sync design
# the Hopper kernels replaced (the same measurement on one NVIDIA H100
# 80GB HBM3 at 700 W), printed beside the new times: {(name, shape,
# window): ms}.
MMA_SYNC_MS = {("flash_fwd", (8, 2048, 8, 64), 0): 0.1949,
               ("flash_bwd_dkv", (8, 2048, 8, 64), 0): 0.4184,
               ("flash_bwd_dq", (8, 2048, 8, 64), 0): 0.2753,
               ("flash_fwd", (8, 2048, 8, 64), 512): 0.1137,
               ("flash_bwd_dkv", (8, 2048, 8, 64), 512): 0.2284,
               ("flash_bwd_dq", (8, 2048, 8, 64), 512): 0.1481,
               ("flash_fwd", (1, 1920, 8, 64), 0): 0.0460}


def check_flash(torch, attn):
    """Phase 3: the kernel against the plain version, O and lse."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [((1, s, 8, 64), "bfloat16", True, 0, False)
             for s in (16, 200, 512, 1920)]
    cases += [((2, 200, 4, 32), "float32", False, 0, False),
              ((1, 300, 4, 64), "float32", True, 64, False),
              ((1, 1920, 8, 64), "bfloat16", True, 256, False)]
    cases += BF16_TC_CASES
    results = []
    for shape, dtype, causal, window, misaligned in cases:
        dtype = getattr(torch, dtype)
        q, k, v = attn_operands(torch, shape, dtype, 3, gen, misaligned)
        o, lse = attn.flash_attention_lse(q, k, v, causal=causal,
                                          window=window or None)
        torch.cuda.synchronize()
        ro, rl = attn.flash_attention_reference(q, k, v, causal, window)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        tol = TOL[str(dtype)]
        case = dict(shape=list(shape), dtype=str(dtype), causal=causal,
                    window=window, rows_aligned=attn.rows_aligned(q, k, v),
                    tma_rows=attn.tma_rows(q, k, v),
                    err_o=err_o, err_lse=err_l, tol=tol)
        log("flash check", json.dumps(case))
        if not (err_o <= tol and err_l <= tol):
            raise AssertionError(f"flash kernel disagrees: {case}")
        results.append(case)
    return results


def time_flash(torch, attn, widths, d=None):
    """Phase 4: kernel, plain version and SDPA at the path shapes
    (head dim ``d``, the target's by default), each beside the
    mma.sync kernel's time where one was taken."""
    import torch.nn.functional as F
    heads = MODEL["num_heads"]
    d = d or MODEL["embed_dim"] // heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for s in widths:
        q, k, v = (torch.randn((1, s, heads, d), generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 200 if s <= 512 else 50
        row = dict(shape=[1, s, heads, d], dtype="torch.bfloat16",
                   timing="graph")
        row["kernel_ms"] = graph_ms(
            lambda: attn.flash_fwd.launch(q, k, v, True, 0), 20)
        row["launch_ms"] = cuda_ms(
            lambda: attn.flash_fwd.launch(q, k, v, True, 0), iters)
        row["plain_ms"] = cuda_ms(
            lambda: attn.flash_attention_reference(q, k, v, True, 0),
            max(10, iters // 10))
        row["library_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True), 20)
        o, _ = attn.flash_fwd.launch(q, k, v, True, 0)
        ro, _ = attn.flash_attention_reference(q, k, v, True, 0)
        row["max_abs_err"] = (o.float() - ro.float()).abs().max().item()
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            1, s, heads, d, "torch.bfloat16", True, 0)
        row["mma_sync_ms"] = MMA_SYNC_MS.get(("flash_fwd", (1, s, heads, d),
                                              0))
        log("flash time", json.dumps(row))
        rows.append(row)
    return rows


def near(got, want, dtype):
    """(max abs error, tolerance): bf16 2e-2 of the reference's largest
    magnitude (outputs rounded to 8 bits); f32 1e-4, relative once the
    values exceed 1 (summation order)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = TOL[dtype] * (scale if dtype == "torch.bfloat16"
                        else max(1.0, scale))
    return err, tol


def bwd_inputs(torch, attn, shape, dtype, causal, window, gen, lse_grad,
               misaligned=False):
    """q, k, v, dO, and the lse/delta the backward kernels take
    (delta = rowsum(dO * O) - g_lse, from the plain forward)."""
    q, k, v, do = attn_operands(torch, shape, dtype, 4, gen, misaligned)
    o, lse = attn.flash_attention_reference(q, k, v, causal, window)
    delta = (do.float() * o.float()).sum(-1)
    if lse_grad:
        delta = delta - torch.randn(shape[:3], generator=gen,
                                    device="cuda")
    return q, k, v, do, lse, delta


def check_backward(torch, attn):
    """Phase 3: dQ and dK/dV against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = [((1, s, 8, 64), "bfloat16", True, 0, False, s == 200)
             for s in (16, 200, 512, 2048)]
    cases += [((2, 200, 4, 32), "float32", False, 0, False, False),
              ((1, 300, 4, 64), "float32", True, 64, False, True),
              ((1, 2048, 8, 64), "bfloat16", True, 256, False, False)]
    cases += [case + (True,) for case in BF16_TC_CASES]
    results = []
    for shape, dtype, causal, window, misaligned, lse_grad in cases:
        dtype = getattr(torch, dtype)
        args = bwd_inputs(torch, attn, shape, dtype, causal, window, gen,
                          lse_grad, misaligned)
        dq = attn.flash_bwd_dq(*args, causal, window)
        dk, dv = attn.flash_bwd_dkv(*args, causal, window)
        torch.cuda.synchronize()
        rq = attn.flash_attention_dq_reference(*args, causal, window)
        rk, rv = attn.flash_attention_dkv_reference(*args, causal, window)
        case = dict(shape=list(shape), dtype=str(dtype), causal=causal,
                    window=window, rows_aligned=attn.rows_aligned(*args[:4]),
                    tma_rows=attn.tma_rows(*args[:4]),
                    lse_cotangent=lse_grad)
        ok = True
        for name, got, want in (("dq", dq, rq), ("dk", dk, rk),
                                ("dv", dv, rv)):
            err, tol = near(got, want, str(dtype))
            case[f"err_{name}"], case[f"tol_{name}"] = err, tol
            ok = ok and err <= tol
        log("flash bwd check", json.dumps(case))
        if not ok:
            raise AssertionError(f"flash backward kernel disagrees: {case}")
        results.append(case)
    return results


def check_repeat(torch, attn):
    """Phase 3: the tensor-core kernels (bf16 flash forward, dQ, dK/dV)
    at the training shape (two consumer warpgroups a block) and at the
    serving prefill's [1, 1920, 8, 64] (one), launched twice on the
    same inputs, give bitwise-equal outputs (each output tile has one
    owner block and there are no atomics)."""
    heads, d = MODEL["num_heads"], MODEL["embed_dim"] // MODEL["num_heads"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    out = {}
    for shape in ((TRAIN_BATCH, TRAIN_SEQ, heads, d), (1, 1920, heads, d)):
        args = bwd_inputs(torch, attn, shape, torch.bfloat16, True, 0, gen,
                          True)
        for name, run in (
                ("flash_fwd",
                 lambda: attn.flash_fwd.launch(*args[:3], True, 0)),
                ("flash_bwd_dq",
                 lambda: attn.flash_bwd_dq.launch(*args, True, 0)),
                ("flash_bwd_dkv",
                 lambda: attn.flash_bwd_dkv.launch(*args, True, 0))):
            first, second = run(), run()
            torch.cuda.synchronize()
            out[f"{name} {list(shape)}"] = all(
                torch.equal(a, b) for a, b in zip(first, second))
    log("bitwise repeat:", json.dumps(out))
    if not all(out.values()):
        raise AssertionError(f"two launches on the same inputs differ: {out}")
    return out


def kernel_key(symbol):
    """A kernel's short name from its mangled or demangled symbol:
    "flash_bwd_dq_tc_kernel<64>", "flash_fwd_wgmma_tc_kernel<64,2>",
    "xent_fwd_kernel f32"; None for a function that is not one of the
    port's kernels."""
    # Mangled: ...22flash_bwd_dq_tc_kernelILi64EE...,
    # ...25flash_fwd_wgmma_tc_kernelILi64ELi2EE...; demangled:
    # ...::flash_bwd_dq_tc_kernel<64>(...), <64, 2>.
    name = re.search(r"(?:\d|::)((?:flash|xent)_\w+?_kernel)", symbol)
    if name is None:
        return None
    key = name.group(1)
    args = re.search(r"I((?:Li\d+E)+)E|<(\d+(?:, *\d+)*)>", symbol)
    if args:
        ints = re.findall(r"\d+", args.group(1).replace("Li", " ")
                          if args.group(1) else args.group(2))
        key += f"<{','.join(ints)}>"
    if "bfloat16" in symbol:
        key += " bf16"
    elif "kernelIf" in symbol or "<float" in symbol:
        key += " f32"
    return key


def ptxas_report(compiler):
    """Registers and spilled bytes of each kernel from the build's
    ``-Xptxas -v`` output: {"flash_bwd_dq_tc_kernel<64>": {"registers":
    n, "spill_bytes": n}, ...} (a library that was already built has
    no output and adds nothing). Fails if a tensor-core kernel
    (``*_tc_kernel``, the wgmma kernels included) spills, if ptxas
    serialized wgmma instructions ("Potential Performance Loss") or
    ignored a setmaxnreg, or if a flash library was compiled and none
    of its tensor-core kernels is in the output."""
    report = {}
    serialized, ignored = [], []
    for lib, text in sorted(compiler.items()):
        key = None
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                key = kernel_key(entry.group(1))
                if key:
                    report[key] = {}
                continue
            serial = re.search(r"wgmma\.mma_async instructions are "
                               r"serialized.*?'(\w+)'", line)
            if serial or "wgmma.mma_async instructions are serialized" in line:
                where = kernel_key(serial.group(1)) if serial else key
                serialized.append(f"{where}: {line.strip()}")
            if "setmaxnreg ignored" in line:
                ignored.append(f"{key}: {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if key and spill:
                report[key]["spill_bytes"] = (int(spill.group(1))
                                              + int(spill.group(2)))
            if key and regs:
                report[key]["registers"] = int(regs.group(1))
        if text and lib.startswith("flash") and not any(
                k.startswith(lib) and "_tc_kernel" in k for k in report):
            raise AssertionError(f"no tensor-core kernel in {lib}'s "
                                 f"ptxas output:\n{text}")
    log("registers and spills (ptxas -v):", json.dumps(report))
    spills = {k: v for k, v in report.items()
              if "_tc_kernel" in k and v.get("spill_bytes", 1)}
    if spills:
        raise AssertionError(f"tensor-core kernels spill (or ptxas "
                             f"reported no spill line): {spills}")
    if serialized or ignored:
        raise AssertionError(
            "ptxas serialized wgmma or ignored setmaxnreg:\n"
            + "\n".join(serialized + ignored))
    return report


# The Hopper kernels (wgmma, TMA) each flash library must hold.
WGMMA_KERNELS = {"flash_fwd": ("flash_fwd_wgmma_tc_kernel",),
                 "flash_bwd": ("flash_bwd_dkv_wgmma_tc_kernel",
                               "flash_bwd_dq_wgmma_tc_kernel")}


def tensor_core_counts(build):
    """HMMA and HGMMA instructions in each kernel of the built flash
    libraries, from ``cuobjdump -sass``: {"flash_fwd_tc_kernel<64>":
    {"HMMA": n, "HGMMA": n}, ...}, or None when the toolkit has no
    cuobjdump. Fails if a tensor-core kernel (``*_tc_kernel``) has
    neither, if a wgmma kernel has no HGMMA, or if a flash library
    lacks its wgmma kernels (``WGMMA_KERNELS``)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        log("tensor-core count skipped: the CUDA toolkit has no cuobjdump "
            f"(not in {home}/bin nor on PATH)")
        return None
    counts = {}
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        for section in sass.split("Function : ")[1:]:
            key = kernel_key(section.split("\n", 1)[0])
            if key is None:
                continue
            lines = section.splitlines()
            counts[key] = {
                "HMMA": sum(bool(re.search(r"\bHMMA", ln)) for ln in lines),
                "HGMMA": sum("HGMMA" in ln for ln in lines)}
    log("tensor-core instructions (SASS HMMA/HGMMA):", json.dumps(counts))
    tc = {k: n for k, n in counts.items() if "_tc_kernel" in k}
    bad = {k: n for k, n in tc.items()
           if not (n["HGMMA"] if "wgmma" in k else n["HMMA"] + n["HGMMA"])}
    missing = [name for names in WGMMA_KERNELS.values() for name in names
               if not any(k.startswith(name + "<") for k in tc)]
    if not tc or bad or missing:
        raise AssertionError(f"tensor-core kernels without HMMA/HGMMA "
                             f"(wgmma kernels: HGMMA): {bad}; wgmma "
                             f"kernels missing: {missing}; {counts}")
    return counts


def xent_inputs(torch, n, c, gen):
    """f32 logits [n, c] (std 3), labels with rows 0 and 1 outside
    [0, c) (they match no class), and a per-row cotangent."""
    logits = 3 * torch.randn((n, c), generator=gen, device="cuda")
    labels = torch.randint(0, c, (n,), generator=gen, device="cuda")
    labels[0], labels[1] = -1, c + 7
    g = torch.randn((n,), generator=gen, device="cuda")
    return logits, labels, g


# dlogits against its plain version, element by element: |got - want|
# <= DLOGITS_RTOL * (|want| + mean|want|). Almost every entry is a
# softmax term p * g, far below the label's (p - 1) * g, so a bound
# tied to the largest value would pass a softmax that is wrong
# everywhere but at the top. Both sides compute exp(x - max) / sum in f32 and differ by a few f32
# units (~4e-6 relative at most); the floor mean|want| leaves out only
# values far below the row's typical one.
DLOGITS_RTOL = 1e-4


def dlogits_err(got, want):
    """(max |got - want| / (|want| + mean|want|), relative L2 error)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scaled = (diff / (want.abs() + want.abs().mean())).max().item()
    return scaled, (diff.norm() / want.norm()).item()


def check_xent(torch, xent):
    """Phase 3: the cross-entropy kernels against their plain
    versions: at the training shape and at a ragged C % 4 == 0 shape
    (16-byte loads, 513 float4s a row) and a ragged C % 4 != 0 one
    (scalar loads); at ResNet's logits [128, 1000] (16-byte loads; not
    a multiple of the Pallas kernel's 128 lanes) and MNIST's [256, 10]
    (C % 4 != 0: scalar loads)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    results = []
    for n, c in (((TRAIN_SEQ - 1) * TRAIN_BATCH, MODEL["vocab_size"]),
                 (300, 2052), (200, 333), (RESNET_BATCH, RESNET_CLASSES),
                 (MNIST_BATCH, 10)):
        logits, labels, g = xent_inputs(torch, n, c, gen)
        loss = xent.xent_fwd(logits, labels)
        dlogits = xent.xent_bwd(logits, labels, g)
        torch.cuda.synchronize()
        case = dict(shape=[n, c], dtype="torch.float32")
        err, tol = near(loss, xent.softmax_cross_entropy_reference(
            logits, labels), "torch.float32")
        case["err_loss"], case["tol_loss"] = err, tol
        want = xent.softmax_cross_entropy_bwd_reference(logits, labels, g)
        case["err_dlogits"] = (dlogits - want).abs().max().item()
        case["err_dlogits_scaled"], case["rel_l2_dlogits"] = dlogits_err(
            dlogits, want)
        case["tol_dlogits_scaled"] = DLOGITS_RTOL
        log("xent check", json.dumps(case))
        if not (err <= tol and case["err_dlogits_scaled"] <= DLOGITS_RTOL):
            raise AssertionError(f"xent kernel disagrees: {case}")
        results.append(case)
        del logits, dlogits, want
        torch.cuda.empty_cache()
    return results


def time_flash_kernels(torch, attn, window, gen):
    """The flash forward, dQ and dK/dV at q/k/v [8, 2048, 8, 64] bf16
    causal (with the ``window`` band when > 0): {name: row} with each
    kernel's device time (``graph_ms``) and its time launched back to
    back (``launch_ms``), its plain version's, the library yardstick's
    (never called by the port: SDPA forward, causal or with the band as
    a boolean mask, by graph; its backward for dQ and dK/dV together,
    by graph where the card's torch captures it, else by events over 50
    calls: ``library_timing``), the error, the bound over the kept
    pairs and the mma.sync design's time where one was taken."""
    import torch.nn.functional as F
    heads, d = MODEL["num_heads"], MODEL["embed_dim"] // MODEL["num_heads"]
    shape = (TRAIN_BATCH, TRAIN_SEQ, heads, d)
    bf16 = "torch.bfloat16"
    q, k, v, do, lse, delta = bwd_inputs(torch, attn, shape, torch.bfloat16,
                                         True, window, gen, False)
    mask = (dict(attn_mask=attn._keep_mask(TRAIN_SEQ, window, "cuda"))
            if window else dict(is_causal=True))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, **mask)
    sdpa_g = do.transpose(1, 2)
    sdpa_bwd_ms, sdpa_bwd_timing = sdpa_backward_ms(
        torch, lambda: torch.autograd.grad(
            sdpa_out, (qt, kt, vt), sdpa_g, retain_graph=True))
    rows = {}
    row = dict(shape=list(shape), dtype=bf16, window=window,
               timing="graph")
    row["kernel_ms"] = graph_ms(lambda: attn.flash_fwd.launch(
        q, k, v, True, window), 20)
    row["launch_ms"] = cuda_ms(lambda: attn.flash_fwd.launch(
        q, k, v, True, window), 20)
    row["plain_ms"] = cuda_ms(lambda: attn.flash_attention_reference(
        q, k, v, True, window), 5)
    row["library_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **mask), 20)
    o, _ = attn.flash_fwd.launch(q, k, v, True, window)
    ro, _ = attn.flash_attention_reference(q, k, v, True, window)
    row["max_abs_err"] = (o.float() - ro.float()).abs().max().item()
    row["bound_ms"], row["bound_by"] = attention_bound_ms(
        *shape, bf16, True, window, "fwd")
    row["mma_sync_ms"] = MMA_SYNC_MS.get(("flash_fwd", shape, window))
    rows["flash_fwd"] = row
    args = (q, k, v, do, lse, delta, True, window)
    for name, kern, plain in (
            ("flash_bwd_dq", attn.flash_bwd_dq,
             attn.flash_attention_dq_reference),
            ("flash_bwd_dkv", attn.flash_bwd_dkv,
             attn.flash_attention_dkv_reference)):
        row = dict(shape=list(shape), dtype=bf16, window=window,
                   timing="graph")
        row["kernel_ms"] = graph_ms(lambda: kern.launch(*args), 20)
        row["launch_ms"] = cuda_ms(lambda: kern.launch(*args), 20)
        row["plain_ms"] = cuda_ms(lambda: plain(*args), 5)
        row["library_ms"] = sdpa_bwd_ms
        row["library_timing"] = sdpa_bwd_timing
        row["library_call"] = ("scaled_dot_product_attention backward "
                               "(dQ, dK and dV together)")
        got, want = kern.launch(*args), plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        row["max_abs_err"] = max((a.float() - b.float()).abs().max().item()
                                 for a, b in zip(got, want))
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            *shape, bf16, True, window, name.split("_")[-1])
        row["mma_sync_ms"] = MMA_SYNC_MS.get((name, shape, window))
        rows[name] = row
    del q, k, v, do, lse, delta, qt, kt, vt, sdpa_out, sdpa_g, o, ro, mask
    torch.cuda.empty_cache()
    return rows


def sdpa_backward_ms(torch, fn):
    """(ms, "graph" | "events"): SDPA's backward ``fn`` by CUDA-graph
    replay of 20 calls, or, where the card's torch cannot capture it
    (torch 2.11 at [8, 2048, 8, 64] causal: the capture is
    invalidated), by events over 50 calls back to back."""
    try:
        return graph_ms(fn, 20), "graph"
    except RuntimeError as err:
        log(f"SDPA backward not captured ({err}); timed by events")
        torch.cuda.synchronize()
        return cuda_ms(fn, 50), "events"


def time_training_kernels(torch, attn, xent):
    """Phase 4 at the training slice's shapes: the flash forward, dQ
    and dK/dV at q/k/v [8, 2048, 8, 64] bf16 causal
    (``time_flash_kernels``), the cross-entropy at logits [16376,
    32000] f32 against F.cross_entropy(reduction="none") and its
    backward."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    rows = time_flash_kernels(torch, attn, 0, gen)
    n, c = (TRAIN_SEQ - 1) * TRAIN_BATCH, MODEL["vocab_size"]
    rows.update(time_xent(torch, xent, n, c, gen, 20))
    # The next-token objective's copy of logits[:, :-1] (a view that
    # does not merge to [N, V]), timed alone at the slice's shape.
    full = torch.randn((TRAIN_BATCH, TRAIN_SEQ, c), generator=gen,
                       device="cuda")
    rows["logits_copy_ms"] = cuda_ms(
        lambda: full[:, :-1].reshape(-1, c), 20)
    del full
    torch.cuda.empty_cache()
    for name, row in rows.items():
        log("train kernel time", name, json.dumps(row))
    return rows


def time_xent(torch, xent, n, c, gen, iters):
    """The cross-entropy kernels on f32 logits [n, c]: {"xent_fwd":
    row, "xent_bwd": row}, each with the kernel's time over ``iters``
    launches, its plain version's (over a quarter as many), one
    library call's (F.cross_entropy, reduction none; its autograd
    backward), the error and the bound."""
    import torch.nn.functional as F
    logits, labels, g = xent_inputs(torch, n, c, gen)
    lib_logits = logits.detach().requires_grad_()
    lib_loss = F.cross_entropy(lib_logits, labels.clamp(0, c - 1),
                               reduction="none")
    rows = {}
    for name, launch, plain, lib, role in (
            ("xent_fwd", lambda: xent.xent_fwd.launch(logits, labels),
             lambda: xent.softmax_cross_entropy_reference(logits, labels),
             lambda: F.cross_entropy(logits, labels.clamp(0, c - 1),
                                     reduction="none"), "fwd"),
            ("xent_bwd", lambda: xent.xent_bwd.launch(logits, labels, g),
             lambda: xent.softmax_cross_entropy_bwd_reference(
                 logits, labels, g),
             lambda: torch.autograd.grad(lib_loss, lib_logits, g,
                                         retain_graph=True), "bwd")):
        row = dict(shape=[n, c], dtype="torch.float32")
        row["kernel_ms"] = cuda_ms(launch, iters)
        row["plain_ms"] = cuda_ms(plain, max(5, iters // 4))
        row["library_ms"] = cuda_ms(lib, iters)
        row["max_abs_err"] = (launch().float() - plain().float()).abs(
        ).max().item()
        row["bound_ms"], row["bound_by"] = xent_bound_ms(n, c, role)
        rows[name] = row
    del logits, lib_logits, lib_loss
    torch.cuda.empty_cache()
    return rows


def time_image_xent(torch, xent):
    """Phase 4 at ResNet-50's logits [128, 1000] f32 (a few µs a
    launch, so 200 launches back to back)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = time_xent(torch, xent, RESNET_BATCH, RESNET_CLASSES, gen, 200)
    for name, row in rows.items():
        log("image kernel time", name, json.dumps(row))
    return rows


def post(port, payload, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def drive_server(server, rng):
    """Phase 5's traffic. Returns (greedy [(prompt, new, sequence)],
    summary dict). Every response is checked for status, length and
    token range here."""
    port, vocab = server.port, MODEL["vocab_size"]
    greedy = []
    summary = {"requests": 0, "tokens": 0, "ttft_ms": []}

    def run(payload):
        t0 = time.perf_counter()
        status, body = post(port, payload)
        dt = time.perf_counter() - t0
        if status != 200:
            raise AssertionError(f"status {status}: {body}")
        p_len, new = len(payload["prompts"][0]), payload["max_new_tokens"]
        for seq in body["sequences"]:
            if len(seq) != p_len + new or not all(
                    0 <= t < vocab for t in seq):
                raise AssertionError(
                    f"bad sequence: len {len(seq)} != {p_len + new}")
        summary["requests"] += 1
        summary["tokens"] += new * len(body["sequences"])
        return body, dt

    def prompt(n):
        return rng.integers(0, vocab, n).tolist()

    # Greedy, one request at a time, in several buckets (1920 = the
    # largest bucket, max_seq_len - max_new_tokens). A one-token
    # request times the admission alone (time to first token).
    for n, new in ((16, 1), (16, 64), (100, 64), (700, 32),
                   (1920, MAX_NEW)):
        p = prompt(n)
        body, dt = run({"prompts": [p], "max_new_tokens": new})
        greedy.append((p, new, body["sequences"][0]))
        if new == 1:
            summary["ttft_ms"].append(1e3 * dt)
    # Concurrent requests: 8 clients at once (slots batch), one of them
    # a multi-prompt request, one asking for logprobs.
    payloads = [{"prompts": [prompt(n)], "max_new_tokens": MAX_NEW}
                for n in (16, 32, 64, 128, 200, 300)]
    payloads.append({"prompts": [prompt(48), prompt(48)],
                     "max_new_tokens": 96})
    payloads.append({"prompts": [prompt(40)], "max_new_tokens": 64,
                     "logprobs": True})
    results = [None] * len(payloads)
    errors = []

    def client(i):
        try:
            results[i] = run(payloads[i])
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent requests failed: {errors}")
    batch_tokens = sum(p["max_new_tokens"] * len(p["prompts"])
                       for p in payloads)
    summary["concurrent_tokens_per_s"] = batch_tokens / wall
    summary["concurrent_wall_s"] = wall
    for pay, (body, _) in zip(payloads, results):
        if "logprobs" in body:
            lps = body["logprobs"][0]
            if len(lps) != len(pay["prompts"][0]) + pay["max_new_tokens"] \
                    or not all(x <= 1e-6 for x in lps):
                raise AssertionError("bad logprobs row")
        for p, seq in zip(pay["prompts"], body["sequences"]):
            greedy.append((p, pay["max_new_tokens"], seq))
    # One sampled request.
    run({"prompts": [prompt(64)], "max_new_tokens": 32,
         "temperature": 0.8, "top_k": 50, "top_p": 0.9})
    return greedy, summary


def time_engine(torch, engine, rng):
    """Host-clock times of the engine's two operations at full width,
    each ending in a device sync (admit and step copy their results to
    the host): one admission prefill per bucket width, and one decode
    step with every slot active. Returns {"prefill_ms": {width: ms},
    "step_ms": ms}."""
    vocab = MODEL["vocab_size"]
    out = {"prefill_ms": {}}
    for width in (16, 128, 1024, 1920):
        times = []
        for _ in range(4):
            row = rng.integers(0, vocab, width)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot = engine.admit(row, width)[0]
            times.append(1e3 * (time.perf_counter() - t0))
            engine.release(slot)
        out["prefill_ms"][width] = min(times[1:])
    slots = [engine.admit(rng.integers(0, vocab, 16), 16)[0]
             for _ in range(engine.slots)]
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 20
    for _ in range(steps):
        engine.step()
    out["step_ms"] = 1e3 * (time.perf_counter() - t0) / steps
    for slot in slots:
        engine.release(slot)
    return out


def drive_paged_server(server, rng):
    """The paged phase's traffic through the HTTP server: the system
    prompt alone, then 8 concurrent requests of prefix + a distinct
    3-30-token suffix (totals not block-aligned; the boundary block
    forks), then 4 cold prompts of 100-700 tokens, then the prefix
    again once every row is released. Returns (greedy [(prompt, new,
    sequence)], the system prompt)."""
    port, vocab = server.port, MODEL["vocab_size"]
    prefix = rng.integers(0, vocab, PAGED_PREFIX).tolist()
    greedy = []

    def run(prompt, new):
        status, body = post(port, {"prompts": [prompt],
                                   "max_new_tokens": new})
        seq = body.get("sequences", [[]])[0]
        if status != 200 or len(seq) != len(prompt) + new or not all(
                0 <= t < vocab for t in seq):
            raise AssertionError(f"bad response {status}: {body}")
        greedy.append((prompt, new, seq))

    run(prefix, PAGED_NEW)
    suffixes = 3 + rng.permutation(28)[:8]
    errors = []

    def client(n):
        try:
            run(prefix + rng_suffix[n], PAGED_NEW)
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    rng_suffix = {int(n): rng.integers(0, vocab, int(n)).tolist()
                  for n in suffixes}
    threads = [threading.Thread(target=client, args=(int(n),))
               for n in suffixes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent paged requests failed: {errors}")
    for n in rng.integers(PAGED_COLD[0], PAGED_COLD[1] + 1, 4):
        run(rng.integers(0, vocab, int(n)).tolist(), PAGED_NEW)
    run(prefix, PAGED_NEW)
    return greedy, prefix


def stream_divergence(torch, model, prompt, new, seq, wants=None):
    """None when ``seq`` equals greedy_decode's stream, else where it
    first differs and the oracle's margin there: the gap between its
    top two logits against 2e-2 of its largest logit (the logits of
    greedy_decode's own path, fed its own tokens up to that point).
    ``wants`` caches the oracle's streams by (prompt, new)."""
    from container_engine_accelerators_tpu_torch.models.decode import (
        greedy_decode,
    )
    key = (tuple(prompt), new)
    want = None if wants is None else wants.get(key)
    if want is None:
        want = greedy_decode(model, torch.tensor([prompt],
                                                 device=model.device),
                             new)[0].tolist()
        if wants is not None:
            wants[key] = want
    if want == seq:
        return None
    first = next(i for i, (a, b) in enumerate(zip(want, seq)) if a != b)
    p = len(prompt)
    with torch.inference_mode():
        cache = model.init_cache(1, len(want))
        logits = model(torch.tensor([prompt], device=model.device), cache,
                       0)[0, -1]
        for t in range(p, first):
            logits = model(torch.tensor([[want[t]]], device=model.device),
                           cache, t)[0, 0]
    top = logits.float().topk(2).values
    gap = (top[0] - top[1]).item()
    limit = 2e-2 * logits.float().abs().max().item()
    return dict(prompt_len=p, first_diff=first - p, top2_gap=gap,
                limit=limit, near_tie=gap <= limit)


def spill_round_trip(torch, model, rng):
    """An engine whose arena holds one row (128 usable blocks): admit
    the 1000-token prefix and snapshot its blocks, churn two other
    prompts through the arena until the prefix's blocks are reused
    (spilled to the host tier), admit the prefix again: its blocks must
    come back bitwise (the full blocks, and the boundary block's rows
    below the re-prefilled last token). Returns a summary with the
    rehydrate's time."""
    from container_engine_accelerators_tpu_torch.models.decode import (
        SlotDecodeEngine,
    )
    bs = 16
    eng = SlotDecodeEngine(model, 1, MODEL["max_seq_len"], paged=True,
                           kv_block_size=bs,
                           kv_blocks=MODEL["max_seq_len"] // bs + 1,
                           kv_spill=True)
    vocab = MODEL["vocab_size"]
    prefix = rng.integers(0, vocab, PAGED_PREFIX)
    full = PAGED_PREFIX // bs

    def blocks(slot, n):
        ids = torch.as_tensor(eng._tables[slot, :n], device="cuda")
        return torch.stack([a[ids] for layer in eng._cache for a in layer])

    slot = eng.admit(prefix, PAGED_PREFIX, max_new=8)[0]
    snap = blocks(slot, full + 1)
    eng.release(slot)
    churned = 0
    while eng.kv_block_stats()["kv_spill_blocks"] == 0 and churned < 4:
        eng.release(eng.admit(rng.integers(0, vocab, PAGED_PREFIX),
                              PAGED_PREFIX, max_new=8)[0])
        churned += 1
    spilled = eng.kv_block_stats()["kv_spill_blocks"]
    slot = eng.admit(prefix, PAGED_PREFIX, max_new=8)[0]
    back = blocks(slot, full + 1)
    stats = eng.kv_block_stats()
    tail = PAGED_PREFIX - full * bs - 1     # boundary rows kept as copied
    out = dict(churned=churned, spill_blocks=spilled,
               rehydrated_blocks=stats["kv_rehydrated_blocks"],
               spill_hits=stats["kv_spill_hits"],
               full_blocks_equal=bool(torch.equal(back[:, :full],
                                                  snap[:, :full])),
               boundary_rows_equal=bool(torch.equal(
                   back[:, full, :tail], snap[:, full, :tail])),
               rehydrate_ms=[1e3 * t for t in eng.drain_rehydrate_events()])
    eng.release(slot)
    out["leaks"] = eng.pool_leak_report()
    log("spill round trip:", json.dumps(out))
    if not (spilled and out["rehydrated_blocks"] > 0
            and out["full_blocks_equal"] and out["boundary_rows_equal"]
            and out["leaks"] is None):
        raise AssertionError(f"spill round trip failed: {out}")
    del eng, snap, back
    torch.cuda.empty_cache()
    return out


def time_paged(torch, paged, dense, rng):
    """Host-clock times (each ending in a device sync) on the paged
    engine against the dense one: one decode step with 8 rows of 16
    tokens active, each pool twice in turns (dense, paged, paged,
    dense); the admission of a 1003-token prompt cold (width 1024)
    and on a hit of a resident 1000-token prefix (width 16): the
    least of the last three of four."""
    import numpy as np
    vocab = MODEL["vocab_size"]

    def step_ms(eng):
        slots = [eng.admit(rng.integers(0, vocab, 16), 16)[0]
                 for _ in range(eng.slots)]
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            eng.step()
        ms = 1e3 * (time.perf_counter() - t0) / 20
        for slot in slots:
            eng.release(slot)
        return ms

    out = {"step_ms": {"dense": [], "paged": []}}
    for eng, name in ((dense, "dense"), (paged, "paged"), (paged, "paged"),
                      (dense, "dense")):
        out["step_ms"][name].append(step_ms(eng))

    def admit_ms(row):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slot = paged.admit(row, len(row), max_new=8)[0]
        ms = 1e3 * (time.perf_counter() - t0)
        paged.release(slot)
        return ms

    prefix = rng.integers(0, vocab, PAGED_PREFIX)
    cold = [admit_ms(rng.integers(0, vocab, PAGED_PREFIX + 3))
            for _ in range(4)]
    admit_ms(prefix)
    hit = [admit_ms(np.concatenate([prefix, rng.integers(0, vocab, 3)]))
           for _ in range(4)]
    out["prefill_prompt_len"] = PAGED_PREFIX + 3
    out["prefill_cold_ms"], out["prefill_hit_ms"] = min(cold[1:]), min(hit[1:])
    out["prefill_cold_all_ms"], out["prefill_hit_all_ms"] = cold, hit
    log("paged times:", json.dumps(out))
    return out


def drive_paged(torch, model, engine_dense, kernels, rng):
    """The paged phase (see the module docstring): the server's default
    pool at full width, with every launch count set to 0 just before
    the traffic and read just after. Returns (report, launches)."""
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )
    server = GenerationServer("lm", model, port=0, max_new_tokens=MAX_NEW,
                              max_batch=MAX_BATCH, host="127.0.0.1")
    eng = server.engine
    if not eng.paged:
        raise AssertionError("the server's default pool is not paged")
    server.start()
    try:
        widths0 = dict(eng.prefill_widths)
        for kern in kernels:
            kern.launches = 0
        greedy, _ = drive_paged_server(server, rng)
        launches = {kern.name: kern.launches for kern in kernels}
        stats = get(server.port, "/stats")
    finally:
        server.stop()
    leaks = eng.pool_leak_report()
    widths = {w: n - widths0.get(w, 0) for w, n in eng.prefill_widths.items()
              if n != widths0.get(w, 0)}
    narrow = sum(n for w, n in widths.items() if w <= 32)
    report = dict(stats=stats, widths=widths, leaks=leaks,
                  launches=launches, arena_bytes=eng.kv_arena_bytes)
    log("paged server:", json.dumps(report))
    if stats["kv_pool"] != "paged" or stats["prefix_hits"] < 8:
        raise AssertionError(f"paged server: {stats}")
    if narrow != stats["prefix_hits"]:
        raise AssertionError(f"hit rows admitted wider than 32: {widths}, "
                             f"{stats['prefix_hits']} hits")
    if any(launches.values()):
        raise AssertionError(f"the paged pool launched kernels: {launches}")
    if leaks is not None:
        raise AssertionError(f"paged pool not clean when idle: {leaks}")
    diverged = []
    for p, new, seq in greedy:
        d = stream_divergence(torch, model, p, new, seq)
        if d is not None:
            diverged.append(d)
    report["greedy_checked"] = len(greedy)
    report["greedy_exact"] = len(greedy) - len(diverged)
    report["greedy_diverged"] = diverged
    log(f"paged greedy: {report['greedy_exact']} of {len(greedy)} streams "
        f"equal greedy_decode; diverged {diverged}")
    if not all(d["near_tie"] for d in diverged):
        raise AssertionError(f"paged streams diverge off a near tie: "
                             f"{diverged}")
    report["spill"] = spill_round_trip(torch, model, rng)
    report["times"] = time_paged(torch, eng, engine_dense, rng)
    report["times"]["rehydrate_ms"] = report["spill"]["rehydrate_ms"]
    return report, launches


def manifest_argv(path=MANIFEST):
    """The serving container's arguments in a deployment manifest
    (lm-serving.yaml unless ``path`` names another; after the
    interpreter and the script), read as plain text: the "- " items
    under the first "command:" key, comments skipped."""
    args, indent = [], None
    with open(path) as f:
        for line in f:
            stripped = line.strip()
            depth = len(line) - len(line.lstrip())
            if indent is None:
                if stripped == "command:":
                    indent = depth
                continue
            if not stripped or stripped.startswith("#"):
                continue
            if depth < indent or not stripped.startswith("- "):
                break
            args.append(stripped[2:].strip())
    if args[:2] != ["python3", "/demos/serving/serve.py"]:
        raise AssertionError(f"unexpected command in {path}: {args}")
    return args[2:]


def healthz(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def launch_deployed(serve, paged=True):
    """The port's launcher on the manifest's arguments and --port=0
    (CEA_TPU_PAGED_KV=0 while it builds when not ``paged``); polls
    /healthz from the first moment until warm-up is done. Returns
    (server, {"health": first codes, "ready_s": launch to 200})."""
    t0 = time.perf_counter()
    if not paged:
        os.environ["CEA_TPU_PAGED_KV"] = "0"
    try:
        server = serve.build_server(
            serve.build_parser().parse_args(manifest_argv() + ["--port=0"]))
    finally:
        os.environ.pop("CEA_TPU_PAGED_KV", None)
    server.start()
    codes = []
    while True:
        codes.append(healthz(server.port))
        if codes[-1] == 200:
            break
        if codes[-1] != 503 or time.perf_counter() - t0 > 600:
            server.stop()
            raise AssertionError(f"/healthz during warm-up: {codes[-20:]}")
        time.sleep(0.02)
    return server, {"health_503": len(codes) - 1, "health_first": codes[0],
                    "ready_s": time.perf_counter() - t0,
                    "warm_s": server.warm_seconds}


def post_stream(port, payload):
    """(Content-Type, ndjson lines) of a streamed request."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps(payload).encode())
    with urllib.request.urlopen(req, timeout=600) as resp:
        return (resp.headers["Content-Type"],
                [json.loads(line) for line in resp.read().splitlines()])


def run_load_generator(port, stream):
    """demo/serving/load_generator.py --mode generate against the
    server (16 requests, 4 clients, 32 new tokens), in its own process;
    returns its summary line."""
    argv = [sys.executable, os.path.join(REPO_ROOT, "demo", "serving",
                                         "load_generator.py"),
            "--mode", "generate", "--model-name", "lm", "--host",
            "127.0.0.1", "--port", str(port), "-n", "16", "--parallelism",
            "4", "--max-new-tokens", str(DEPLOY_NEW), "--vocab-size",
            str(MODEL["vocab_size"])]
    out = subprocess.run(argv + (["--stream"] if stream else []),
                         capture_output=True, text=True, check=True,
                         timeout=600)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    if summary["requests"] != 16 or summary["errors"]:
        raise AssertionError(f"load generator: {summary}")
    return summary


def drive_deployed_traffic(server, rng):
    """Text, token-id and ndjson-stream requests on the deployed server.
    Returns (greedy [(prompt ids, new, sequence)], summary)."""
    port, vocab = server.port, MODEL["vocab_size"]
    greedy, summary = [], {}
    texts = ["The quick brown fox jumps over the lazy dog.",
             "Kubernetes schedules pods onto nodes with accelerators: "
             "naïve placement fragments a slice."]
    status, body = post(port, {"text": texts, "max_new_tokens": DEPLOY_NEW})
    ids = [list(t.encode("utf-8")) for t in texts]
    if (status != 200 or len(body["completions"]) != 2
            or not all(isinstance(c, str) for c in body["completions"])):
        raise AssertionError(f"text request: {status} {body}")
    for row, seq in zip(ids, body["sequences"]):
        if seq[:len(row)] != row or len(seq) != len(row) + DEPLOY_NEW:
            raise AssertionError("text request: bad sequence")
        greedy.append((row, DEPLOY_NEW, seq))
    summary["completions"] = body["completions"]
    prompts = [rng.integers(0, vocab, n).tolist() for n in DEPLOY_PROMPTS]
    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            results[i] = post(port, {"prompts": [prompts[i]],
                                     "max_new_tokens": DEPLOY_NEW})
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"concurrent deployed requests failed: {errors}")
    for p, (status, body) in zip(prompts, results):
        seq = body["sequences"][0]
        if status != 200 or len(seq) != len(p) + DEPLOY_NEW or not all(
                0 <= t < vocab for t in seq):
            raise AssertionError(f"bad response {status}: {body}")
        greedy.append((p, DEPLOY_NEW, seq))
    # The stream of a greedy request against the same request unstreamed.
    p = rng.integers(0, vocab, 64).tolist()
    status, body = post(port, {"prompts": [p], "max_new_tokens": DEPLOY_NEW})
    want = body["sequences"][0][len(p):]
    kind, lines = post_stream(port, {"prompts": [p], "stream": True,
                                     "max_new_tokens": DEPLOY_NEW})
    got = [line["tokens"][0] for line in lines[:-1]]
    if (kind != "application/x-ndjson" or lines[-1] != {"done": True}
            or got != want):
        raise AssertionError(f"stream differs: {kind} {got} != {want}, "
                             f"last {lines[-1]}")
    greedy.append((p, DEPLOY_NEW, body["sequences"][0]))
    _, lines = post_stream(port, {"text": [texts[0]], "stream": True,
                                  "max_new_tokens": 8})
    if lines[-1] != {"done": True} or not all(
            "completion_delta" in line for line in lines[:-1]):
        raise AssertionError(f"text stream: {lines}")
    summary["stream_tokens"] = len(got)
    summary["load_generator"] = run_load_generator(port, stream=False)
    summary["load_generator_stream"] = run_load_generator(port, stream=True)
    return greedy, summary


def quant_layout(torch, model):
    """Bytes of the model's projection weights (int8 values and f32
    scales, or the native weights) and their parameter count."""
    from container_engine_accelerators_tpu_torch.models.quantized import (
        Int8Linear,
    )
    names = ("qkv", "q", "kv", "proj", "mlp_in", "mlp_out")
    out = {"params": 0, "weight_bytes": 0, "scale_bytes": 0}
    for name, mod in model.named_modules():
        if name.rsplit(".", 1)[-1] not in names:
            continue
        out["params"] += mod.weight.numel()
        out["weight_bytes"] += mod.weight.numel() * mod.weight.element_size()
        if isinstance(mod, Int8Linear):
            out["scale_bytes"] += mod.scale.numel() * 4
    return out


def arena_sizes(torch, decode, model_bf16):
    """Usable blocks and arena bytes of the paged pool (8 slots of
    2048, block 16) at equal memory: the engine asked for bf16, int8
    and int4 on the bf16-cache model."""
    out = {}
    for mode in ("bf16", "int8", "int4"):
        eng = decode.SlotDecodeEngine(model_bf16, MAX_BATCH,
                                      MODEL["max_seq_len"], paged=True,
                                      kv_block_size=16, kv_quant=mode)
        out[mode] = {"usable_blocks": eng._pool.usable,
                     "arena_bytes": eng.kv_arena_bytes}
        del eng
    torch.cuda.empty_cache()
    return out


def int4_engine_run(torch, decode, model, rng):
    """An engine-level int4 run (the paged pool, 4 slots, kv_quant int4
    on the bf16 model): three greedy requests (16, 100 and 700 tokens)
    admitted and stepped
    together; each stream against greedy_decode with an int4 cache
    (informational: the paged prefill attends the quantized prompt,
    the oracle's prefill the raw one)."""
    eng = decode.SlotDecodeEngine(model, 4, MODEL["max_seq_len"], paged=True,
                                  kv_block_size=16, kv_quant="int4")
    vocab = MODEL["vocab_size"]
    prompts = [rng.integers(0, vocab, n).tolist()
               for n in DEPLOY_PROMPTS[:3]]
    rows = {}
    for p in prompts:
        slot, first, _, _ = eng.admit(p, len(p), max_new=DEPLOY_NEW)
        rows[slot] = [first]
    for _ in range(DEPLOY_NEW - 1):
        toks, _ = eng.step()
        for slot, out in rows.items():
            out.append(int(toks[slot]))
    for slot in rows:
        eng.release(slot)
    out = {"leaks": eng.pool_leak_report(), "usable_blocks": eng._pool.usable,
           "exact": 0, "diverged": []}
    for p, (slot, toks) in zip(prompts, rows.items()):
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError(f"int4 engine: bad tokens {toks}")
        want = decode.greedy_decode(model, torch.tensor([p]), DEPLOY_NEW,
                                    kv_quant="int4")[0, len(p):]
        want = want.tolist()
        if want == toks:
            out["exact"] += 1
        else:
            out["diverged"].append(next(
                i for i, (a, b) in enumerate(zip(want, toks)) if a != b))
    if out["leaks"] is not None:
        raise AssertionError(f"int4 engine not clean: {out['leaks']}")
    del eng
    torch.cuda.empty_cache()
    return out


def time_deployment(torch, decode, deployed, dense_int8, model_bf16,
                    dense_bf16, rng):
    """Host-clock times in turns within this call: the paged decode step
    with 8 rows of 16 tokens (bf16 model and cache; bf16 model, int8
    cache; the deployed int8 weights and cache: A B C C B A), the dense
    admission at 16/128/1024/1920 tokens on the bf16 and the int8
    model (least of the last three of four, bf16 int8 int8 bf16), and
    one projection at decode width (8 rows, mlp_in 512 -> 2048) as
    Int8Linear and as the bf16 Linear (CUDA events)."""
    vocab = MODEL["vocab_size"]

    def step_ms(eng):
        slots = [eng.admit(rng.integers(0, vocab, 16), 16)[0]
                 for _ in range(eng.slots)]
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            eng.step()
        ms = 1e3 * (time.perf_counter() - t0) / 20
        for slot in slots:
            eng.release(slot)
        return ms

    kv8 = decode.SlotDecodeEngine(model_bf16, MAX_BATCH, MODEL["max_seq_len"],
                                  paged=True, kv_quant="int8")
    bf16 = decode.SlotDecodeEngine(model_bf16, MAX_BATCH,
                                   MODEL["max_seq_len"], paged=True)
    engines = {"bf16": bf16, "int8_kv": kv8, "deployed": deployed}
    out = {"step_ms": {k: [] for k in engines}}
    for name in ("bf16", "int8_kv", "deployed", "deployed", "int8_kv",
                 "bf16"):
        out["step_ms"][name].append(step_ms(engines[name]))
    del kv8, bf16, engines

    def admit_ms(eng, width):
        times = []
        for _ in range(4):
            row = rng.integers(0, vocab, width)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slot = eng.admit(row, width)[0]
            times.append(1e3 * (time.perf_counter() - t0))
            eng.release(slot)
        return min(times[1:])

    out["dense_prefill_ms"] = {}
    for width in PREFILL_WIDTHS:
        out["dense_prefill_ms"][width] = {
            "bf16": [admit_ms(dense_bf16, width)],
            "int8": [admit_ms(dense_int8, width)]}
        out["dense_prefill_ms"][width]["int8"].append(
            admit_ms(dense_int8, width))
        out["dense_prefill_ms"][width]["bf16"].append(
            admit_ms(dense_bf16, width))
    x = torch.randn((MAX_BATCH, 1, MODEL["embed_dim"]),
                    device=model_bf16.device, dtype=torch.bfloat16)
    int8_layer = deployed._model.blocks[0].mlp_in
    bf16_layer = model_bf16.blocks[0].mlp_in
    with torch.inference_mode():
        out["mlp_in_ms"] = {"int8": cuda_ms(lambda: int8_layer(x), 200),
                            "bf16": cuda_ms(lambda: bf16_layer(x), 200)}
    torch.cuda.empty_cache()
    return out


def drive_deployment(torch, kernels, model_bf16, dense_bf16, rng):
    """The deployment phase (see the module docstring). Returns
    (report, launches summed over its two servers' traffic)."""
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.serving import serve
    report = {"argv": manifest_argv() + ["--port=0"]}
    # The deployment as written: the paged pool, int8 cache and weights.
    server, report["launch"] = launch_deployed(serve)
    eng, model = server.engine, server.engine._model
    if not (eng.paged and eng.kv_quant == "int8" and model.weights == "int8"
            and model.kv_cache_dtype == "int8"):
        raise AssertionError("the launcher did not build the int8 server")
    try:
        if report["launch"]["health_first"] != 503:
            raise AssertionError("/healthz answered 200 before warm-up")
        for kern in kernels:
            kern.launches = 0
        greedy, report["traffic"] = drive_deployed_traffic(server, rng)
        launches = {kern.name: kern.launches for kern in kernels}
        stats = get(server.port, "/stats")
    finally:
        server.stop()
    leaks = eng.pool_leak_report()
    report.update(stats=stats, launches=launches, leaks=leaks,
                  usable_blocks=eng._pool.usable,
                  arena_bytes=eng.kv_arena_bytes,
                  weights=quant_layout(torch, model),
                  weights_bf16=quant_layout(torch, model_bf16))
    log("deployed server:", json.dumps({k: report[k] for k in (
        "launch", "launches", "leaks", "usable_blocks", "arena_bytes",
        "weights")}))
    if (stats["kv_quant_mode"] != "int8" or stats["kv_pool"] != "paged"
            or leaks is not None or any(launches.values())):
        raise AssertionError(f"deployed server: {stats}, {launches}, "
                             f"{leaks}")
    diverged = []
    for p, new, seq in greedy:
        d = stream_divergence(torch, model, p, new, seq)
        if d is not None:
            diverged.append(d)
    report["greedy_checked"] = len(greedy)
    report["greedy_exact"] = len(greedy) - len(diverged)
    report["greedy_diverged"] = diverged
    log(f"deployed greedy (paged int8): {report['greedy_exact']} of "
        f"{len(greedy)} streams equal greedy_decode; diverged {diverged}")
    if not all(d["near_tie"] for d in diverged):
        raise AssertionError(f"deployed streams diverge off a near tie: "
                             f"{diverged}")

    # The same command line on the dense pool: its admission prefill
    # runs the flash kernel on the raw prompt and writes the int8 cache.
    dense, report["dense_launch"] = launch_deployed(serve, paged=False)
    deng = dense.engine
    if deng.paged or deng.kv_quant != "int8":
        raise AssertionError("CEA_TPU_PAGED_KV=0 did not build a dense "
                             "int8 engine")
    try:
        prefills0 = deng.prefills
        for kern in kernels:
            kern.launches = 0
        dense_greedy = []
        for n in DEPLOY_PROMPTS:
            p = rng.integers(0, MODEL["vocab_size"], n).tolist()
            status, body = post(dense.port, {"prompts": [p],
                                             "max_new_tokens": DEPLOY_NEW})
            if status != 200:
                raise AssertionError(f"dense int8: {status} {body}")
            dense_greedy.append((p, body["sequences"][0]))
        dense_launches = {kern.name: kern.launches for kern in kernels}
        admissions = deng.prefills - prefills0
    finally:
        dense.stop()
    mismatches = []
    for p, seq in dense_greedy:
        want = decode.greedy_decode(dense.engine._model, torch.tensor([p]),
                                    DEPLOY_NEW)[0].tolist()
        if want != seq:
            mismatches.append(dict(prompt_len=len(p), first_diff=next(
                i for i, (a, b) in enumerate(zip(want, seq)) if a != b)
                - len(p)))
    report["dense"] = dict(launches=dense_launches, admissions=admissions,
                           greedy_checked=len(dense_greedy),
                           mismatches=mismatches,
                           leaks=deng.pool_leak_report())
    log("deployed dense int8:", json.dumps(report["dense"]))
    layers = MODEL["num_layers"]
    if (dense_launches["flash_fwd"] != layers * admissions
            or admissions != len(dense_greedy)
            or any(n for k, n in dense_launches.items() if k != "flash_fwd")):
        raise AssertionError(f"dense int8 launches: {dense_launches} for "
                             f"{admissions} admissions")
    if mismatches:
        raise AssertionError(f"dense int8 greedy differs: {mismatches}")
    launches = {k: launches[k] + dense_launches[k] for k in launches}

    report["arenas"] = arena_sizes(torch, decode, model_bf16)
    report["int4"] = int4_engine_run(torch, decode, model_bf16, rng)
    log("deployed arenas:", json.dumps(report["arenas"]), "int4 run:",
        json.dumps(report["int4"]))
    report["times"] = time_deployment(torch, decode, eng, deng, model_bf16,
                                      dense_bf16, rng)
    log("deployed times:", json.dumps(report["times"]))
    del server, dense, eng, deng, model
    torch.cuda.empty_cache()
    return report, launches


def train_argv(steps, warmup, batch=TRAIN_BATCH):
    """The training slice's flags for the port's driver: MODEL at full
    width, sequence 2048, the demo's optimizer defaults."""
    return ["--model", "transformer", "--device", "cuda",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--seq-len", str(TRAIN_SEQ), "--batch-size", str(batch),
            "--steps", str(steps), "--warmup-steps", str(warmup),
            "--seed", str(SEED)]


def drive(torch, train, kernels, argv, per_step, warmup):
    """One run of the port's training driver (``train.run``, what
    ``python -m container_engine_accelerators_tpu_torch.train`` runs
    before it prints) on ``argv``, with every launch count set to 0
    just before it. A per-step hook records a CUDA event after each
    step and checks that step's launches against ``per_step`` (one
    count per kernel of ``kernels``). Fails on a step with other
    launches, a driver count that disagrees, or a non-finite loss.
    Returns (summary, launches, trainer, state)."""
    losses, events, bad = [], [], []
    prev = [0] * len(kernels)

    def on_step(step, loss):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        events.append(event)
        losses.append(loss)
        counts = [kern.launches for kern in kernels]
        got = tuple(c - p for c, p in zip(counts, prev))
        if got != per_step:
            bad.append((step, got))
        prev[:] = counts

    args = train.parse_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.launches = 0
    t0 = time.perf_counter()
    result, trainer, state = train.run(args, on_step=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    losses = [float(x) for x in losses]
    # Step i's time: from the event after step i - 1 to the one after
    # step i (step 0 has no start event, and is warm-up).
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    timed = step_ms[warmup - 1:]
    summary = dict(
        losses=losses, step_ms=step_ms,
        step_ms_mean=sum(timed) / len(timed), wall_s=wall_s,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        per_step_launches_expected=per_step, bad_steps=bad,
        driver_result=result)
    want = {kern.name: args.steps * n for kern, n in zip(kernels, per_step)}
    if bad or len(losses) != args.steps:
        raise AssertionError(f"{args.model}: steps with other launch counts "
                             f"than {per_step}: {bad}")
    if result["kernel_launches"] != want or launches != want:
        raise AssertionError(f"{args.model}: driver launches "
                             f"{result['kernel_launches']}, counted "
                             f"{launches}, want {want}")
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"{args.model}: non-finite loss: {losses}")
    if not (result["final_loss"] == losses[-1]
            and result["images_per_sec"] > 0):
        raise AssertionError(f"{args.model}: the driver's result "
                             f"disagrees: {losses} {result}")
    return summary, launches, trainer, state


def image_argv(model, batch, steps, warmup, size=RESNET_SIZE,
               classes=RESNET_CLASSES):
    """The driver's flags for an image model on the card, with the
    demo's optimizer defaults (SGD lr 0.1, momentum 0.9, weight decay
    1e-4 on conv and dense kernels)."""
    return ["--model", model, "--device", "cuda", "--depth", "50",
            "--image-size", str(size), "--num-classes", str(classes),
            "--batch-size", str(batch), "--steps", str(steps),
            "--warmup-steps", str(warmup), "--seed", str(SEED)]


def drive_resnet(torch, train, kernels):
    """Phase 8's main path: ResNet-50 at full width through the driver.
    The loss falls, each step launches the two cross-entropy kernels
    once and no attention kernel, every BN's running statistics moved
    from their init (mean 0, var 1), and the eval step (running
    statistics, no gradient) gives finite logits."""
    from container_engine_accelerators_tpu_torch.models.layers import (
        BatchNorm,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticLoader,
    )
    per_step = (0, 0, 0, 1, 1)
    summary, launches, trainer, state = drive(
        torch, train, kernels,
        image_argv("resnet", RESNET_BATCH, RESNET_STEPS, RESNET_WARMUP),
        per_step, RESNET_WARMUP)
    losses = summary["losses"]
    norms = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
    still = [i for i, m in enumerate(norms)
             if not ((m.running_mean != 0).any() and
                     (m.running_var != 1).any())]
    images, _ = next(SyntheticLoader(RESNET_BATCH, (RESNET_SIZE,) * 2 + (3,),
                                     RESNET_CLASSES, device="cuda"))
    logits = trainer.eval_step(state, images)
    torch.cuda.synchronize()
    summary.update(images_per_s=summary["driver_result"]["images_per_sec"],
                   batch_norms=len(norms), stats_unmoved=still,
                   eval_logits_shape=list(logits.shape),
                   eval_logits_finite=bool(torch.isfinite(logits).all()))
    log("resnet:", json.dumps(summary))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"resnet: the loss did not fall: {losses}")
    if not norms or still:
        raise AssertionError(f"resnet: BN running statistics of layers "
                             f"{still} did not move")
    if not (summary["eval_logits_finite"] and summary["eval_logits_shape"]
            == [RESNET_BATCH, RESNET_CLASSES]):
        raise AssertionError(f"resnet: bad eval logits {summary}")
    del trainer, state, logits
    torch.cuda.empty_cache()
    return summary, launches


def check_image_plain_step(torch, train):
    """One ResNet-50 step (forward and backward, batch 128) through the
    fused loss against the same step through the plain
    ``cross_entropy_loss``, on the same weights and batch: loss and
    every gradient's relative L2 error. The fused step also runs twice
    and reports whether it repeats bitwise (cuDNN may pick backward
    algorithms that sum in another order; not a gate)."""
    from container_engine_accelerators_tpu_torch.ops.xent import (
        mean_cross_entropy_loss,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticLoader,
        cross_entropy_loss,
    )
    args = train.parse_args(image_argv("resnet", RESNET_BATCH, 1, 0))
    model, shape, classes = train.build_model(args, "cuda")
    start = {n: t.clone() for n, t in model.state_dict().items()}
    images, labels = next(SyntheticLoader(RESNET_BATCH, shape, classes,
                                          device="cuda"))

    def step(loss_fn):
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        value = loss_fn(model(images), labels)
        value.backward()
        return value.item(), {n: p.grad.clone()
                              for n, p in model.named_parameters()}

    kernel_loss, kernel_grads = step(mean_cross_entropy_loss)
    again_loss, again_grads = step(mean_cross_entropy_loss)
    plain_loss, plain_grads = step(cross_entropy_loss)
    rel = {n: ((kernel_grads[n] - g).norm() / g.norm().clamp_min(1e-30)
               ).item() for n, g in plain_grads.items()}
    worst = max(rel, key=rel.get)
    differ = sorted(n for n, g in again_grads.items()
                    if not torch.equal(g, kernel_grads[n]))
    out = dict(kernel_loss=kernel_loss, plain_loss=plain_loss,
               loss_rel_err=abs(kernel_loss - plain_loss) / abs(plain_loss),
               grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
               grad_rel_l2_median=sorted(rel.values())[len(rel) // 2],
               loss_tol=IMAGE_LOSS_TOL, grad_tol=IMAGE_GRAD_TOL,
               repeat_loss_bitwise=again_loss == kernel_loss,
               repeat_grads_bitwise=not differ,
               repeat_grads_differing=len(differ), grads=len(rel))
    log("resnet kernel step vs plain step:", json.dumps(out))
    if out["loss_rel_err"] > IMAGE_LOSS_TOL or rel[worst] > IMAGE_GRAD_TOL:
        raise AssertionError(f"resnet: the fused-loss step differs from "
                             f"the plain step: {out}")
    del model, start, kernel_grads, again_grads, plain_grads
    torch.cuda.empty_cache()
    return out


def drive_small_images(torch, train, kernels):
    """Phase 8's other models: MNIST at the demo's shapes (fused loss,
    one cross-entropy forward and backward a step) and Inception-v3 at
    299 (the plain loss, as the demo: no kernel launch)."""
    out, launches = {}, {}
    for name, argv, per_step, warmup in (
            ("mnist", image_argv("mnist", MNIST_BATCH, MNIST_STEPS, 1),
             (0, 0, 0, 1, 1), 1),
            ("inception", image_argv("inception", INCEPTION_BATCH,
                                     INCEPTION_STEPS, 1, size=299),
             (0,) * 5, 1)):
        summary, launches[name], _, _ = drive(
            torch, train, kernels, argv, per_step, warmup)
        summary["images_per_s"] = summary["driver_result"]["images_per_sec"]
        log(f"{name}:", json.dumps(summary))
        out[name] = summary
        torch.cuda.empty_cache()
    return out, launches


def drive_training(torch, train, kernels):
    """Phase 7's main path: TRAIN_STEPS steps of the LM through the
    port's training driver (``drive``): 8 flash_fwd, 8 dQ, 8 dK/dV, 1
    cross-entropy forward and 1 backward launch a step, and the loss
    falls. Returns the summary and the launch counts of the run."""
    per_step = (MODEL["num_layers"],) * 3 + (1, 1)
    summary, launches, _, _ = drive(torch, train, kernels,
                                    train_argv(TRAIN_STEPS, TRAIN_WARMUP),
                                    per_step, TRAIN_WARMUP)
    losses, result = summary["losses"], summary["driver_result"]
    summary["tokens_per_s"] = result["tokens_per_sec"]
    log("train:", json.dumps(summary))
    if not (losses[-1] < losses[0] and result["tokens_per_sec"] > 0):
        raise AssertionError(f"loss did not fall: {losses} {result}")
    torch.cuda.empty_cache()
    return summary, launches


def check_plain_step(torch, attn, convert, train, window=0):
    """One batch-2 step's loss and gradients through the kernels
    against the same step through the plain versions (attention_fn =
    the plain forward, with the band when ``window``; loss = the plain
    cross_entropy_loss), on the same weights and batch."""
    import functools

    from container_engine_accelerators_tpu_torch.models.transformer import (
        next_token_loss_fn,
    )
    from container_engine_accelerators_tpu_torch.ops.xent import (
        mean_cross_entropy_loss,
    )
    from container_engine_accelerators_tpu_torch.parallel import (
        SyntheticTokenLoader,
        cross_entropy_loss,
    )
    config = train.lm_config(train.parse_args(
        train_argv(1, 0, PLAIN_BATCH) + ["--attention-window", str(window)]))
    tree = convert.init_flax_layout_params(config, SEED)
    tokens = next(SyntheticTokenLoader(PLAIN_BATCH, TRAIN_SEQ,
                                       config["vocab_size"],
                                       device="cuda"))[0]

    def plain_attention(q, k, v, causal, window=0):
        return attn.flash_attention_reference(q, k, v, causal, window)[0]

    def step(attention_fn, loss):
        model = convert.load_lm(config, tree, device="cuda",
                                trainable=True, attention_fn=attention_fn)
        loss_fn = next_token_loss_fn(functools.partial(
            loss, label_smoothing=0.0))
        value = loss_fn(model(tokens), tokens)
        value.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        return value.item(), grads

    kernel_loss, kernel_grads = step(None, mean_cross_entropy_loss)
    plain_loss, plain_grads = step(plain_attention, cross_entropy_loss)
    rel = {n: ((kernel_grads[n] - g).norm() / g.norm().clamp_min(1e-30)
               ).item() for n, g in plain_grads.items()}
    worst = max(rel, key=rel.get)
    out = dict(kernel_loss=kernel_loss, plain_loss=plain_loss,
               loss_rel_err=abs(kernel_loss - plain_loss) / abs(plain_loss),
               grad_rel_l2_max=rel[worst], grad_rel_l2_worst=worst,
               grad_rel_l2_median=sorted(rel.values())[len(rel) // 2],
               loss_tol=STEP_LOSS_TOL, grad_tol=STEP_GRAD_TOL, window=window)
    log("kernel step vs plain step:", json.dumps(out))
    if out["loss_rel_err"] > STEP_LOSS_TOL or rel[worst] > STEP_GRAD_TOL:
        raise AssertionError(f"kernel step differs from the plain step: "
                             f"{out}")
    del kernel_grads, plain_grads
    torch.cuda.empty_cache()
    return out


def drive_window_training(torch, train, kernels):
    """Phase 9a: the windowed LM through ``train.run``, as phase
    7: 8 flash_fwd, 8 dQ, 8 dK/dV, 1 cross-entropy forward and 1
    backward a step, and the loss falls."""
    per_step = (MODEL["num_layers"],) * 3 + (1, 1)
    summary, launches, _, state = drive(
        torch, train, kernels,
        train_argv(WINDOW_STEPS, WINDOW_WARMUP)
        + ["--attention-window", str(WINDOW)], per_step, WINDOW_WARMUP)
    losses, result = summary["losses"], summary["driver_result"]
    summary["tokens_per_s"] = result["tokens_per_sec"]
    log("window train:", json.dumps(summary))
    if state.model.attention_window != WINDOW:
        raise AssertionError("train.run did not build a windowed LM")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"window train: loss did not fall: {losses}")
    del state
    torch.cuda.empty_cache()
    return summary, launches


def check_band(torch, convert, rng):
    """Phase 9a: one 2048-token row through the windowed and the causal
    model on the same weights (bf16 serving weights, flash forward).
    Before position W the band does not bind, so the logits must agree
    within the bf16 limit (2e-2 of their largest magnitude); after it
    they must differ by more than that agreement, and by more than 1e-3
    of that magnitude: the band is applied, not ignored by both."""
    tree = convert.init_flax_layout_params(MODEL, SEED)
    toks = torch.as_tensor(rng.integers(0, MODEL["vocab_size"],
                                        (1, MODEL["max_seq_len"])),
                           device="cuda")
    with torch.inference_mode():
        causal = convert.load_lm(MODEL, tree)(toks)
        windowed = convert.load_lm(dict(MODEL, attention_window=WINDOW),
                                   tree)(toks)
    scale = causal.abs().max().item()
    early = (windowed[:, :WINDOW] - causal[:, :WINDOW]).abs().max().item()
    late = (windowed[:, WINDOW:] - causal[:, WINDOW:]).abs().max().item()
    out = dict(scale=scale, early_max_abs=early, late_max_abs=late,
               limit=2e-2 * scale)
    log("window band:", json.dumps(out))
    if not (early <= 2e-2 * scale and late > max(10 * early, 1e-3 * scale)):
        raise AssertionError(f"the band is not applied as it should: {out}")
    del causal, windowed
    torch.cuda.empty_cache()
    return out


def window_mismatches(torch, model, seq, prompt_len):
    """Positions where greedy ``seq`` [1, T] disagrees with the argmax
    of one cache-free forward of the windowed model over it (each
    position teacher-forced by ``seq`` itself), with the gap between
    that forward's top two logits against 2e-2 of its largest logit
    (the bf16 rule of PERF.md §2)."""
    with torch.inference_mode():
        logits = model(seq[:, :-1])[0].float()
    out = []
    for t in range(prompt_len - 1, seq.shape[1] - 1):
        if int(logits[t].argmax()) == int(seq[0, t + 1]):
            continue
        top = logits[t].topk(2).values
        gap = (top[0] - top[1]).item()
        limit = 2e-2 * logits[t].abs().max().item()
        out.append(dict(position=t + 1 - prompt_len, top2_gap=gap,
                        limit=limit, near_tie=gap <= limit))
    return out


def window_decode(torch, decode, model, kernels, rng):
    """Phase 9b: ``decode()`` on the ring: greedy, prompts of 1500 and
    16 tokens and MAX_NEW new tokens each, counts set to 0 just before
    and read just after (one 8-launch flash prefill a call, nothing
    else). The ring holds W slots, not P + MAX_NEW. Each token equals
    the cache-free forward's argmax or sits at a near tie;
    ``stream_decode`` in chunks of 16 and ``beam_search(num_beams=1)``
    give decode()'s tokens (or the same rule holds for theirs)."""
    import numpy as np
    vocab = MODEL["vocab_size"]
    prompts = [torch.as_tensor(rng.integers(0, vocab, (1, n)),
                               device="cuda") for n in WINDOW_PROMPTS]
    for kern in kernels:
        kern.launches = 0
    seqs = [decode.decode(model, p, MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in kernels}
    report = {"launches": dict(launches), "calls": len(prompts)}
    state = decode.prefill_prefix(model, prompts[0],
                                  max_total_len=WINDOW_PROMPTS[0] + MAX_NEW)
    ring = state[0]
    report["ring_leaf_shape"] = list(ring[0][0].shape)
    report["ring_slot_pos_range"] = [int(ring.slot_pos.min()),
                                     int(ring.slot_pos.max())]
    full = model.init_cache(1, MODEL["max_seq_len"], ring=False)
    report["kv_bytes_per_row"] = {
        "ring": sum(a.numel() * a.element_size()
                    for layer in ring for a in layer)
        + ring.slot_pos.numel() * ring.slot_pos.element_size(),
        "full_length": sum(a.numel() * a.element_size()
                           for layer in full for a in layer),
        "per_token": sum(a[0, 0].numel() * a.element_size()
                         for layer in full for a in layer)}
    del state, ring, full
    checks = []
    for p, seq in zip(prompts, seqs):
        n = p.shape[1]
        entry = dict(prompt_len=n,
                     mismatches=window_mismatches(torch, model, seq, n))
        streamed = torch.as_tensor(np.concatenate(
            list(decode.stream_decode(model, p, MAX_NEW, chunk=16)), axis=1),
            device="cuda")
        beam, _ = decode.beam_search(model, p, MAX_NEW, num_beams=1)
        for name, other in (("stream_decode", torch.cat([p, streamed], 1)),
                            ("beam_search_1", beam[:, 0])):
            same = bool(torch.equal(other, seq))
            entry[f"{name}_equal"] = same
            if not same:
                entry[f"{name}_mismatches"] = window_mismatches(
                    torch, model, other, n)
        checks.append(entry)
    report["streams"] = checks
    log("window decode:", json.dumps(report))
    layers = MODEL["num_layers"]
    if (launches["flash_fwd"] != layers * len(prompts)
            or any(v for k, v in launches.items() if k != "flash_fwd")):
        raise AssertionError(f"decode() on the ring launched {launches}")
    kv = MODEL["num_kv_heads"]
    d = MODEL["embed_dim"] // MODEL["num_heads"]
    if report["ring_leaf_shape"] != [1, WINDOW, kv, d]:
        raise AssertionError(f"ring leaves {report['ring_leaf_shape']}")
    bad = [m for c in checks for key in c if key.endswith("mismatches")
           for m in c[key] if not m["near_tie"]]
    if bad:
        raise AssertionError(f"ring greedy tokens off a near tie: {bad}")
    return report, launches


def time_window_step(torch, model, rng):
    """Phase 9d: one decode step (batch 1, at WINDOW_STEP_POS) on the
    ring against the full-length windowed cache (the slot engine's
    kind), host clock around 20 synced steps, in turns ring, full,
    full, ring."""
    caches = {"ring": model.init_cache(1, MODEL["max_seq_len"]),
              "full": model.init_cache(1, MODEL["max_seq_len"], ring=False)}
    tok = torch.as_tensor(rng.integers(0, MODEL["vocab_size"], (1, 1)),
                          device="cuda")
    out = {"ring": [], "full": []}
    with torch.inference_mode():
        for name in ("ring", "full", "full", "ring"):
            for _ in range(3):
                model(tok, caches[name], WINDOW_STEP_POS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                model(tok, caches[name], WINDOW_STEP_POS)
            torch.cuda.synchronize()
            out[name].append(1e3 * (time.perf_counter() - t0) / 20)
    return out


def time_window_kernels(torch, attn):
    """Phase 9d: the three flash kernels at q/k/v [8, 2048, 8, 64] bf16
    with the W 512 band (``time_flash_kernels``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = time_flash_kernels(torch, attn, WINDOW, gen)
    for name, row in rows.items():
        log("window kernel time", name, json.dumps(row))
    return rows


def window_server_traffic(server, rng, lengths):
    """Concurrent greedy requests of ``lengths`` tokens, WINDOW_NEW new
    tokens each. Returns [(prompt, new, sequence)]."""
    vocab = MODEL["vocab_size"]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            results[i] = post(server.port, {"prompts": [prompts[i]],
                                            "max_new_tokens": WINDOW_NEW})
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"windowed requests failed: {errors}")
    out = []
    for p, (status, body) in zip(prompts, results):
        seq = body["sequences"][0]
        if status != 200 or len(seq) != len(p) + WINDOW_NEW or not all(
                0 <= t < vocab for t in seq):
            raise AssertionError(f"bad windowed response {status}: {body}")
        out.append((p, WINDOW_NEW, seq))
    return out


def drive_window_serving(torch, kernels, rng):
    """Phase 9c: ``serve.py --attention-window 512`` (the full-width
    model, bf16) on the paged pool, then on the dense pool
    (CEA_TPU_PAGED_KV=0 while it builds): no kernel launch (the
    admissions ride per-row positions), each greedy stream equal to
    decode() on the ring (``greedy_decode`` is that path) or first
    differing at a near tie, the pool clean when idle."""
    from container_engine_accelerators_tpu_torch.serving import serve
    argv = ["--model", "transformer", "--model-name", "lm", "--port", "0",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--max-seq-len", str(MODEL["max_seq_len"]),
            "--max-new-tokens", str(MAX_NEW),
            "--max-batch", str(MAX_BATCH), "--seed", str(SEED),
            "--attention-window", str(WINDOW)]
    report, launches = {}, {kern.name: 0 for kern in kernels}
    for pool, lengths in (("paged", WINDOW_SERVE), ("dense", WINDOW_DENSE)):
        if pool == "dense":
            os.environ["CEA_TPU_PAGED_KV"] = "0"
        try:
            server = serve.build_server(serve.build_parser().parse_args(argv))
        finally:
            os.environ.pop("CEA_TPU_PAGED_KV", None)
        eng = server.engine
        if (eng.paged != (pool == "paged")
                or eng._model.attention_window != WINDOW):
            raise AssertionError(f"the launcher built the wrong {pool} engine")
        server.start()
        try:
            for kern in kernels:
                kern.launches = 0
            greedy = window_server_traffic(server, rng, lengths)
            counts = {kern.name: kern.launches for kern in kernels}
        finally:
            server.stop()
        diverged = [d for d in (stream_divergence(torch, eng._model, p, new,
                                                  seq)
                                for p, new, seq in greedy) if d is not None]
        entry = dict(launches=counts, requests=len(greedy),
                     greedy_exact=len(greedy) - len(diverged),
                     greedy_diverged=diverged, leaks=eng.pool_leak_report(),
                     arena_bytes=eng.kv_arena_bytes)
        report[pool] = entry
        log(f"window serving ({pool}):", json.dumps(entry))
        if any(counts.values()):
            raise AssertionError(f"windowed {pool} pool launched kernels: "
                                 f"{counts}")
        if entry["leaks"] is not None:
            raise AssertionError(f"windowed {pool} pool not clean: "
                                 f"{entry['leaks']}")
        if not all(d["near_tie"] for d in diverged):
            raise AssertionError(f"windowed {pool} streams diverge off a "
                                 f"near tie: {diverged}")
        launches = {k: launches[k] + counts[k] for k in launches}
        del server, eng
        torch.cuda.empty_cache()
    return report, launches


def drive_window(torch, attn, convert, train, kernels, rng):
    """Phase 9 (see the module docstring). Returns (report, launches
    by path)."""
    from container_engine_accelerators_tpu_torch.models import decode
    report, launches = {}, {}
    report["train"], launches["window_training"] = drive_window_training(
        torch, train, kernels)
    report["train_plain_step"] = check_plain_step(torch, attn, convert,
                                                  train, WINDOW)
    report["band"] = check_band(torch, convert, rng)
    model = convert.load_lm(dict(MODEL, attention_window=WINDOW),
                            convert.init_flax_layout_params(MODEL, SEED))
    report["decode"], launches["window_decode"] = window_decode(
        torch, decode, model, kernels, rng)
    report["serving"], launches["window_serving"] = drive_window_serving(
        torch, kernels, rng)
    report["step_ms"] = time_window_step(torch, model, rng)
    log("window step (ring vs full-length cache):",
        json.dumps(report["step_ms"]))
    del model
    torch.cuda.empty_cache()
    report["kernel_times"] = time_window_kernels(torch, attn)
    return report, launches


def spec_decode_calls(torch, speculative, model, draft, kernels, rng,
                      name, launches_per_call, window=0):
    """Phase 10a: greedy ``speculative_decode`` (k SPEC_K) on the
    SPEC_PROMPTS prompts, MAX_NEW new tokens each, counts set to 0 just
    before each call and read just after. Returns (entry, launches
    summed over the calls)."""
    vocab = MODEL["vocab_size"]
    entry, total = {"calls": []}, {kern.name: 0 for kern in kernels}
    accepted = proposed = 0
    for n in SPEC_PROMPTS:
        prompt = torch.as_tensor(rng.integers(0, vocab, (1, n)),
                                 device="cuda")
        for kern in kernels:
            kern.launches = 0
        t0 = time.perf_counter()
        seq, stats = speculative.speculative_decode(
            model, draft, prompt, MAX_NEW, k=SPEC_K, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {kern.name: kern.launches for kern in kernels}
        total = {k: total[k] + counts[k] for k in total}
        accepted += stats["accepted_drafts"]
        proposed += stats["rounds"] * (SPEC_K - 1)
        entry["calls"].append(dict(
            prompt_len=n, launches=counts, stats=stats, wall_s=wall,
            divergence=stream_divergence(torch, model, prompt[0].tolist(),
                                         MAX_NEW, seq[0].tolist())))
        if (counts["flash_fwd"] != launches_per_call
                or any(v for k, v in counts.items() if k != "flash_fwd")):
            raise AssertionError(f"speculative_decode ({name}, prompt {n}) "
                                 f"launched {counts}")
    entry["acceptance"] = accepted / max(proposed, 1)
    bad = [c["divergence"] for c in entry["calls"]
           if c["divergence"] is not None and not c["divergence"]["near_tie"]]
    if bad:
        raise AssertionError(f"speculative_decode ({name}) diverges off a "
                             f"near tie: {bad}")
    log(f"speculative_decode ({name}):", json.dumps(entry))
    return entry, total


def drive_spec_decode(torch, speculative, convert, model, draft, kernels,
                      rng):
    """Phase 10a (see the module docstring)."""
    report, launches = {}, {}
    layers, dlayers = MODEL["num_layers"], SPEC_DRAFT["num_layers"]
    report["self"], launches["spec_decode_self"] = spec_decode_calls(
        torch, speculative, model, model, kernels, rng, "self-draft",
        2 * layers)
    if report["self"]["acceptance"] < SPEC_ACCEPT_SINGLE:
        raise AssertionError(f"single-request self-draft acceptance "
                             f"{report['self']['acceptance']:.4f} < "
                             f"{SPEC_ACCEPT_SINGLE}")
    report["demo"], launches["spec_decode_demo"] = spec_decode_calls(
        torch, speculative, model, draft, kernels, rng, "demo draft",
        layers + dlayers)
    # One sampled call, twice from the same generator seed.
    prompt = torch.as_tensor(rng.integers(0, MODEL["vocab_size"], (1, 16)),
                             device="cuda")
    runs = [speculative.speculative_decode(
        model, draft, prompt, SPEC_NEW, k=SPEC_K, temperature=0.8, top_k=50,
        top_p=0.9, return_logprobs=True,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 3))
        for _ in range(2)]
    (seq, lps), (seq2, lps2) = runs
    report["sampled"] = dict(
        reproducible=bool(torch.equal(seq, seq2) and torch.equal(lps, lps2)),
        finite=bool(torch.isfinite(lps).all()),
        in_vocab=bool(((seq >= 0) & (seq < MODEL["vocab_size"])).all()))
    if not all(report["sampled"].values()):
        raise AssertionError(f"sampled speculation: {report['sampled']}")
    # The windowed target with its self-draft: rings of W + k slots.
    windowed = convert.load_lm(dict(MODEL, attention_window=WINDOW),
                               convert.init_flax_layout_params(MODEL, SEED))
    shapes = []
    real = windowed.init_cache

    def spy(*args, **kwargs):
        cache = real(*args, **kwargs)
        shapes.append(list(cache[0][0].shape))
        return cache

    windowed.init_cache = spy
    report["window"], launches["spec_decode_window"] = spec_decode_calls(
        torch, speculative, windowed, windowed, kernels, rng,
        "windowed self-draft", 2 * layers)
    windowed.init_cache = real
    report["window"]["ring_leaf_shapes"] = shapes
    kv = MODEL["num_kv_heads"]
    d = MODEL["embed_dim"] // MODEL["num_heads"]
    if shapes[:2] != [[1, WINDOW + SPEC_K, kv, d]] * 2:
        raise AssertionError(f"speculation's ring leaves {shapes}")
    del windowed
    torch.cuda.empty_cache()
    return report, launches


def spec_server_traffic(server, rng, lengths):
    """Concurrent greedy requests of ``lengths`` tokens and one sampled
    request, SPEC_NEW new tokens each. Returns the greedy [(prompt,
    new, sequence)]."""
    vocab = MODEL["vocab_size"]
    payloads = [{"prompts": [rng.integers(0, vocab, n).tolist()],
                 "max_new_tokens": SPEC_NEW} for n in lengths]
    payloads.append({"prompts": [rng.integers(0, vocab, 64).tolist()],
                     "max_new_tokens": SPEC_NEW, "temperature": 0.8,
                     "top_k": 50})
    results, errors = [None] * len(payloads), []

    def client(i):
        try:
            results[i] = post(server.port, payloads[i])
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"speculative requests failed: {errors}")
    greedy = []
    for pay, (status, body) in zip(payloads, results):
        p = pay["prompts"][0]
        seq = body["sequences"][0]
        if status != 200 or len(seq) != len(p) + SPEC_NEW or not all(
                0 <= t < vocab for t in seq):
            raise AssertionError(f"bad speculative response {status}: "
                                 f"{body}")
        if "temperature" not in pay:
            greedy.append((p, SPEC_NEW, seq))
    return greedy


def drive_spec_serving(torch, kernels, rng):
    """Phase 10b: ``serve.py --speculative-k 4`` (the demo draft) on the
    paged pool, then on the dense pool (CEA_TPU_PAGED_KV=0 while it
    builds), counts set to 0 just before the traffic and read just
    after."""
    from container_engine_accelerators_tpu_torch.serving import serve
    argv = ["--model", "transformer", "--model-name", "lm", "--port", "0",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--max-seq-len", str(MODEL["max_seq_len"]),
            "--max-new-tokens", str(MAX_NEW),
            "--max-batch", str(MAX_BATCH), "--seed", str(SEED),
            "--speculative-k", str(SPEC_K),
            "--draft-layers", str(SPEC_DRAFT["num_layers"]),
            "--draft-embed-dim", str(SPEC_DRAFT["embed_dim"])]
    report, launches = {}, {kern.name: 0 for kern in kernels}
    # flash_fwd launches of a greedy and of the sampled admission: the
    # draft's one-shot prefill, and on the dense pool the target's.
    per_admission = {
        "paged": (SPEC_DRAFT["num_layers"], 0),
        "dense": (MODEL["num_layers"] + SPEC_DRAFT["num_layers"],
                  MODEL["num_layers"])}
    for pool, lengths in (("paged", SPEC_SERVE), ("dense", SPEC_DENSE)):
        if pool == "dense":
            os.environ["CEA_TPU_PAGED_KV"] = "0"
        try:
            server = serve.build_server(serve.build_parser().parse_args(argv))
        finally:
            os.environ.pop("CEA_TPU_PAGED_KV", None)
        eng = server.engine
        if eng.paged != (pool == "paged") or eng._spec_k != SPEC_K:
            raise AssertionError(f"the launcher built the wrong {pool} engine")
        server.start()
        try:
            for kern in kernels:
                kern.launches = 0
            prefills0 = eng.prefills
            greedy = spec_server_traffic(server, rng, lengths)
            counts = {kern.name: kern.launches for kern in kernels}
            stats = get(server.port, "/stats")
            admissions = eng.prefills - prefills0
        finally:
            server.stop()
        diverged = [d for d in (stream_divergence(torch, eng._model, p, new,
                                                  seq)
                                for p, new, seq in greedy) if d is not None]
        fields = ("spec_steps", "spec_proposed_tokens",
                  "spec_accepted_tokens", "draft_prefills",
                  "speculative_acceptance_rate", "accepted_tokens_per_step")
        entry = dict(launches=counts, admissions=admissions,
                     greedy=len(greedy), greedy_exact=len(greedy)
                     - len(diverged), greedy_diverged=diverged,
                     leaks=eng.pool_leak_report(),
                     stats={k: stats.get(k) for k in fields
                            + ("spec_kv_blocks_total", "spec_kv_blocks_free",
                               "spec_kv_arena_bytes")},
                     spec_kv_arena_bytes=eng.spec_kv_arena_bytes)
        report[pool] = entry
        log(f"speculative serving ({pool}):", json.dumps(entry))
        greedy_each, sampled_each = per_admission[pool]
        want = greedy_each * len(lengths) + sampled_each
        if (counts["flash_fwd"] != want
                or any(v for k, v in counts.items() if k != "flash_fwd")
                or stats["draft_prefills"] != len(lengths)
                or admissions != len(lengths) + 1):
            raise AssertionError(
                f"speculative {pool} serving launched {counts} for "
                f"{admissions} admissions, {stats['draft_prefills']} "
                f"drafting; want {want} flash_fwd")
        if any(k not in stats for k in fields) or not stats["spec_steps"]:
            raise AssertionError(f"/stats lacks speculation: {stats}")
        if entry["leaks"] is not None:
            raise AssertionError(f"speculative {pool} pool not clean: "
                                 f"{entry['leaks']}")
        if not all(d["near_tie"] for d in diverged):
            raise AssertionError(f"speculative {pool} streams diverge off "
                                 f"a near tie: {diverged}")
        launches = {k: launches[k] + counts[k] for k in launches}
        del server, eng
        torch.cuda.empty_cache()
    return report, launches


def spec_engine_run(torch, decode, model, draft, rng, slot_len):
    """Phase 10b/c: SPEC_ENGINE greedy rows (SPEC_ENGINE_NEW new tokens)
    through a paged engine with ``draft`` (None: plain), all admitted
    first, stepped until each row has its budget (released there), 10
    steps with all 8 rows active timed (host clock around synced
    steps). Returns (engine, report)."""
    import numpy as np
    kwargs = {} if draft is None else dict(draft_model=draft, spec_k=SPEC_K)
    eng = decode.SlotDecodeEngine(model, MAX_BATCH, slot_len, paged=True,
                                  **kwargs)
    vocab = MODEL["vocab_size"]
    rows = {}
    for n in SPEC_ENGINE:
        slot, first, _, _ = eng.admit(rng.integers(0, vocab, n), n,
                                      max_new=SPEC_ENGINE_NEW)
        rows[slot] = [first]
    committed, step_ms = [], []
    while rows:
        full = len(rows) == MAX_BATCH and len(step_ms) < 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.step()
        if full:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        counts = out[2] if draft is not None else np.ones(MAX_BATCH, int)
        for slot in list(rows):
            c = int(counts[slot])
            toks = out[0][slot, :c] if draft is not None else [out[0][slot]]
            rows[slot].extend(int(t) for t in toks)
            if full:
                committed.append(c)
            if len(rows[slot]) >= SPEC_ENGINE_NEW:
                eng.release(slot)
                del rows[slot]
    report = dict(step_ms=step_ms, leaks=eng.pool_leak_report(),
                  tokens_per_row_step=(sum(committed) / len(committed)
                                       if committed else None))
    if draft is not None:
        report.update(acceptance=eng.spec_accepted / max(eng.spec_proposed,
                                                         1),
                      spec_steps=eng.spec_steps,
                      accepted_tokens_per_step=(
                          (eng.spec_accepted + eng.spec_row_steps)
                          / max(eng.spec_row_steps, 1)),
                      spec_kv_arena_bytes=eng.spec_kv_arena_bytes)
    return eng, report


def drive_spec_engine(torch, decode, model, draft, kernels, rng):
    """Phase 10b/c: the self-draft engine's acceptance (>= the JAX
    tool's floor), and the decode step with 8 rows plain, with the demo
    draft and with the self-draft (informational)."""
    slot_len = MODEL["max_seq_len"]
    report = {}
    for name, d in (("plain", None), ("demo", draft), ("self", model)):
        eng, report[name] = spec_engine_run(torch, decode, model, d, rng,
                                            slot_len)
        log(f"speculative engine ({name}):", json.dumps(report[name]))
        if report[name]["leaks"] is not None:
            raise AssertionError(f"speculative engine ({name}) not clean: "
                                 f"{report[name]['leaks']}")
        del eng
    if report["self"]["acceptance"] < SPEC_ACCEPT_ENGINE:
        raise AssertionError(f"engine self-draft acceptance "
                             f"{report['self']['acceptance']:.4f} < "
                             f"{SPEC_ACCEPT_ENGINE}")
    torch.cuda.empty_cache()
    return report


def drive_spec(torch, convert, kernels, rng):
    """Phase 10 (see the module docstring). Returns (report, launches by
    path)."""
    from container_engine_accelerators_tpu_torch.models import decode
    from container_engine_accelerators_tpu_torch.models import speculative
    t0 = time.perf_counter()
    model = convert.load_lm(MODEL, convert.init_flax_layout_params(MODEL,
                                                                   SEED))
    draft = convert.load_lm(SPEC_DRAFT, convert.init_flax_layout_params(
        SPEC_DRAFT, SEED + 1))
    report, launches = drive_spec_decode(torch, speculative, convert, model,
                                         draft, kernels, rng)
    report["serving"], launches["spec_serving"] = drive_spec_serving(
        torch, kernels, rng)
    report["engine"] = drive_spec_engine(torch, decode, model, draft,
                                         kernels, rng)
    report["phase_s"] = time.perf_counter() - t0
    del model, draft
    torch.cuda.empty_cache()
    return report, launches


# ---------------------------------------------------------------------
# Phase 11: the serving contract.
# ---------------------------------------------------------------------


def spawn_launcher(argv, env=None):
    """The port's launcher in its own process on ``argv`` (``env`` on
    top of this process's), its stderr piped for ``launcher_port``."""
    return subprocess.Popen(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.serving.serve"] + argv,
        cwd=REPO_ROOT, env=dict(os.environ, **(env or {})), text=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


def launch_process(argv, env=None):
    """The port's launcher in its own process on ``argv``; returns
    (process, port, stderr lines) once it prints the port it serves on
    (the rest of its stderr is drained on a thread)."""
    proc = spawn_launcher(argv, env)
    return (proc,) + launcher_port(proc, argv)


def launcher_port(proc, argv):
    """(port, stderr lines) once the launcher ``proc`` prints the port
    it serves on; the rest of its stderr is drained on a thread."""
    lines, port = [], None
    while port is None:
        line = proc.stderr.readline()
        if not line:
            proc.wait(timeout=60)
            raise AssertionError(f"launcher {argv} exited {proc.returncode}"
                                 f" before serving: {lines[-20:]}")
        lines.append(line.rstrip())
        m = re.search(r"on port (\d+)", line)
        port = int(m.group(1)) if m else None

    def drain():
        for line in proc.stderr:
            lines.append(line.rstrip())

    threading.Thread(target=drain, daemon=True).start()
    return port, lines


def stop_process(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)


def http_call(port, path, payload=None, headers=None, timeout=600):
    """(status, headers, parsed JSON body) of a GET or POST; an HTTP
    error status is an answer here."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def class_check(logits, pred):
    """None when ``pred`` (a predict response row) is the argmax and
    top softmax probability of ``logits`` (f32 [classes]) within the
    bf16 limit, else what differs: a class other than the argmax must
    sit within 2e-2 of the largest logit of it (a near tie), the score
    within 2e-2 of the top probability."""
    top = int(logits.argmax())
    gap = float(logits.max() - logits[pred["class"]])
    score = float(logits.softmax(-1).max())
    near = gap <= 2e-2 * float(logits.abs().max())
    if (pred["class"] == top or near) and abs(pred["score"] - score) <= 2e-2:
        return None
    return dict(got=pred, want_class=top, want_score=score, gap=gap)


def drive_predict(torch, convert, proc, port):
    """Phase 11a: jax-serving.yaml's command line through the port's
    launcher (a process on the card): /readyz 200, 8 instances in one
    request and 8 one-instance requests at once against the same
    ResNet-50's eval forward run here, then p50 latencies and images/s
    (informational)."""
    import numpy as np

    from container_engine_accelerators_tpu_torch.models.resnet import resnet
    size = RESNET_SIZE
    deadline = time.perf_counter() + 300
    while http_call(port, "/readyz")[0] != 200:
        if time.perf_counter() > deadline or proc.poll() is not None:
            raise AssertionError("the predict server never became ready")
        time.sleep(0.1)
    meta = http_call(port, "/v1/models/resnet")[2]
    info = meta["model_version_status"][0]["metadata"]
    if info != {"kind": "predict", "input_shape": [size, size, 3],
                "max_batch": PREDICT_BATCH}:
        raise AssertionError(f"predict server metadata: {info}")
    # Two decimals keep the JSON body near 1 MB an image; the server
    # and the forward here read the same f32 values.
    rng = np.random.default_rng(SEED + 11)
    values = np.round(rng.standard_normal((PREDICT_BATCH, size, size, 3)),
                      2)
    images = values.astype(np.float32)
    model = resnet(depth=PREDICT_DEPTH, device="meta")
    model = convert.load_image_model(
        model.to_empty(device="cuda"),
        convert.init_flax_layout_image(model, SEED)).eval()
    with torch.inference_mode():
        logits = model(torch.from_numpy(images).cuda()).float().cpu()
    del model
    path = "/v1/models/resnet:predict"
    t0 = time.perf_counter()
    status, _, batch = http_call(port, path, {"instances": values.tolist()})
    batch_ms = 1e3 * (time.perf_counter() - t0)
    singles = [None] * PREDICT_BATCH

    def client(i):
        singles[i] = http_call(port, path, {"instances": [values[i].tolist()]})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(PREDICT_BATCH)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if status != 200 or any(s is None or s[0] != 200 for s in singles):
        raise AssertionError(f"predict failed: {status} {batch} {singles}")
    mismatches = []
    for i in range(PREDICT_BATCH):
        for how, pred in (("batch", batch["predictions"][i]),
                          ("single", singles[i][2]["predictions"][0])):
            bad = class_check(logits[i], pred)
            if bad is not None:
                mismatches.append(dict(bad, row=i, how=how))
    exact = sum(p["class"] == int(logits[i].argmax())
                for i, p in enumerate(batch["predictions"]))
    one_body = {"instances": [values[0].tolist()]}
    eight_body = {"instances": values.tolist()}
    one_ms, eight_ms = [], []
    for body, out, n in ((one_body, one_ms, 8), (eight_body, eight_ms, 3)):
        for _ in range(n):
            t0 = time.perf_counter()
            if http_call(port, path, body)[0] != 200:
                raise AssertionError("timed predict request failed")
            out.append(1e3 * (time.perf_counter() - t0))
    stats = http_call(port, "/stats")[2]
    report = dict(metadata=info, batch_exact=exact, mismatches=mismatches,
                  first_batch_ms=batch_ms,
                  p50_ms_1=float(np.median(one_ms)),
                  p50_ms_8=float(np.median(eight_ms)),
                  images_per_s=8e3 / float(np.median(eight_ms)),
                  stats={k: stats.get(k) for k in ("requests", "shed",
                                                   "p50_ms", "device")})
    log("predict server:", json.dumps(report))
    if mismatches:
        raise AssertionError(f"predictions differ from the forward: "
                             f"{mismatches}")
    if stats.get("device") != "cuda:0":
        raise AssertionError(f"predict server not on the card: {stats}")
    return report


def drill_traffic(server, lengths, rng, vocab):
    """Concurrent greedy requests of ``lengths`` tokens, DRILL_NEW new
    tokens each. Returns [(prompt, sequence)]."""
    import numpy as np
    prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
    results, errors = [None] * len(prompts), []

    def client(i):
        try:
            results[i] = post(server.port, {"prompts": [prompts[i]],
                                            "max_new_tokens": DRILL_NEW})
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"drill requests failed: {errors} {results}")
    return [(p, r[1]["sequences"][0]) for p, r in zip(prompts, results)]


def quarantine_events(obs):
    events = obs.TRACER.snapshot()["events"]
    return ([e for e in events if e["name"] == "serving.engine_quarantine"],
            [e for e in events if e["name"] == "serving.engine_recovered"])


def drive_fault_drill(torch, model, kernels, rng, wants):
    """Phase 11b: CEA_TPU_FAULT_PLAN {"step": [N]}, then {"prefill":
    [N]}, on the dense and the paged pool of the GenerationServer at
    full width, each with DRILL_LENGTHS concurrent greedy requests:
    one quarantine (naming an InjectedFault) and one rebuild a plan,
    every stream equal to greedy_decode's or first differing at a near
    tie, MODEL's layers of flash_fwd launches a replay admission on the
    dense pool and 0 on the paged pool, the pool clean when idle.
    Returns (report, launches by path)."""
    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.ops import attention
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )
    from container_engine_accelerators_tpu_torch.utils import faults
    layers = MODEL["num_layers"]
    report, launches = {}, {}
    for pool in ("dense", "paged"):
        totals = {kern.name: 0 for kern in kernels}
        for plan in DRILL_PLANS:
            if pool == "dense":
                os.environ["CEA_TPU_PAGED_KV"] = "0"
            try:
                server = GenerationServer("lm", model, port=0,
                                          max_new_tokens=MAX_NEW,
                                          max_batch=MAX_BATCH,
                                          host="127.0.0.1")
            finally:
                os.environ.pop("CEA_TPU_PAGED_KV", None)
            svc = server._engine_service
            first_engine = server.engine
            replays = []
            real_admit = svc._admit

            def spy(work, real_admit=real_admit, replays=replays):
                replay = bool(work.tokens)
                before = attention.flash_fwd.launches
                out = real_admit(work)
                if replay:
                    replays.append(attention.flash_fwd.launches - before)
                return out

            svc._admit = spy
            server.start()
            q0, r0 = (len(x) for x in quarantine_events(obs))
            try:
                os.environ[faults.FAULT_PLAN_ENV] = json.dumps(plan)
                faults.reset()   # the next fire parses the plan
                for kern in kernels:
                    kern.launches = 0
                p0 = first_engine.prefills
                greedy = drill_traffic(server, DRILL_LENGTHS, rng,
                                       MODEL["vocab_size"])
                counts = {kern.name: kern.launches for kern in kernels}
                fired = faults.active().fired()
                deadline = time.perf_counter() + 60
                while server.stats()["slots_active"] and (
                        time.perf_counter() < deadline):
                    time.sleep(0.01)
                stats = server.stats()
                admissions = (first_engine.prefills - p0
                              + server.engine.prefills)
                leaks = server.engine.pool_leak_report()
            finally:
                os.environ.pop(faults.FAULT_PLAN_ENV, None)
                faults.reset()
                server.stop()
            quarantines, recovered = quarantine_events(obs)
            quarantines, recovered = quarantines[q0:], recovered[r0:]
            diverged = []
            for p, seq in greedy:
                d = stream_divergence(torch, model, p, DRILL_NEW, seq,
                                      wants)
                if d is not None:
                    diverged.append(d)
            key = f"{pool}_{next(iter(plan))}"
            entry = dict(plan=plan, fired=fired, launches=counts,
                         admissions=admissions, replay_launches=replays,
                         greedy=len(greedy),
                         greedy_exact=len(greedy) - len(diverged),
                         greedy_diverged=diverged, leaks=leaks,
                         quarantine_errors=[e["fields"].get("error_type")
                                            for e in quarantines],
                         recovered=len(recovered),
                         stats={k: stats[k] for k in (
                             "engine_rebuilds", "quarantine_episodes",
                             "replayed_rows", "replayed_tokens",
                             "engine_state", "requests_retired")})
            report[key] = entry
            log(f"fault drill ({key}):", json.dumps(entry))
            per_replay = layers if pool == "dense" else 0
            if (stats["engine_rebuilds"] != 1
                    or stats["quarantine_episodes"] != 1
                    or len(quarantines) != 1 or len(recovered) != 1
                    or fired != plan):
                raise AssertionError(f"fault drill {key}: not one "
                                     f"quarantine and one rebuild")
            if entry["quarantine_errors"] != ["InjectedFault"]:
                raise AssertionError(f"fault drill {key}: a quarantine "
                                     f"not caused by the injected fault: "
                                     f"{quarantines}")
            if not replays or any(n != per_replay for n in replays):
                raise AssertionError(f"fault drill {key}: replay launches "
                                     f"{replays}, want {per_replay} each")
            if (counts["flash_fwd"] != per_replay * admissions
                    or any(n for k, n in counts.items() if k != "flash_fwd")):
                raise AssertionError(f"fault drill {key}: launches {counts} "
                                     f"for {admissions} admissions")
            if leaks is not None or stats["engine_state"] != "serving":
                raise AssertionError(f"fault drill {key}: pool {leaks}, "
                                     f"state {stats['engine_state']}")
            if not all(d["near_tie"] for d in diverged):
                raise AssertionError(f"fault drill {key}: streams diverge "
                                     f"off a near tie: {diverged}")
            totals = {k: totals[k] + counts[k] for k in totals}
            del server, svc, first_engine
            torch.cuda.empty_cache()
        launches[f"fault_drill_{pool}"] = totals
    return report, launches


def lm_flags():
    return ["--model", "transformer", "--model-name", "lm", "--port", "0",
            "--vocab-size", str(MODEL["vocab_size"]),
            "--embed-dim", str(MODEL["embed_dim"]),
            "--num-layers", str(MODEL["num_layers"]),
            "--num-heads", str(MODEL["num_heads"]),
            "--num-kv-heads", str(MODEL["num_kv_heads"]),
            "--pos-embedding", MODEL["pos_embedding"],
            "--max-seq-len", str(MODEL["max_seq_len"]),
            "--max-new-tokens", str(MAX_NEW),
            "--max-batch", str(MAX_BATCH), "--seed", str(SEED)]


def drive_drain(proc, port):
    """Phase 11c: SIGTERM to a launcher process (the LM on the paged
    pool) with DRAIN_PROMPTS streams in flight: /readyz turns 503
    {"state": "draining"}, a new POST gets 503 with Retry-After, every
    stream finishes with its done line and all its tokens, and the
    process exits 0."""
    import signal

    import numpy as np
    vocab = MODEL["vocab_size"]
    rng = np.random.default_rng(SEED + 12)
    prompts = [rng.integers(0, vocab, n).tolist() for n in DRAIN_PROMPTS]
    conns, firsts = [], []
    for p in prompts:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/models/lm:generate",
            data=json.dumps({"prompts": [p], "max_new_tokens": MAX_NEW,
                             "stream": True}).encode())
        conns.append(urllib.request.urlopen(req, timeout=600))
    for c in conns:
        firsts.append(json.loads(c.readline()))
    t0 = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    while http_call(port, "/readyz")[0] != 503:
        if time.perf_counter() - t0 > 30:
            raise AssertionError("/readyz did not turn 503 after SIGTERM")
        time.sleep(0.005)
    readyz = http_call(port, "/readyz")
    post_code, post_headers, post_body = http_call(
        port, "/v1/models/lm:generate", {"prompts": [[1, 2, 3]],
                                         "max_new_tokens": 2})
    streams = []
    for c, first in zip(conns, firsts):
        lines = [first] + [json.loads(x) for x in c.read().splitlines()]
        c.close()
        streams.append(lines)
    rc = proc.wait(timeout=120)
    report = dict(readyz_code=readyz[0], readyz=readyz[2],
                  post_code=post_code,
                  retry_after=post_headers.get("Retry-After"),
                  stream_tokens=[sum(len(x.get("tokens", [])) for x in s)
                                 for s in streams],
                  stream_ends=[s[-1] for s in streams], exit_code=rc,
                  drain_s=time.perf_counter() - t0)
    log("drain:", json.dumps(report))
    if (readyz[0] != 503 or readyz[2].get("state") != "draining"
            or post_code != 503 or int(post_headers["Retry-After"]) < 1
            or "request_id" not in post_body):
        raise AssertionError(f"drain did not shed: {report}")
    if (any(e != {"done": True} for e in report["stream_ends"])
            or any(n != MAX_NEW for n in report["stream_tokens"])):
        raise AssertionError(f"drained streams did not finish: {report}")
    if rc != 0:
        raise AssertionError(f"launcher exited {rc} after the drain")
    return report


def prefix_traffic(server, prefix, rng):
    vocab = MODEL["vocab_size"]
    suffixes = [rng.integers(0, vocab, n).tolist() for n in PREFIX_SUFFIXES]
    results, errors = [None] * len(suffixes), []

    def client(i):
        try:
            results[i] = post(server.port, {"prompts": [suffixes[i]],
                                            "max_new_tokens": DRILL_NEW})
        except Exception as e:  # reported below, fails the run
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(suffixes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"prefix requests failed: {errors} {results}")
    return [(prefix + s, prefix + r[1]["sequences"][0])
            for s, r in zip(suffixes, results)]


def drive_prefix(torch, model, kernels, rng, wants):
    """Phase 11d/e: ``--system-prefix-ids`` with PREFIX_IDS ids, alone
    and with ``--speculative-k 4``: every request a prefix hit, suffix
    streams against greedy_decode over prefix + suffix (the near-tie
    rule), no launch alone and 2 (the draft's prefill) a greedy
    admission with speculation; on the first server /metrics,
    /debug/requests and a traceparent round trip. Returns (report,
    launches by path)."""
    import numpy as np

    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.serving import serve
    vocab = MODEL["vocab_size"]
    prefix = np.random.default_rng(SEED + 13).integers(
        0, vocab, PREFIX_IDS).tolist()
    flags = lm_flags() + ["--system-prefix-ids",
                          ",".join(map(str, prefix))]
    report, launches = {}, {}
    for name, extra in (("system_prefix", []),
                        ("system_prefix_spec",
                         ["--speculative-k", str(SPEC_K)])):
        server = serve.build_server(serve.parse_args(flags + extra))
        server.start()
        try:
            eng = server.engine
            before = server.stats()
            for kern in kernels:
                kern.launches = 0
            streams = prefix_traffic(server, prefix, rng)
            counts = {kern.name: kern.launches for kern in kernels}
            stats = server.stats()
            contract = (drive_observability(obs, server)
                        if name == "system_prefix" else None)
            leaks = eng.pool_leak_report()
        finally:
            server.stop()
        diverged = [d for d in (stream_divergence(torch, model, p,
                                                  DRILL_NEW, seq, wants)
                                for p, seq in streams) if d is not None]
        hits = stats["prefix_hits"] - before["prefix_hits"]
        drafts = stats["draft_prefills"] - before["draft_prefills"]
        entry = dict(launches=counts, prefix_hits=hits,
                     prefix_tokens_shared=stats["prefix_tokens_shared"]
                     - before["prefix_tokens_shared"],
                     draft_prefills=drafts, pinned_blocks=len(eng._pinned),
                     greedy=len(streams),
                     greedy_exact=len(streams) - len(diverged),
                     greedy_diverged=diverged, leaks=leaks,
                     acceptance=stats["speculative_acceptance_rate"])
        if contract is not None:
            entry["observability"] = contract
        report[name] = entry
        log(f"{name}:", json.dumps(entry))
        n = len(PREFIX_SUFFIXES)
        want = SPEC_DRAFT["num_layers"] * n if extra else 0
        if (hits != n or counts["flash_fwd"] != want
                or any(v for k, v in counts.items() if k != "flash_fwd")
                or drafts != (n if extra else 0)):
            raise AssertionError(f"{name}: {entry}")
        if leaks is not None:
            raise AssertionError(f"{name}: pool not clean: {leaks}")
        if not all(d["near_tie"] for d in diverged):
            raise AssertionError(f"{name}: streams diverge off a near tie: "
                                 f"{diverged}")
        launches[name] = counts
        del server, eng
        torch.cuda.empty_cache()
    return report, launches


def drive_observability(obs, server):
    """Phase 11e on a running LM server: /metrics carries the TTFT
    buckets of the traffic, /debug/requests records whose buckets sum
    to their wall time, and a request sent with a traceparent and a
    request id lands under that trace (the serving.request span's
    parent is the header's span) with the id in its ledger record."""
    port = server.port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        text = resp.read().decode()
    ttft = re.search(r'tpu_serving_ttft_seconds_count (\d+)', text)
    if not ttft or int(ttft.group(1)) < len(PREFIX_SUFFIXES):
        raise AssertionError("/metrics lacks the TTFT histogram")
    trace_id, span_id, rid = 0x5EED00C0FFEE, 0xABCDEF, "chip-smoke-11"
    status, _, _ = http_call(
        port, "/v1/models/lm:generate",
        {"prompts": [[1, 2, 3]], "max_new_tokens": 4},
        headers={"traceparent": obs.format_traceparent((trace_id, span_id)),
                 "x-cea-request-id": rid})
    spans = [s for s in obs.TRACER.snapshot()["spans"]
             if s["name"] == "serving.request" and s["trace_id"] == trace_id]
    records = http_call(port, "/debug/requests?n=8")[2]["records"]
    mine = [r for r in records if r.get("request_id") == rid]
    bad_sums = [r for r in records
                if abs(sum(r["buckets"].values()) - r["wall_s"]) > 1e-5]
    out = dict(buckets_in_metrics=text.count("_bucket{"),
               ttft_count=int(ttft.group(1)), traced_spans=len(spans),
               records=len(records), bad_sums=len(bad_sums))
    if (status != 200 or len(spans) != 1
            or spans[0]["parent_id"] != span_id
            or spans[0]["attrs"].get("request_id") != rid
            or len(mine) != 1 or mine[0].get("trace_id") != "%x" % trace_id
            or bad_sums):
        raise AssertionError(f"observability round trip: {out}, {spans}, "
                             f"{mine}")
    return out


def drive_contract(torch, convert, model, kernels):
    """Phase 11 (see the module docstring). The predict and drain
    launchers start first, in their own processes, and warm up while
    the in-process parts run. Returns (report, launches by path)."""
    import numpy as np
    t0 = time.perf_counter()
    predict = launch_process(manifest_argv(PREDICT_MANIFEST) + ["--port=0"])
    drain = launch_process(lm_flags())
    try:
        report = {"predict": drive_predict(torch, convert, predict[0],
                                           predict[1])}
        predict[0].terminate()
        report["predict"]["exit_code"] = predict[0].wait(timeout=120)
        rng = np.random.default_rng(SEED + 14)
        wants = {}
        report["fault_drill"], launches = drive_fault_drill(
            torch, model, kernels, rng, wants)
        report["prefix"], more = drive_prefix(torch, model, kernels, rng,
                                              wants)
        launches.update(more)
        report["drain"] = drive_drain(drain[0], drain[1])
    finally:
        stop_process(predict[0])
        stop_process(drain[0])
    if report["predict"]["exit_code"] != 0:
        raise AssertionError("the predict server did not exit 0 on SIGTERM")
    report["phase_s"] = time.perf_counter() - t0
    log(f"serving contract phase: {report['phase_s']:.1f} s")
    return report, launches


# The fleet phase (12): lm-serving.yaml's architecture in two launcher
# processes behind the port's router and collector. A runs the paged
# pool (what deploy/fleet/engine.yaml deploys), B the dense pool, whose
# admission prefill runs #1, as does a splice's resubmit onto it.
FLEET_SHARED = 1000                  # the shared prefix's tokens
FLEET_UNSHARED = (16, 100, 500, 1000)
FLEET_SUFFIXES = (16, 40, 70, 100)   # after the shared prefix
# The kernels each path must launch at least once in this run, by the
# path's name in the launch record.
PATH_KERNELS = {"fleet": ("flash_fwd",)}


def start_fleet_engines():
    """Phase 12's engines, started before phase 11 so they warm up while
    it runs: {name: (process, thread that reads its port, result)}.
    The thread reads the port and keeps draining stderr from the
    start, so a chatty warm-up never blocks on a full pipe."""
    engines = {}
    for name, env in (("A", None), ("B", {"CEA_TPU_PAGED_KV": "0"})):
        argv = lm_flags() + ["--warm"]
        proc = spawn_launcher(argv, env)
        result = {}

        def read(proc=proc, argv=argv, result=result):
            try:
                result["port"] = launcher_port(proc, argv)[0]
            except AssertionError as e:
                result["error"] = str(e)

        thread = threading.Thread(target=read, daemon=True)
        thread.start()
        engines[name] = (proc, thread, result)
    return engines


def fleet_stream(port, prompt, rid, first=None):
    """One greedy stream of MAX_NEW tokens through the router, with its
    own request id: (tokens, error line or None). ``first`` is set at
    the first token line."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/lm:generate",
        data=json.dumps({"prompts": [prompt], "max_new_tokens": MAX_NEW,
                         "stream": True}).encode(),
        headers={"x-cea-request-id": rid})
    tokens = []
    with urllib.request.urlopen(req, timeout=600) as resp:
        for raw in resp:
            line = json.loads(raw)
            if "tokens" in line:
                tokens.extend(line["tokens"])
                if first is not None:
                    first.set()
            elif line.get("done"):
                return tokens, None
            else:
                return tokens, line
    return tokens, {"error": "stream ended without done"}


def fleet_streams(port, jobs):
    """``jobs`` [(rid, prompt, first event or None)] streamed at once;
    returns {rid: (tokens, error)}."""
    results = {}

    def client(rid, prompt, first):
        try:
            results[rid] = fleet_stream(port, prompt, rid, first)
        except Exception as e:  # reported below, fails the phase
            results[rid] = ([], {"error": repr(e)})

    threads = [threading.Thread(target=client, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results


def wait_for(predicate, what, timeout_s=60.0):
    deadline = time.perf_counter() + timeout_s
    while True:
        out = predicate()
        if out:
            return out
        if time.perf_counter() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def drive_fleet(torch, model, engines, wants):
    """Phase 12 (see the module docstring): (a) 8 greedy streams through
    the router, 4 of them on a shared 1000-token prefix whose repeats
    land by affinity on A; (b) SIGKILL A with >= 2 of them mid-flight:
    every stream completes, each spliced tail equals B's direct answer
    for prompt + the tokens delivered before the kill, the failover
    counter moves, and B's flash_fwd launches grow by MODEL's layers a
    splice admission; (c) B quiesces clean; (d) one trace id a spliced
    journey, with B's serving.request span under the router's; (e)
    SIGUSR1 drains B and the router sheds 503 with Retry-After, its
    /readyz 503. Returns (report, launches by path)."""
    import signal

    import numpy as np

    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.obs.fleet import (
        FleetCollector,
    )
    from container_engine_accelerators_tpu_torch.router_check import (
        router_overhead_ms,
    )
    from container_engine_accelerators_tpu_torch.serving.affinity import (
        affinity_key,
    )
    from container_engine_accelerators_tpu_torch.serving.router import (
        RouterCore,
        RouterServer,
    )
    t0 = time.perf_counter()
    layers = MODEL["num_layers"]
    procs = {name: e[0] for name, e in engines.items()}
    ports = {}
    for name, (proc, thread, result) in engines.items():
        thread.join(timeout=600)
        if "port" not in result:
            raise AssertionError(f"fleet engine {name}: {result}")
        ports[name] = result["port"]
        wait_for(lambda port=ports[name]: healthz(port) == 200,
                 f"engine {name} to warm up", 600)
    pools = {name: get(port, "/stats")["kv_pool"]
             for name, port in ports.items()}
    if pools != {"A": "paged", "B": "dense"}:
        raise AssertionError(f"fleet engines' pools: {pools}")
    urls = {name: f"http://127.0.0.1:{port}" for name, port in ports.items()}
    # The collector and router as deploy/fleet/router.yaml runs them:
    # the default poll interval, shed saturation and spill bound.
    collector = FleetCollector(list(urls.values()))
    core = RouterCore(collector)
    router = RouterServer(core, collector, port=0)
    collector.start()
    router.start()
    rport = router.port
    # Traffic starts once the router is ready, as its readinessProbe
    # gates it in the deployment (the first poll sweep has landed).
    wait_for(lambda: http_call(rport, "/readyz")[0] == 200,
             "the router's /readyz", 30)
    rng = np.random.default_rng(SEED + 15)
    vocab = MODEL["vocab_size"]
    shared = rng.integers(0, vocab, FLEET_SHARED).tolist()
    prompts = {f"fleet-u{i}": rng.integers(0, vocab, n).tolist()
               for i, n in enumerate(FLEET_UNSHARED)}
    prompts.update({f"fleet-s{i}": shared + rng.integers(0, vocab, n).tolist()
                    for i, n in enumerate(FLEET_SUFFIXES)})
    spliced_rids = [f"fleet-s{i}" for i in range(1, len(FLEET_SUFFIXES))]

    def b_stats():
        return get(ports["B"], "/stats")

    try:
        b0 = b_stats()
        # (a) the unshared streams at once; then the shared prefix's
        # first request on A (its blocks live there from now on).
        results = fleet_streams(rport, [(rid, prompts[rid], None)
                                        for rid in prompts if "-u" in rid])
        key = affinity_key(shared, core.block_size, core.affinity_blocks)
        core.repoint(key, urls["A"])
        results.update(fleet_streams(rport, [("fleet-s0",
                                              prompts["fleet-s0"], None)]))
        routed_a = dict(core.stats()["routed"])
        # (b) the shared prefix's repeats, SIGKILL A mid-flight.
        b1 = b_stats()
        failover0 = core.stats()["failover"]
        firsts = [threading.Event() for _ in spliced_rids]
        jobs = [(rid, prompts[rid], first)
                for rid, first in zip(spliced_rids, firsts)]
        box = {}
        runner = threading.Thread(
            target=lambda: box.update(fleet_streams(rport, jobs)))
        runner.start()
        wait_for(lambda: sum(e.is_set() for e in firsts) >= 2,
                 "two shared-prefix streams to start", 120)
        inflight_a = dict(core._inflight).get(urls["A"], 0)
        procs["A"].kill()
        procs["A"].wait(timeout=60)
        runner.join(timeout=600)
        results.update(box)
        routed = dict(core.stats()["routed"])
        failovers = core.stats()["failover"] - failover0
        b2 = b_stats()
        b_records = {r["request_id"]: r for r in get(
            ports["B"], "/debug/requests?n=64")["records"]}
        # Each spliced tail against B asked directly for prompt + the
        # tokens delivered before the kill (B's record of the resubmit
        # holds that prompt's length).
        splices, tails = {}, {}
        for rid in spliced_rids:
            rec = b_records.get(rid)
            if rec is None:
                continue
            tokens = results[rid][0]
            d = rec["prompt_len"] - len(prompts[rid])
            status, body = post(ports["B"], {
                "prompts": [prompts[rid] + tokens[:d]],
                "max_new_tokens": MAX_NEW - d})
            direct = body["sequences"][0][len(prompts[rid]) + d:]
            splices[rid] = d
            tails[rid] = (status == 200 and direct == tokens[d:])
        # (c) B quiesces with its pool clean.
        b3 = wait_for(lambda: (lambda s: s if s["slots_active"] == 0
                               and s["queue_depth"] == 0 else None)(
                                   b_stats()), "B to quiesce")
        # (d) one trace a spliced journey.
        journeys = {}
        for r in http_call(rport, "/debug/requests")[2]["records"]:
            journeys.setdefault(r["request_id"], []).append(r)
        b_spans = {s["attrs"].get("request_id"): s for s in get(
            ports["B"], "/debug/trace")["spans"]
            if s["name"] == "serving.request"}
        router_spans = {s["attrs"].get("request_id"): s
                        for s in obs.TRACER.snapshot()["spans"]
                        if s["name"] == "router.request"}
        traces = {}
        for rid in splices:
            recs = journeys.get(rid, [])
            rec = recs[0] if len(recs) == 1 else {}
            span, parent = b_spans.get(rid), router_spans.get(rid)
            traces[rid] = dict(
                records=len(recs), hops=rec.get("hops"),
                trace_id=rec.get("trace_id"),
                b_span_trace=(None if span is None
                              else "%x" % span["trace_id"]),
                parented=(span is not None and parent is not None
                          and span["parent_id"] == parent["span_id"]),
                sum_err=(abs(sum(rec["buckets"].values()) - rec["wall_s"])
                         if rec else None),
                wall_s=rec.get("wall_s"),
                splice_resubmit_s=(rec["buckets"].get("splice_resubmit")
                                   if rec else None))
        overhead_ms, tax_ms = router_overhead_ms(
            [r for recs in journeys.values() for r in recs
             if r["outcome"] == "completed"])
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{rport}/metrics", timeout=60).read().decode()
        # (e) drain B: the fleet has nowhere to send new work.
        os.kill(procs["B"].pid, signal.SIGUSR1)
        wait_for(lambda: http_call(rport, "/readyz")[0] == 503,
                 "the router's /readyz to turn 503", 30)
        shed_code, shed_headers, shed_body = http_call(
            rport, "/v1/models/lm:generate",
            {"prompts": [prompts["fleet-u0"]], "max_new_tokens": 2})
    finally:
        router.stop()
        collector.stop()
        for proc in procs.values():
            stop_process(proc)
    divergence = {}
    for rid, prompt in prompts.items():
        tokens, err = results.get(rid, ([], {"error": "missing"}))
        if err is not None or len(tokens) != MAX_NEW:
            raise AssertionError(f"fleet stream {rid}: {len(tokens)} "
                                 f"tokens, error {err}")
        divergence[rid] = stream_divergence(torch, model, prompt, MAX_NEW,
                                            prompt + tokens, wants)
    b_prefills = b2["engine_prefills"] - b0["engine_prefills"]
    b_launches = b2["flash_fwd_launches"] - b0["flash_fwd_launches"]
    splice_launches = b2["flash_fwd_launches"] - b1["flash_fwd_launches"]
    report = dict(
        smi=smi_line(), pools=pools, routed_before_kill=routed_a,
        routed=routed, inflight_on_a_at_kill=inflight_a,
        failovers=failovers, splices=splices, spliced_tails_exact=tails,
        splice_launches=splice_launches, flash_fwd_launches=b_launches,
        b_prefills=b_prefills,
        first_divergence={rid: (None if d is None else d["first_diff"])
                          for rid, d in divergence.items()},
        diverged=[dict(d, rid=rid) for rid, d in divergence.items() if d],
        b_quiesced={k: b3[k] for k in (
            "slots", "slots_free", "slots_active", "queue_depth",
            "requests_admitted", "requests_retired", "engine_state")},
        traces=traces, router_overhead_ms=overhead_ms,
        router_overhead_by_bucket_ms=tax_ms,
        failover_metric="tpu_router_failover_total" in metrics,
        shed=dict(code=shed_code,
                  retry_after=shed_headers.get("Retry-After"),
                  error=shed_body.get("error")),
        phase_s=time.perf_counter() - t0)
    log("fleet:", json.dumps(report))
    if routed_a.get("affinity", 0) < 1 or routed.get("affinity", 0) \
            < routed_a["affinity"] + len(spliced_rids):
        raise AssertionError(f"fleet: the shared prefix's repeats were not "
                             f"affinity hits: {routed_a} -> {routed}")
    if inflight_a < 2 or failovers < 2 or len(splices) < 2 \
            or not report["failover_metric"]:
        raise AssertionError(f"fleet: the kill spliced {len(splices)} "
                             f"streams ({failovers} failovers, "
                             f"{inflight_a} in flight on A)")
    if not all(tails.values()):
        raise AssertionError(f"fleet: spliced tails differ from B's "
                             f"direct answer: {tails}")
    if not all(d["near_tie"] for d in report["diverged"]):
        raise AssertionError(f"fleet: streams diverge off a near tie: "
                             f"{report['diverged']}")
    q = report["b_quiesced"]
    if (q["slots_free"] != q["slots"] or q["engine_state"] != "serving"
            or q["requests_admitted"] != q["requests_retired"]):
        raise AssertionError(f"fleet: B not clean after the kill: {q}")
    for rid, t in traces.items():
        if (t["records"] != 1 or not t["hops"] or not t["trace_id"]
                or t["b_span_trace"] != t["trace_id"] or not t["parented"]
                or t["sum_err"] > max(0.01 * t["wall_s"], 2e-5)):
            raise AssertionError(f"fleet: journey {rid} is not one trace: "
                                 f"{t}")
    if shed_code != 503 or int(shed_headers.get("Retry-After") or 0) < 1:
        raise AssertionError(f"fleet: drained fleet answered {report['shed']}")
    if (splice_launches != layers * len(splices)
            or b_launches != layers * b_prefills):
        raise AssertionError(
            f"fleet: B launched flash_fwd {splice_launches} times for "
            f"{len(splices)} splice admissions ({b_launches} for "
            f"{b_prefills} admissions in all)")
    log(f"fleet phase: {report['phase_s']:.1f} s")
    return report, {"fleet": {"flash_fwd": b_launches}}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO_ROOT)
    import numpy as np

    from container_engine_accelerators_tpu_torch.models.convert import (
        init_flax_layout_params,
        load_lm,
    )
    from container_engine_accelerators_tpu_torch.models.decode import (
        greedy_decode,
    )
    from container_engine_accelerators_tpu_torch import train
    from container_engine_accelerators_tpu_torch.models import convert
    from container_engine_accelerators_tpu_torch.ops import _build
    from container_engine_accelerators_tpu_torch.ops import attention
    from container_engine_accelerators_tpu_torch.ops import xent
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = smi_line()
    log(f"device: {kind} count={count} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    report = {"device": {"kind": kind, "count": count, "smi": smi,
                         "torch": torch.__version__,
                         "cuda": torch.version.cuda}}

    # Phase 2: build.
    t0 = time.perf_counter()
    compiler = _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {sorted(compiler)} in {report['build_s']:.2f} s")
    report["ptxas"] = ptxas_report(compiler)

    # Phases 3 and 4: each kernel against its plain version, then times.
    report["tensor_core_instructions"] = tensor_core_counts(_build)
    report["flash_checks"] = check_flash(torch, attention)
    report["flash_bwd_checks"] = check_backward(torch, attention)
    report["bitwise_repeat"] = check_repeat(torch, attention)
    report["xent_checks"] = check_xent(torch, xent)
    widths = [16, 128, 1024, 1920]
    report["flash_times"] = time_flash(torch, attention, widths)
    # The demo draft's head dim (E 128, 8 heads) at the largest bucket.
    report["draft_flash_times"] = time_flash(
        torch, attention, [1920],
        d=SPEC_DRAFT["embed_dim"] // MODEL["num_heads"])
    report["train_kernel_times"] = time_training_kernels(torch, attention,
                                                         xent)
    report["image_kernel_times"] = time_image_xent(torch, xent)

    # Phase 5: the server at full width.
    tree = init_flax_layout_params(MODEL, SEED)
    model = load_lm(MODEL, tree, device="cuda")
    # The dense pool, whose admission prefill runs the flash kernel; the
    # server's default, the paged pool, is the paged phase's.
    os.environ["CEA_TPU_PAGED_KV"] = "0"
    try:
        server = GenerationServer("lm", model, port=0,
                                  max_new_tokens=MAX_NEW,
                                  max_batch=MAX_BATCH, host="127.0.0.1")
    finally:
        del os.environ["CEA_TPU_PAGED_KV"]
    if server.engine.paged:
        raise AssertionError("CEA_TPU_PAGED_KV=0 built a paged engine")
    server.start()
    try:
        if get(server.port, "/healthz")["status"] != "ok":
            raise AssertionError("healthz not ok")
        rng = np.random.default_rng(SEED)
        prefills0 = server.engine.prefills
        for kern in attention.KERNELS + xent.KERNELS:
            kern.launches = 0
        greedy, summary = drive_server(server, rng)
        launches = attention.flash_fwd.launches
        others = {k.name: k.launches for k in attention.KERNELS[1:]
                  + xent.KERNELS if k.launches}
        stats = get(server.port, "/stats")
        admissions = server.engine.prefills - prefills0
    finally:
        server.stop()
    report["server"] = dict(summary, stats=stats, admissions=admissions,
                            launches=launches)
    log("server:", json.dumps(report["server"]))
    if launches != MODEL["num_layers"] * admissions or launches == 0:
        raise AssertionError(
            f"flash_fwd launched {launches} times for {admissions} "
            f"admissions of a {MODEL['num_layers']}-layer model")
    if stats["flash_fwd_launches"] != launches:
        raise AssertionError("/stats flash_fwd_launches disagrees")
    if others:
        raise AssertionError(f"serving launched training kernels: {others}")

    # Every greedy response against the single-request oracle.
    mismatches = []
    for p, new, seq in greedy:
        want = greedy_decode(model, torch.tensor([p]), new)[0].tolist()
        if want != seq:
            first = next(i for i, (a, b) in enumerate(zip(want, seq))
                         if a != b)
            mismatches.append(dict(prompt_len=len(p), new=new,
                                   first_diff=first - len(p)))
    report["greedy_checked"] = len(greedy)
    report["greedy_mismatches"] = mismatches
    log(f"greedy: {len(greedy)} responses vs greedy_decode, "
        f"mismatches {mismatches}")
    if mismatches:
        raise AssertionError(f"greedy responses differ: {mismatches}")

    # Phase 6: where an admission's and a step's time goes (engine
    # alone, after the server has stopped; informational).
    report["engine_times"] = time_engine(torch, server.engine, rng)
    log("engine times:", json.dumps(report["engine_times"]))

    # The paged phase: the server's default pool.
    all_kernels = attention.KERNELS + xent.KERNELS
    report["paged"], paged_launches = drive_paged(
        torch, model, server.engine, all_kernels, rng)

    # The deployment phase: lm-serving.yaml's command line.
    report["deployed"], deployed_launches = drive_deployment(
        torch, all_kernels, model, server.engine, rng)
    del server
    torch.cuda.empty_cache()

    # Phase 7: training at full width.
    report["train"], train_launches = drive_training(torch, train,
                                                     all_kernels)
    report["train_plain_step"] = check_plain_step(torch, attention,
                                                  convert, train)

    # Phase 8: image classification; ResNet-50 is this slice's main path.
    report["resnet"], resnet_launches = drive_resnet(torch, train,
                                                     all_kernels)
    report["resnet_plain_step"] = check_image_plain_step(torch, train)
    small, small_launches = drive_small_images(torch, train, all_kernels)
    report.update(small)

    # Phase 9: the sliding window at full width.
    report["window"], window_launches = drive_window(
        torch, attention, convert, train, all_kernels, rng)

    # Phase 10: speculation at full width.
    report["spec"], spec_launches = drive_spec(torch, convert, all_kernels,
                                               rng)

    # Phase 11: the serving contract; phase 12's engines warm up
    # meanwhile in their own processes.
    fleet_engines = start_fleet_engines()
    try:
        report["contract"], contract_launches = drive_contract(
            torch, convert, model, all_kernels)
        # Phase 12: the fleet front door.
        report["fleet"], fleet_launches = drive_fleet(
            torch, model, fleet_engines, {})
    finally:
        for proc, _, _ in fleet_engines.values():
            stop_process(proc)

    big = report["flash_times"][-1]
    tk = report["train_kernel_times"]
    ik = report["image_kernel_times"]
    src = "container_engine_accelerators_tpu_torch/ops/csrc/"
    ref = "container_engine_accelerators_tpu/ops/"
    checks = {
        "flash_fwd": max(c["err_o"] for c in report["flash_checks"]),
        "flash_bwd_dq": max(c["err_dq"] for c in
                            report["flash_bwd_checks"]),
        "flash_bwd_dkv": max(max(c["err_dk"], c["err_dv"]) for c in
                             report["flash_bwd_checks"]),
        "xent_fwd": max(c["err_loss"] for c in report["xent_checks"]),
        "xent_bwd": max(c["err_dlogits"] for c in report["xent_checks"]),
    }
    replaces = {
        "flash_fwd": "attention.py:136 (_fwd_kernel) and :237 "
                     "(_fwd_kernel_stream)",
        "flash_bwd_dq": "attention.py:167 (_dq_kernel) and :275 "
                        "(_dq_kernel_stream)",
        "flash_bwd_dkv": "attention.py:191 (_dkv_kernel) and :307 "
                         "(_dkv_kernel_stream)",
        "xent_fwd": "xent.py:42 (_fwd_kernel)",
        "xent_bwd": "xent.py:54 (_bwd_kernel)",
    }
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = []
    for kern in all_kernels:
        name = kern.name
        # flash_fwd's fields hold its time at the serving prefill's
        # largest bucket (S 1920), their meaning since the kernel was
        # ported; its time at the training shape goes under train_*.
        # The other kernels run on the training path alone.
        row = big if name == "flash_fwd" else tk[name]
        by_path = {"training": train_launches[name],
                   "resnet_training": resnet_launches[name],
                   "mnist_training": small_launches["mnist"][name],
                   "inception_training": small_launches["inception"][name]}
        if name == "flash_fwd":
            by_path["serving"] = launches
        by_path["paged_serving"] = paged_launches[name]
        by_path["deployed_serving"] = deployed_launches[name]
        for path, counts in window_launches.items():
            by_path[path] = counts[name]
        for path, counts in spec_launches.items():
            by_path[path] = counts[name]
        for path, counts in contract_launches.items():
            by_path[path] = counts[name]
        for path, counts in fleet_launches.items():
            by_path[path] = counts.get(name, 0)
        entry = {
            "name": name, "route": "cuda",
            "source": f"{src}{kern.library}.cu",
            "replaces": f"{ref}{replaces[name]}",
            "launches": sum(by_path.values()),
            "max_abs_err": checks[name],
        }
        entry.update({key: row["kernel_ms" if key == "ms" else key]
                      for key in timed})
        entry["launches_by_path"] = by_path
        if name == "flash_fwd":
            entry.update({f"train_{key}": tk[name][
                "kernel_ms" if key == "ms" else key] for key in timed})
        wk = report["window"]["kernel_times"]
        if name in wk:
            # The flash kernels at the training shape with the W 512 band.
            entry.update({f"window_{key}": wk[name][
                "kernel_ms" if key == "ms" else key] for key in timed})
        if name in ik:
            # The cross-entropy at ResNet-50's logits, [128, 1000].
            entry.update({f"image_{key}": ik[name][
                "kernel_ms" if key == "ms" else key] for key in timed})
        kernels.append(entry)
    report["kernels"] = kernels
    idle = [(path, entry["name"]) for entry in kernels
            for path, names in PATH_KERNELS.items()
            if entry["name"] in names
            and not entry["launches_by_path"].get(path)]
    if idle:
        raise AssertionError(f"kernels a path never launched: {idle}")
    report["wall_s"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"informational on {kind} ({smi}): concurrent "
        f"{summary['concurrent_tokens_per_s']:.1f} tokens/s, time to "
        f"first token {summary['ttft_ms']} ms (16-token prompt); "
        f"training {report['train']['tokens_per_s']:.0f} tokens/s, "
        f"{report['train']['step_ms_mean']:.2f} ms a step; ResNet-50 "
        f"batch {RESNET_BATCH}: {report['resnet']['images_per_s']:.1f} "
        f"images/s, {report['resnet']['step_ms_mean']:.2f} ms a step; "
        f"paged: {json.dumps(report['paged']['times'])}; window step "
        f"{json.dumps(report['window']['step_ms'])} ms, windowed training "
        f"{report['window']['train']['step_ms_mean']:.2f} ms a step; "
        f"speculation phase {report['spec']['phase_s']:.1f} s; ResNet-50 "
        f"predict p50 {report['contract']['predict']['p50_ms_1']:.1f} ms "
        f"(1 image), {report['contract']['predict']['p50_ms_8']:.1f} ms "
        f"(8); serving contract phase "
        f"{report['contract']['phase_s']:.1f} s; fleet phase "
        f"{report['fleet']['phase_s']:.1f} s, router overhead "
        f"{report['fleet']['router_overhead_ms']} ms a request")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

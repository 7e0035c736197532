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
   from ``-Xptxas -v``: a tensor-core kernel must not spill;
3. holds each kernel against its plain PyTorch version on the card
   (flash forward, dQ, dK/dV, cross-entropy forward and backward; the
   cross-entropy gradient element by element, scaled by its mean),
   the bf16 flash forward, dQ and dK/dV also on q/k/v/dO rows that do
   not start on 16 bytes; launches the three tensor-core kernels (bf16
   flash forward, dQ, dK/dV) twice on the same inputs and requires
   bitwise-equal outputs; and counts the tensor-core instructions
   (HMMA/HGMMA) in their SASS (cuobjdump), which must not be 0;
4. times each kernel at its path's shapes beside its bound, its plain
   version and one PyTorch library call (flash forward at the serving
   prefill widths and at the training shape; the backward and the
   cross-entropy at the training shapes, the cross-entropy also at
   ResNet-50's logits), and the next-token objective's logits copy
   alone;
5. serves the full-width LM (the architecture of
   demo/serving/lm-serving.yaml without its int8 options: vocab 32000,
   E 512, 8 layers, 8 heads, 2 KV heads, rope, max_seq_len 2048; bf16,
   random weights from a seed) through the port's GenerationServer on
   a localhost port: greedy requests in several buckets, concurrent
   requests that batch in the slots, one sampled request. Every
   greedy response must equal greedy_decode on the same prompt, and
   the flash kernel must have launched once per layer per admission;
6. times the engine's admission prefill at four bucket widths and one
   decode step with every slot active (host clock around synced work);
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
   logits' shapes ([128, 1000] and [256, 10] f32).

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
import urllib.request

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO_ROOT, "chiprun_out")

# One full-width model the repo serves (demo/serving/lm-serving.yaml).
MODEL = dict(vocab_size=32000, embed_dim=512, num_layers=8, num_heads=8,
             num_kv_heads=2, pos_embedding="rope", max_seq_len=2048)
MAX_NEW = 128
MAX_BATCH = 8
SEED = 0
# The training slice: sequence 2048 at global batch 8 (the demo
# driver's default batch, 256, cut to keep the run short).
TRAIN_SEQ = 2048
TRAIN_BATCH = 8
TRAIN_STEPS = 12
TRAIN_WARMUP = 2
PLAIN_BATCH = 2  # the plain attention's [B, H, S, S] f32 scores fit
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
# rows). bf16 runs the tensor-core forward, dQ and dK/dV (D 128, D 40
# not a multiple of 16, the window band, narrow loads), f32 the FMA
# kernels.
BF16_TC_CASES = [((2, 333, 4, 128), "bfloat16", True, 0, False),
                 ((2, 200, 4, 40), "bfloat16", False, 0, False),
                 ((1, 300, 4, 64), "bfloat16", True, 64, False),
                 ((2, 150, 4, 64), "bfloat16", True, 0, True)]


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
                    err_o=err_o, err_lse=err_l, tol=tol)
        log("flash check", json.dumps(case))
        if not (err_o <= tol and err_l <= tol):
            raise AssertionError(f"flash kernel disagrees: {case}")
        results.append(case)
    return results


def time_flash(torch, attn, widths):
    """Phase 4: kernel, plain version and SDPA at the path shapes."""
    import torch.nn.functional as F
    heads, d = MODEL["num_heads"], MODEL["embed_dim"] // MODEL["num_heads"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for s in widths:
        q, k, v = (torch.randn((1, s, heads, d), generator=gen,
                               device="cuda", dtype=torch.bfloat16)
                   for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 200 if s <= 512 else 50
        row = dict(shape=[1, s, heads, d], dtype="torch.bfloat16")
        row["kernel_ms"] = cuda_ms(
            lambda: attn.flash_fwd.launch(q, k, v, True, 0), iters)
        row["plain_ms"] = cuda_ms(
            lambda: attn.flash_attention_reference(q, k, v, True, 0),
            max(10, iters // 10))
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True), iters)
        o, _ = attn.flash_fwd.launch(q, k, v, True, 0)
        ro, _ = attn.flash_attention_reference(q, k, v, True, 0)
        row["max_abs_err"] = (o.float() - ro.float()).abs().max().item()
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            1, s, heads, d, "torch.bfloat16", True, 0)
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
    at the training shape, launched twice on the same inputs, give
    bitwise-equal outputs (each output tile has one owner block and
    there are no atomics)."""
    shape = (TRAIN_BATCH, TRAIN_SEQ, MODEL["num_heads"],
             MODEL["embed_dim"] // MODEL["num_heads"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    args = bwd_inputs(torch, attn, shape, torch.bfloat16, True, 0, gen,
                      True)
    out = {}
    for name, run in (
            ("flash_fwd", lambda: attn.flash_fwd.launch(*args[:3], True, 0)),
            ("flash_bwd_dq",
             lambda: attn.flash_bwd_dq.launch(*args, True, 0)),
            ("flash_bwd_dkv",
             lambda: attn.flash_bwd_dkv.launch(*args, True, 0))):
        first, second = run(), run()
        torch.cuda.synchronize()
        out[name] = all(torch.equal(a, b) for a, b in zip(first, second))
    log("bitwise repeat:", json.dumps(out))
    if not all(out.values()):
        raise AssertionError(f"two launches on the same inputs differ: {out}")
    return out


def kernel_key(symbol):
    """A kernel's short name from its mangled or demangled symbol:
    "flash_bwd_dq_tc_kernel<64>", "xent_fwd_kernel f32"; None for a
    function that is not one of the port's kernels."""
    # Mangled: ...22flash_bwd_dq_tc_kernelILi64EE...; demangled:
    # ...::flash_bwd_dq_tc_kernel<64>(...).
    name = re.search(r"(?:\d|::)((?:flash|xent)_\w+?_kernel)", symbol)
    if name is None:
        return None
    key = name.group(1)
    dmax = re.search(r"Li(\d+)E|<(\d+)>", symbol)
    if dmax:
        key += f"<{dmax.group(1) or dmax.group(2)}>"
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
    (``*_tc_kernel``) spills, or if a flash library was compiled and
    none of its tensor-core kernels is in the output."""
    report = {}
    for lib, text in sorted(compiler.items()):
        key = None
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                key = kernel_key(entry.group(1))
                if key:
                    report[key] = {}
                continue
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
    return report


def tensor_core_counts(build):
    """HMMA/HGMMA instructions in each kernel of the built flash
    libraries, from ``cuobjdump -sass``: {"flash_fwd_tc_kernel<64>": n,
    ...}, or None when the toolkit has no cuobjdump. Fails if a
    tensor-core kernel (``*_tc_kernel``) has none."""
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
            counts[key] = sum(("HMMA" in line or "HGMMA" in line)
                              for line in section.splitlines())
    log("tensor-core instructions (SASS HMMA/HGMMA):", json.dumps(counts))
    tc = {k: n for k, n in counts.items() if "_tc_kernel" in k}
    if not tc or not all(tc.values()):
        raise AssertionError(f"tensor-core kernels without HMMA/HGMMA: "
                             f"{counts}")
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


def time_training_kernels(torch, attn, xent):
    """Phase 4 at the training slice's shapes: the flash forward, dQ
    and dK/dV at q/k/v [8, 2048, 8, 64] bf16 causal, the cross-entropy
    at logits [16376, 32000] f32. Library yardsticks (never called by
    the port): SDPA forward; SDPA's backward for dQ and dK/dV together;
    F.cross_entropy(reduction="none") and its backward."""
    import torch.nn.functional as F
    heads, d = MODEL["num_heads"], MODEL["embed_dim"] // MODEL["num_heads"]
    shape = (TRAIN_BATCH, TRAIN_SEQ, heads, d)
    bf16 = "torch.bfloat16"
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    q, k, v, do, lse, delta = bwd_inputs(torch, attn, shape, torch.bfloat16,
                                         True, 0, gen, False)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_g = do.transpose(1, 2)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), sdpa_g, retain_graph=True), 20)
    rows = {}
    row = dict(shape=list(shape), dtype=bf16)
    row["kernel_ms"] = cuda_ms(lambda: attn.flash_fwd.launch(
        q, k, v, True, 0), 20)
    row["plain_ms"] = cuda_ms(lambda: attn.flash_attention_reference(
        q, k, v, True, 0), 5)
    row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    o, _ = attn.flash_fwd.launch(q, k, v, True, 0)
    ro, _ = attn.flash_attention_reference(q, k, v, True, 0)
    row["max_abs_err"] = (o.float() - ro.float()).abs().max().item()
    row["bound_ms"], row["bound_by"] = attention_bound_ms(
        *shape, bf16, True, 0, "fwd")
    rows["flash_fwd"] = row
    args = (q, k, v, do, lse, delta, True, 0)
    for name, kern, plain in (
            ("flash_bwd_dq", attn.flash_bwd_dq,
             attn.flash_attention_dq_reference),
            ("flash_bwd_dkv", attn.flash_bwd_dkv,
             attn.flash_attention_dkv_reference)):
        row = dict(shape=list(shape), dtype=bf16)
        row["kernel_ms"] = cuda_ms(lambda: kern.launch(*args), 20)
        row["plain_ms"] = cuda_ms(lambda: plain(*args), 5)
        row["library_ms"] = sdpa_bwd_ms
        row["library_call"] = ("scaled_dot_product_attention backward "
                               "(dQ, dK and dV together)")
        got, want = kern.launch(*args), plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        row["max_abs_err"] = max((a.float() - b.float()).abs().max().item()
                                 for a, b in zip(got, want))
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            *shape, bf16, True, 0, name.split("_")[-1])
        rows[name] = row
    del q, k, v, do, lse, delta, qt, kt, vt, sdpa_out, sdpa_g, o, ro
    torch.cuda.empty_cache()

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


def check_plain_step(torch, attn, convert, train):
    """One batch-2 step's loss and gradients through the kernels
    against the same step through the plain versions (attention_fn =
    the plain forward, loss = the plain cross_entropy_loss), on the
    same weights and batch."""
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
    config = train.lm_config(train.parse_args(train_argv(1, 0, PLAIN_BATCH)))
    tree = convert.init_flax_layout_params(config, SEED)
    tokens = next(SyntheticTokenLoader(PLAIN_BATCH, TRAIN_SEQ,
                                       config["vocab_size"],
                                       device="cuda"))[0]

    def plain_attention(q, k, v, causal):
        return attn.flash_attention_reference(q, k, v, causal)[0]

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
               loss_tol=STEP_LOSS_TOL, grad_tol=STEP_GRAD_TOL)
    log("kernel step vs plain step:", json.dumps(out))
    if out["loss_rel_err"] > STEP_LOSS_TOL or rel[worst] > STEP_GRAD_TOL:
        raise AssertionError(f"kernel step differs from the plain step: "
                             f"{out}")
    del kernel_grads, plain_grads
    torch.cuda.empty_cache()
    return out


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
    report["train_kernel_times"] = time_training_kernels(torch, attention,
                                                         xent)
    report["image_kernel_times"] = time_image_xent(torch, xent)

    # Phase 5: the server at full width.
    tree = init_flax_layout_params(MODEL, SEED)
    model = load_lm(MODEL, tree, device="cuda")
    server = GenerationServer("lm", model, port=0,
                              max_new_tokens=MAX_NEW,
                              max_batch=MAX_BATCH, host="127.0.0.1")
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

    # Phase 7: training at full width.
    all_kernels = attention.KERNELS + xent.KERNELS
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
        if name in ik:
            # The cross-entropy at ResNet-50's logits, [128, 1000].
            entry.update({f"image_{key}": ik[name][
                "kernel_ms" if key == "ms" else key] for key in timed})
        kernels.append(entry)
    report["kernels"] = kernels
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
        f"images/s, {report['resnet']['step_ms_mean']:.2f} ms a step")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   source, all at once);
3. holds each kernel against its plain PyTorch version on the card;
4. times each kernel at the serving path's shapes beside its bound,
   its plain version and one PyTorch library call;
5. serves the full-width LM (the architecture of
   demo/serving/lm-serving.yaml without its int8 options: vocab 32000,
   E 512, 8 layers, 8 heads, 2 KV heads, rope, max_seq_len 2048; bf16,
   random weights from a seed) through the port's GenerationServer on
   a localhost port: greedy requests in several buckets, concurrent
   requests that batch in the slots, one sampled request. Every
   greedy response must equal greedy_decode on the same prompt, and
   the flash kernel must have launched once per layer per admission;
6. times the engine's admission prefill at four bucket widths and one
   decode step with every slot active (host clock around synced work).

Any failure exits nonzero. Without a CUDA device it exits 2 before
printing any result. The last three lines of output are the
``{"kernels": [...]}`` line, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Details go to
chiprun_out/chip_smoke.json.
"""

import json
import os
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


def attention_bound_ms(b, s, h, d, dtype, causal, window):
    """Least time for the flash forward's work on these inputs: q, k,
    v read once, o and lse written once, against HBM bandwidth; the
    products QK^T and PV over the (causal/window-kept) score pairs
    against the input type's peak. Returns (ms, "bytes"|"operations")."""
    item = 2 if dtype == "torch.bfloat16" else 4
    nbytes = 4 * b * s * h * d * item + b * s * h * 4
    if causal and window:
        pairs = sum(min(i + 1, window) for i in range(s))
    elif causal:
        pairs = s * (s + 1) // 2
    else:
        pairs = s * s
    flops = 4 * b * h * d * pairs
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")


def check_flash(torch, attn):
    """Phase 3: the kernel against the plain version, O and lse."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [((1, s, 8, 64), torch.bfloat16, True, 0)
             for s in (16, 200, 512, 1920)]
    cases += [((2, 200, 4, 32), torch.float32, False, 0),
              ((1, 300, 4, 64), torch.float32, True, 64),
              ((1, 1920, 8, 64), torch.bfloat16, True, 256)]
    results = []
    for shape, dtype, causal, window in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=dtype) for _ in range(3))
        o, lse = attn.flash_attention_lse(q, k, v, causal=causal,
                                          window=window or None)
        torch.cuda.synchronize()
        ro, rl = attn.flash_attention_reference(q, k, v, causal, window)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_l = (lse - rl).abs().max().item()
        tol = TOL[str(dtype)]
        case = dict(shape=list(shape), dtype=str(dtype), causal=causal,
                    window=window, err_o=err_o, err_lse=err_l, tol=tol)
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
    from container_engine_accelerators_tpu_torch.ops import _build
    from container_engine_accelerators_tpu_torch.ops import attention
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
    for name, text in compiler.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # Phases 3 and 4: the kernel against its plain version, then times.
    report["flash_checks"] = check_flash(torch, attention)
    widths = [16, 128, 1024, 1920]
    report["flash_times"] = time_flash(torch, attention, widths)

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
        attention.flash_fwd.launches = 0
        greedy, summary = drive_server(server, rng)
        launches = attention.flash_fwd.launches
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

    big = report["flash_times"][-1]
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "container_engine_accelerators_tpu_torch/ops/csrc/"
                  "flash_fwd.cu",
        "replaces": "container_engine_accelerators_tpu/ops/attention.py:"
                    "136 (_fwd_kernel) and :237 (_fwd_kernel_stream)",
        "launches": launches,
        "max_abs_err": max(c["err_o"] for c in report["flash_checks"]),
        "ms": big["kernel_ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": big["library_ms"], "shape": big["shape"],
    }]
    report["kernels"] = kernels
    report["wall_s"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"informational on {kind} ({smi}): concurrent "
        f"{summary['concurrent_tokens_per_s']:.1f} tokens/s, time to "
        f"first token {summary['ttft_ms']} ms (16-token prompt)")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

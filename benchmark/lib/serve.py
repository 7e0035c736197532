"""The serving driver: the program's ``GenerationServer`` around a model
the benchmark made on the device, driven over HTTP by the load
generator's process, then judged against the plain reference.

Set-up makes the weights, builds the server with the cell's buckets
and slots of the configuration's whole context (its warm-up runs every
bucket's admission prefill and the decode step, the shapes this
traffic uses) and starts the ramp: the window opens when the ramp is
over. A traced run starts its device capture before the load and
reduces the window's first ``trace_s`` seconds; its per-layer readers
read the rest of the window, which the capture does not slow.
"""

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import devtrace, reference, stats, traffic
from .device import peak_bytes, release, sync
from .weights import Weights, load_into

LOADGEN = Path(__file__).with_name("loadgen.py")
SERVED = {"main": torch.bfloat16, "f32": torch.float32}


def build_model(cfg, weights):
    """The program's TransformerLM at the configuration's widths, its
    parameters the benchmark's views, as it is served (bf16
    projections; LayerNorms and the lm_head in f32)."""
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM)
    e, f = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    if f % e:
        raise ValueError("the program's MLP width is a multiple of E")
    model = TransformerLM(
        vocab_size=int(cfg["vocab_size"]), embed_dim=e,
        num_layers=int(cfg["num_hidden_layers"]),
        num_heads=int(cfg["num_attention_heads"]),
        num_kv_heads=int(cfg["num_key_value_heads"]),
        max_seq_len=int(cfg["max_position_embeddings"]), mlp_ratio=f // e,
        pos_embedding="rope",
        attention_window=int(cfg.get("sliding_window") or 0),
        dtype=torch.bfloat16, param_dtype=SERVED["main"], device="meta")
    return load_into(model, weights, trainable=False)


class Session:
    """One server for one cell: ``window`` may be called for several
    seeds (the calibration reuses the server; a run calls it once)."""

    def __init__(self, cell, seed, device, trace):
        from container_engine_accelerators_tpu_torch.serving.server import (
            GenerationServer)
        self.cell, self.cfg, self.mix = cell, cell.config, cell.traffic
        self.device = torch.device(device)
        self.trace = trace
        self.weights = Weights(self.cfg, seed, self.device, SERVED)
        self.model = build_model(self.cfg, self.weights)
        serving = self.cfg["serving"]
        buckets = sorted(int(b) for b in self.mix["buckets"])
        # The server's slots are its prompt bucket plus max_new_tokens:
        # a request may generate what its largest bucket leaves of the
        # configuration's context, so every slot spans all of it.
        self.server = GenerationServer(
            "lm", self.model, port=0, host="127.0.0.1",
            max_new_tokens=int(self.cfg["max_position_embeddings"])
            - buckets[-1],
            max_batch=int(serving["max_batch"]), buckets=buckets,
            max_queue=int(serving.get("max_queue", 8 * serving["max_batch"])),
            warm=True)
        self.server.start()
        if trace:
            devtrace.warm(self.device)

    def reseed(self, seed):
        """New weights from ``seed`` in the same buffers (calibration)."""
        self.weights.seed = int(seed)
        self.weights.fill()
        sync(self.device)

    def window(self, seed, seconds, on_open=None):
        """Ramp, then a window of ``seconds``: returns the client's
        records, the window's bounds and, traced, the device capture."""
        from container_engine_accelerators_tpu_torch import obs
        mix = self.mix
        reqs = traffic.schedule(mix, seed, seconds,
                                int(self.cfg["vocab_size"]))
        ramp = float(mix.get("ramp_s", 0.0))
        drain = float(mix.get("drain_s", 60.0))
        open_t = time.monotonic() + ramp + 1.0
        spec = {"port": self.server.port,
                "path": "/v1/models/lm:generate", "loop": mix["loop"],
                "clients": mix.get("clients"), "ramp_s": ramp,
                "open": open_t, "close": open_t + seconds,
                "drain_s": drain,
                "requests": [{k: r[k] for k in ("id", "prompt", "new",
                                                 "client", "due") if k in r}
                             for r in reqs]}
        capture = None
        if self.trace:
            # On the idle card, before the load (lib/devtrace.py).
            capture = devtrace.Capture(self.device)
            capture.start()
        trace_s = min(float(mix.get("trace_s", seconds)), seconds)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "load.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            proc = subprocess.Popen([sys.executable, str(LOADGEN), path],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            try:
                if on_open is not None:
                    _sleep_until(open_t)
                    on_open()
                read_from = open_t
                if capture is not None:
                    _sleep_until(open_t + trace_s)
                    capture.stop()
                    read_from = time.monotonic()
                out, err = proc.communicate(timeout=seconds + ramp + drain
                                            + 120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"load generator failed: {err[-2000:]}")
        records = json.loads(out.strip().splitlines()[-1])["records"]
        unix = time.time() - time.monotonic()
        span_lo, span_hi = open_t + unix, open_t + seconds + unix
        spans = [s for s in obs.TRACER.snapshot()["spans"]
                 if span_lo <= s["start_unix"] < span_hi]
        return {"requests": reqs, "records": records, "open": open_t,
                "close": open_t + seconds, "seconds": seconds,
                "read_from": read_from, "unix": unix, "spans": spans,
                "capture": (devtrace.summarize([capture.reduce(
                    spans, between=(span_lo, span_lo + trace_s))])
                            if capture is not None else None)}

    def stop(self):
        """Stop the server and drop the program's state, the journal's
        providers (which hold the engine) included."""
        from container_engine_accelerators_tpu_torch.obs import postmortem
        self.server.stop()
        for name in ("serving_requests", "serving_kv_blocks"):
            postmortem.unregister_state_provider(name)
        self.server = self.model = self.weights = None
        gc.collect()


def untraced_part(win):
    """The part of a window that the per-layer readers read: in a traced
    run what follows the capture's end (the capture slows the host),
    else all of it."""
    lo = win["read_from"]
    if lo <= win["open"]:
        return win
    lo_unix = lo + win["unix"]
    return dict(win, open=lo, seconds=win["close"] - lo,
                spans=[s for s in win["spans"] if s["start_unix"] >= lo_unix])


def _sleep_until(t):
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def end_to_end(win):
    """The client-side metrics of a window, and attempted / failed."""
    open_t, close_t = win["open"], win["close"]
    tokens, ttft, tpot = 0, [], []
    attempted = failed = 0
    for rec in win["records"]:
        times = rec["times"]
        tokens += sum(1 for t in times if open_t <= t < close_t)
        start = rec["due"] if rec["due"] is not None else rec["sent"]
        if start is not None and open_t <= start < close_t:
            attempted += 1
            if times:
                ttft.append(times[0] - start)
            else:
                failed += 1
        gaps = [t for t in times[1:] if open_t <= t < close_t]
        if len(gaps) >= 2:
            tpot.append((gaps[-1] - gaps[0]) / (len(gaps) - 1))
    out = {"output_tokens_per_s": tokens / win["seconds"]}
    if ttft:
        out["ttft_p95_ms"] = 1e3 * stats.percentile(ttft, 95)
    if tpot:
        out["tpot_p95_ms"] = 1e3 * stats.percentile(tpot, 95)
    return out, attempted, failed


def engine_timeline(win):
    """Where the window's time went on the engine's loop, from its
    spans: decode steps and admission prefills (count, seconds) and the
    longest stretch in which the loop ran neither. A run that reads far
    from the others shows here whether the engine stalled."""
    out = {}
    busy = []
    for name, key in (("serving.engine_step", "steps"),
                      ("serving.prefill", "prefills")):
        found = [s for s in win["spans"] if s["name"] == name
                 and s.get("duration_s") is not None]
        out[key] = len(found)
        out[key + "_s"] = sum(s["duration_s"] for s in found)
        busy += [(s["start_unix"], s["start_unix"] + s["duration_s"])
                 for s in found]
    longest, end = 0.0, None
    for a, b in sorted(busy):
        if end is not None:
            longest = max(longest, a - end)
        end = b if end is None else max(end, b)
    out["longest_pause_s"] = longest
    return out


def check_sample(win, seed, mix):
    """The finished requests the reference checks, drawn from the
    seed: the one with the most served tokens, then others in the
    seed's order until ``check_tokens`` served tokens (at most
    ``check_requests`` requests)."""
    done = [(rec, req) for rec, req in zip(win["records"], win["requests"])
            if rec["done"] and rec["tokens"]]
    if not done:
        return []
    done.sort(key=lambda p: -len(p[0]["tokens"]))
    sample, rest = [done[0]], done[1:]
    order = traffic.rng(seed, "check").permutation(len(rest))
    served = len(done[0][0]["tokens"])
    for i in order:
        if (served >= int(mix["check_tokens"])
                or len(sample) >= int(mix["check_requests"])):
            break
        sample.append(rest[i])
        served += len(rest[i][0]["tokens"])
    return sample


def served_gaps(cfg, seed, device, sample, control=False):
    """The widest gap by which a served token's logit lies below the
    reference's best, over the sample; with ``control``, also the
    widest gap of the tokens the fp8 control puts first."""
    reference.exact_f32()
    w = Weights(cfg, seed, device, SERVED)
    worst = {"served_logit_gap": 0.0}
    if control:
        worst["control_logit_gap"] = 0.0
    served_tokens = 0
    for rec, req in sample:
        prompt, out = req["prompt"], rec["tokens"]
        seq = torch.tensor(prompt + out[:-1], device=device)
        start = len(prompt) - 1
        ref = reference.logits(w, cfg, seq, start)
        got = torch.tensor(out, device=device)
        best = ref.max(dim=-1).values
        gap = (best - ref.gather(1, got[:, None])[:, 0]).max().item()
        worst["served_logit_gap"] = max(worst["served_logit_gap"], gap)
        served_tokens += len(out)
        if control:
            low = reference.logits(w, cfg, seq, start, prec="fp8")
            pick = low.argmax(dim=-1)
            cgap = (best - ref.gather(1, pick[:, None])[:, 0]).max().item()
            worst["control_logit_gap"] = max(worst["control_logit_gap"],
                                             cgap)
        del ref
    del w
    release(device)
    return worst, {"checked_requests": len(sample),
                   "checked_tokens": served_tokens}


def run(cell, args, device):
    """One run of a serving cell: (metrics, attempted, failed,
    compared numbers, extras, memory peak, breakdown)."""
    session = Session(cell, args.seed, device, args.trace)
    setup = {}

    def opened():
        setup["s"] = time.perf_counter() - args.t_start

    try:
        win = session.window(args.seed, args.seconds, on_open=opened)
        peak = peak_bytes(device)
    finally:
        session.stop()
    del session
    release(device)
    e2e, attempted, failed = end_to_end(win)
    e2e["setup_s"] = setup["s"]
    sample = check_sample(win, args.seed, cell.traffic)
    numbers, info = served_gaps(cell.config, args.seed, device, sample)
    info["engine"] = engine_timeline(win)
    if not sample:
        numbers = {}
    # Greedy, no eos_id: a finished stream holds exactly the tokens asked.
    numbers["stream_length_errors"] = sum(
        1 for rec, req in zip(win["records"], win["requests"])
        if rec["done"] and len(rec["tokens"]) != req["new"])
    ctx = {"cfg": cell.config, "traffic": cell.traffic,
           "window": untraced_part(win), "trace": win["capture"]}
    return {"e2e": e2e, "attempted": attempted, "failed": failed,
            "numbers": numbers, "info": info, "peak": peak, "ctx": ctx}

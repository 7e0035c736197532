"""The training driver: the program's ``Trainer.train_step`` on a model
the benchmark made on the device, batches of random token rows drawn
from the seed, and the plain reference following its first steps.

Set-up builds one trainer (f32 parameters, bf16 compute, the fused
cross-entropy, ``Sgd`` with momentum) and drives it through steps 1-3
on their own rows, reading what the comparison needs (each step's
loss, the momentum after step 1, which is the first gradient, and the
parameters' change after step 3); the window then goes on with the
same trainer from step 4. After the window the program is freed and
the reference runs the same three steps from the same seed.
"""

import time

import torch

from . import devtrace, flops, judge, reference
from .traffic import derive_seed
from .device import peak_bytes, release, sync
from .weights import Weights, load_into

F32 = {"main": torch.float32, "f32": torch.float32}
CHECK_STEPS = 3


def build_model(cfg, weights, seq):
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
        max_seq_len=max(seq, int(cfg["max_position_embeddings"])),
        mlp_ratio=f // e, pos_embedding="rope",
        attention_window=int(cfg.get("sliding_window") or 0),
        dtype=torch.bfloat16, param_dtype=torch.float32, device="meta")
    return load_into(model, weights, trainable=True)


def batch(mix, cfg, seed, step, device):
    """Step ``step``'s rows: [B, S] token ids of their own, drawn on the
    device from (seed, step)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, "batch", step))
    return torch.randint(0, int(cfg["vocab_size"]),
                         (int(mix["batch"]), int(mix["seq_len"])),
                         generator=gen, device=device)


def change_norms(weights, names):
    """{leaf: norm of its change} from the values the seed made: each
    chunk of the buffer is made again beside the current values."""
    sq = {n: 0.0 for n in names}
    segs = {n: weights.segment(n) for n in names}
    for key, flat in weights.flat.items():
        tmp = None
        for index in range(weights.chunks(key)):
            lo = index * (1 << 28)
            hi = min(lo + (1 << 28), flat.numel())
            if tmp is None or tmp.numel() != hi - lo:
                tmp = torch.empty(hi - lo, dtype=flat.dtype,
                                  device=flat.device)
            base = weights.chunk(key, index, out=tmp)
            diff = (flat[lo:hi].detach() - base).double()
            for n in names:
                k, off, size = segs[n]
                a, b = max(off, lo), min(off + size, hi)
                if k == key and a < b:
                    sq[n] += float((diff[a - lo:b - lo] ** 2).sum())
            del diff
    return {n: v ** 0.5 for n, v in sq.items()}


class Program:
    """The program's training step, as the window drives it."""

    def __init__(self, cfg, mix, seed, device):
        from container_engine_accelerators_tpu_torch.ops.xent import (
            mean_cross_entropy_loss)
        from container_engine_accelerators_tpu_torch.models.transformer import (
            next_token_loss_fn)
        from container_engine_accelerators_tpu_torch.parallel.train import (
            Sgd, Trainer)
        self.cfg, self.mix, self.device = cfg, mix, device
        self.weights = Weights(cfg, seed, device, F32)
        self.model = build_model(cfg, self.weights, int(mix["seq_len"]))
        opt = cfg["training"]
        self.trainer = Trainer(
            self.model, next_token_loss_fn(mean_cross_entropy_loss),
            Sgd(float(opt["learning_rate"]), momentum=float(opt["momentum"])),
            mfu_source="off")
        self.state = self.trainer.init_state()

    def step(self, tokens):
        self.state, loss = self.trainer.train_step(self.state,
                                                   (tokens, tokens))
        return loss

    def grad_norms(self):
        """The first gradient as the optimizer holds it: SGD's momentum
        buffer after one step is that step's gradient (none held reads
        0)."""
        opt = self.state.optimizer
        out = {}
        for name, p in self.model.named_parameters():
            buf = opt.state.get(p, {}).get("momentum_buffer")
            out[name] = 0.0 if buf is None else float(buf.norm())
        return out


def program_readings(prog, seed):
    """Steps 1-3 on their own rows: the losses, the first gradient's
    leaf norms and the leaves' change after the three. Also the
    seconds the readings themselves took (the check's, not set-up's:
    the steps are set-up's warm-up)."""
    out = {"losses": []}
    check_s = 0.0
    for k in range(1, CHECK_STEPS + 1):
        loss = prog.step(batch(prog.mix, prog.cfg, seed, k, prog.device))
        out["losses"].append(float(loss))
        if k == 1:
            t0 = time.perf_counter()
            out["grad"] = prog.grad_norms()
            check_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    out["change"] = change_norms(prog.weights, prog.weights.names())
    sync(prog.device)
    return out, check_s + time.perf_counter() - t0


def reference_readings(cfg, mix, seed, device, prec="f32", fault=None):
    """The reference's steps 1-3 from the same seed. ``fault`` plants
    one in the reference: "half" takes the loss over the first half of
    the positions, "token" alters one token of every step's row."""
    reference.exact_f32()
    weights = Weights(cfg, seed, device, F32)
    opt = cfg["training"]
    lr, mom = float(opt["learning_rate"]), float(opt["momentum"])
    names = weights.names()
    leaves = {n: weights[n].detach().requires_grad_(True) for n in names}
    params = [leaves[n] for n in names]
    seq = int(mix["seq_len"])
    out = {"losses": []}
    momentum = None
    for k in range(1, CHECK_STEPS + 1):
        rows = batch(mix, cfg, seed, k, device)
        if fault == "token":
            rows[:, seq // 2] = (rows[:, seq // 2] + 1) % int(cfg["vocab_size"])
        positions = (seq - 1) // 2 if fault == "half" else None
        total = 0.0
        for r in range(rows.shape[0]):
            loss = reference.train_loss(leaves, cfg, rows[r], prec,
                                        positions) / rows.shape[0]
            loss.backward()
            total += loss.item()
        out["losses"].append(total)
        grads = [p.grad for p in params]
        with torch.no_grad():
            if k == 1:
                out["grad"] = {n: float(leaves[n].grad.norm()) for n in names}
                momentum = [g.clone() for g in grads]
            else:
                torch._foreach_mul_(momentum, mom)
                torch._foreach_add_(momentum, grads)
            torch._foreach_add_(params, momentum, alpha=-lr)
        for p in params:
            p.grad = None
    del momentum, params, leaves
    out["change"] = change_norms(weights, names)
    del weights
    release(device)
    return out


def run(cell, args, device):
    cfg, mix = cell.config, cell.traffic
    prog = Program(cfg, mix, args.seed, device)
    readings, check_s = program_readings(prog, args.seed)
    capture = None
    if args.trace:
        devtrace.warm(device)
        capture = devtrace.Capture(device)
    tokens_per_step = int(mix["batch"]) * int(mix["seq_len"])
    trace_s = min(float(mix.get("trace_s", args.seconds)), args.seconds)
    losses, traced_steps = [], None
    if capture is not None:
        capture.start()
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - args.t_start - check_s
    k = CHECK_STEPS
    while True:
        k += 1
        losses.append(prog.step(batch(mix, cfg, args.seed, k, device)))
        now = time.perf_counter() - t0
        if capture is not None and traced_steps is None and now >= trace_s:
            capture.stop()
            traced_steps = len(losses)
            t_untraced = time.perf_counter()
        if now >= args.seconds:
            break
    sync(device)
    wall = time.perf_counter() - t0
    steps = len(losses)
    if capture is not None and traced_steps is None:
        capture.stop()
        traced_steps = steps
        t_untraced = time.perf_counter()
    # A traced run's rates are read outside the capture, which slows it.
    rate_steps, rate_wall = steps, wall
    if capture is not None:
        rate_steps = steps - traced_steps
        rate_wall = t0 + wall - t_untraced
    finite = torch.isfinite(torch.stack(losses)).sum().item()
    peak = peak_bytes(device)
    trace = (devtrace.summarize([capture.reduce()]) if capture is not None
             else None)
    del prog, losses, capture
    release(device)
    ref = reference_readings(cfg, mix, args.seed, device)
    numbers = judge.training_numbers(readings, ref)
    ctx = {"cfg": cfg, "traffic": mix, "steps": rate_steps,
           "wall_s": rate_wall, "trace": trace,
           "step_flops": flops.train_step_flops(cfg, int(mix["batch"]),
                                                int(mix["seq_len"]))}
    e2e = {"train_tokens_per_s": steps * tokens_per_step / wall,
           "setup_s": setup_s}
    return {"e2e": e2e, "attempted": steps, "failed": steps - int(finite),
            "numbers": numbers,
            "info": {"losses": readings["losses"],
                     "ref_losses": ref["losses"]},
            "peak": peak, "ctx": ctx}

"""The plain reference: a StarCoder2 block stack as the program computes
it, in f32 with TF32 off, in plain PyTorch.

Pre-LayerNorm blocks: LayerNorm (eps 1e-6), Q and KV projections with
biases, rope over the whole head in the split-halves layout at base
10000, grouped-query attention (query head h reads KV head h // G)
with the causal band (query p sees keys (p - W, p]), the output
projection, LayerNorm, a GELU (tanh) MLP of width F, and after the
last block a LayerNorm and an untied lm_head with a bias. The
departures from the published model (rope base, eps, the untied f32
head) are the program's and are listed in each configuration file.

It imports nothing of the program and takes nothing the program made:
``w`` maps the leaf names of ``lib/weights.py`` to the benchmark's
values, each cast to f32 where it is used. Attention runs in blocks of
queries, so a long sequence fits beside the weights.

``prec="fp8"`` is the control: every projection and the lm_head take
operands rounded to float8 e4m3 (per-row scales; activations per
token), the step below the bf16 the configurations state.
"""

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

LN_EPS = 1e-6
ROPE_BASE = 10000.0
QUERY_BLOCK = 512
FP8_MAX = 448.0


def exact_f32():
    """TF32 off for every f32 product of the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x):
    """``x`` rounded to float8 e4m3 with a scale a row (the last axis),
    back in f32. The gradient passes straight through."""
    scale = x.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    scale = scale / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return x + (q * scale - x).detach()


def _linear(x, weight, bias, prec):
    wt, b = weight.float(), bias.float()
    if prec == "fp8":
        x, wt = fp8_round(x), fp8_round(wt)
    return x @ wt.t() + b


def _rope(x, pos):
    """x [S, heads, D] at positions ``pos`` [S]."""
    d2 = x.shape[-1] // 2
    freqs = ROPE_BASE ** (-torch.arange(d2, dtype=torch.float32,
                                        device=x.device) / d2)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, window):
    """Causal grouped attention: q [S, H, D], k and v [S, Hkv, D] ->
    [S, H, D], in blocks of queries."""
    s, h, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    kf = k.permute(1, 2, 0)                           # [Hkv, D, S]
    vf = v.permute(1, 0, 2)                           # [Hkv, S, D]
    key_pos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, s)
        qb = q[lo:hi].reshape(hi - lo, hkv, g, d).permute(1, 2, 0, 3)
        scores = (qb.reshape(hkv, g * (hi - lo), d) @ kf) / math.sqrt(d)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        keep = key_pos[None, :] <= qpos
        if window:
            keep = keep & (key_pos[None, :] > qpos - window)
        scores = scores.view(hkv, g, hi - lo, s).masked_fill(
            ~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1).view(hkv, g * (hi - lo), s)
        ob = (probs @ vf).view(hkv, g, hi - lo, d).permute(2, 0, 1, 3)
        outs.append(ob.reshape(hi - lo, h, d))
    return torch.cat(outs, dim=0)


def block(x, w, i, cfg, prec="f32"):
    """Block ``i`` on x [S, E] f32."""
    e = x.shape[-1]
    h, hkv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d = e // h
    p = f"blocks.{i}."
    pos = torch.arange(x.shape[0], device=x.device)
    a = F.layer_norm(x, (e,), w[p + "attn.ln.weight"].float(),
                     w[p + "attn.ln.bias"].float(), LN_EPS)
    q = _linear(a, w[p + "attn.q.weight"], w[p + "attn.q.bias"], prec)
    kv = _linear(a, w[p + "attn.kv.weight"], w[p + "attn.kv.bias"], prec)
    q = _rope(q.view(-1, h, d), pos)
    kv = kv.view(-1, 2, hkv, d)
    k, v = _rope(kv[:, 0], pos), kv[:, 1]
    o = _attention(q, k, v, int(cfg.get("sliding_window") or 0))
    x = x + _linear(o.reshape(-1, h * d), w[p + "attn.proj.weight"],
                    w[p + "attn.proj.bias"], prec)
    m = F.layer_norm(x, (e,), w[p + "ln.weight"].float(),
                     w[p + "ln.bias"].float(), LN_EPS)
    m = F.gelu(_linear(m, w[p + "mlp_in.weight"], w[p + "mlp_in.bias"],
                       prec), approximate="tanh")
    return x + _linear(m, w[p + "mlp_out.weight"], w[p + "mlp_out.bias"],
                       prec)


def head(x, w, prec="f32"):
    e = x.shape[-1]
    x = F.layer_norm(x, (e,), w["ln_f.weight"].float(),
                     w["ln_f.bias"].float(), LN_EPS)
    return _linear(x, w["lm_head.weight"], w["lm_head.bias"], prec)


def embed(tokens, w):
    return w["tok_embed.weight"][tokens].float()


@torch.no_grad()
def logits(w, cfg, tokens, start, prec="f32"):
    """f32 logits [len - start, V] of the positions ``start``.. of the
    token row ``tokens`` [len] (position p predicts token p + 1)."""
    x = embed(tokens, w)
    for i in range(int(cfg["num_hidden_layers"])):
        x = block(x, w, i, cfg, prec)
    return head(x[start:], w, prec)


def train_loss(w, cfg, tokens, prec="f32", positions=None):
    """The mean next-token cross entropy of one row ``tokens`` [S], with
    autograd, each block recomputed in the backward (checkpointed) so
    the activations of S 4096 fit. ``positions``: how many of the S - 1
    predicting positions the mean takes (all by default)."""
    x = embed(tokens, w)
    for i in range(int(cfg["num_hidden_layers"])):
        x = torch.utils.checkpoint.checkpoint(
            block, x, w, i, cfg, prec, use_reentrant=False)
    n = tokens.shape[0] - 1 if positions is None else positions
    out = torch.utils.checkpoint.checkpoint(
        head, x[:n], w, prec, use_reentrant=False)
    return F.cross_entropy(out, tokens[1:n + 1])

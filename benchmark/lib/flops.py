"""The yardstick's arithmetic: parameter counts, model FLOPs, kernel
bounds and the card's peaks, all from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit
(dense rates): 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in
f32 outside them, 3.35 TB/s of HBM. A kernel's bound is the larger of
its operations over the peak of its type and its bytes (each input
read once, each output written once) over the bandwidth.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Operations a kept (query, key) pair costs a head, per unit of D:
# forward Q.K and P.V; dQ recomputes S and forms dP and dS.Q;
# dK/dV recomputes S and P and forms dP, dV and dK.
FLOPS_PER_PAIR = {"fwd": 4, "dq": 6, "dkv": 8}


def dims(cfg):
    """(E, F, H, Hkv, D, L, V, W) of a configuration file."""
    e, h = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    return (e, int(cfg["intermediate_size"]), h,
            int(cfg["num_key_value_heads"]), e // h,
            int(cfg["num_hidden_layers"]), int(cfg["vocab_size"]),
            int(cfg.get("sliding_window") or 0))


def block_params(cfg):
    """Parameters of one block: two LayerNorms, the Q, KV, output and
    two MLP projections, each with its bias."""
    e, f, h, hkv, d, _, _, _ = dims(cfg)
    return (2 * e + (e * h * d + h * d) + (e * 2 * hkv * d + 2 * hkv * d)
            + (h * d * e + e) + 2 * e + (e * f + f) + (f * e + e))


def head_params(cfg):
    """The final LayerNorm and the lm_head with its bias."""
    e, _, _, _, _, _, v, _ = dims(cfg)
    return 2 * e + e * v + v


def non_embedding_params(cfg):
    _, _, _, _, _, layers, _, _ = dims(cfg)
    return layers * block_params(cfg) + head_params(cfg)


def kept_pairs(s, window):
    """Causal (query, key) pairs of an [S] sequence that a window W
    keeps (query p sees keys (p - W, p])."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def train_step_flops(cfg, batch, seq):
    """Model FLOPs of one training step: 6 per non-embedding parameter
    (the lm_head counted) a token, plus 12·D per kept causal pair per
    head per layer (forward 4·D, backward 8·D)."""
    _, _, h, _, d, layers, _, w = dims(cfg)
    tokens = batch * seq
    return (6 * non_embedding_params(cfg) * tokens
            + 12 * d * kept_pairs(seq, w) * h * layers * batch)


def decode_token_flops(cfg, ctx):
    """Model FLOPs of one generated token at a context of ``ctx``
    positions (itself included): 2 per block and head parameter, plus
    4·D per attended key per query head per layer."""
    _, _, h, _, d, layers, _, w = dims(cfg)
    keys = min(ctx, w) if w else ctx
    return (2 * (layers * block_params(cfg) + head_params(cfg))
            + 4 * d * keys * h * layers)


def attention_bound_s(role, batch, seq, heads, d, window, elem=2):
    """The least time of one flash launch on [B, S, H, D] causal
    operands in a type of ``elem`` bytes: ``role`` "fwd", "dq" or
    "dkv". Inputs and outputs: the forward reads Q, K, V and writes O
    and the f32 LSE; dQ reads Q, K, V, dO, LSE and delta and writes dQ;
    dK/dV reads the same and writes dK and dV."""
    bsd = batch * seq * heads * d
    rows = batch * seq * heads * 4
    ops = FLOPS_PER_PAIR[role] * d * kept_pairs(seq, window) * batch * heads
    if role == "fwd":
        nbytes = 4 * bsd * elem + rows
    elif role == "dq":
        nbytes = 5 * bsd * elem + 2 * rows
    else:
        nbytes = 6 * bsd * elem + 2 * rows
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def xent_bound_s(role, rows, vocab):
    """The least time of the fused cross-entropy on f32 logits [rows,
    vocab]: the forward reads them and writes a loss a row (about 4
    operations a logit), the backward reads them and writes their
    gradient (about 6)."""
    logits = rows * vocab
    if role == "fwd":
        ops, nbytes = 4 * logits, 4 * logits + 8 * rows + 4 * rows
    else:
        ops, nbytes = 6 * logits, 8 * logits + 8 * rows + 4 * rows
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)

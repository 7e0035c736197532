"""Seeded weights of a StarCoder2-style LM, made on the device.

The benchmark owns the weights: it makes them from ``--seed`` and
hands the same values to the program and, made again from the same
seed, to the reference. Each dtype group is one flat buffer filled in
chunks of 2**28 elements, each chunk by its own ``torch.Generator`` on
the buffer's device seeded from (seed, group, chunk): a few large
calls, and any chunk can be made again alone. Every leaf is N(0,
initializer_range); LayerNorm weights are 1 plus that.

Leaves are named as the program's ``TransformerLM`` names its
parameters (a GQA model: separate Q and KV projections), in this
order; the reference reads the same names.
"""

import torch

from .traffic import derive_seed

CHUNK = 1 << 28


def leaves(cfg):
    """[(name, shape, group)]: group "main" is served in the compute
    dtype, "f32" (LayerNorms, lm_head) is held in f32 by the program
    whatever it serves."""
    e, f = int(cfg["hidden_size"]), int(cfg["intermediate_size"])
    h, hkv = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d, v = e // h, int(cfg["vocab_size"])
    out = [("tok_embed.weight", (v, e), "main")]
    for i in range(int(cfg["num_hidden_layers"])):
        p = f"blocks.{i}."
        out += [
            (p + "attn.ln.weight", (e,), "f32"),
            (p + "attn.ln.bias", (e,), "f32"),
            (p + "attn.q.weight", (h * d, e), "main"),
            (p + "attn.q.bias", (h * d,), "main"),
            (p + "attn.kv.weight", (2 * hkv * d, e), "main"),
            (p + "attn.kv.bias", (2 * hkv * d,), "main"),
            (p + "attn.proj.weight", (e, h * d), "main"),
            (p + "attn.proj.bias", (e,), "main"),
            (p + "ln.weight", (e,), "f32"),
            (p + "ln.bias", (e,), "f32"),
            (p + "mlp_in.weight", (f, e), "main"),
            (p + "mlp_in.bias", (f,), "main"),
            (p + "mlp_out.weight", (e, f), "main"),
            (p + "mlp_out.bias", (e,), "main"),
        ]
    out += [("ln_f.weight", (e,), "f32"), ("ln_f.bias", (e,), "f32"),
            ("lm_head.weight", (v, e), "f32"), ("lm_head.bias", (v,), "f32")]
    return out


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


class Weights:
    """The flat buffers and a view per leaf (``self[name]``).

    ``dtypes``: {group: dtype}; training passes f32 for both groups,
    which then share one buffer."""

    def __init__(self, cfg, seed, device, dtypes):
        self.layout = leaves(cfg)
        self.seed = int(seed)
        self.std = float(cfg["initializer_range"])
        self.device = torch.device(device)
        self.dtypes = dict(dtypes)
        # One buffer a dtype: groups of one dtype share it.
        self.group_of = {g: str(dt) for g, dt in self.dtypes.items()}
        sizes, self.offsets = {}, {}
        for name, shape, group in self.layout:
            key = self.group_of[group]
            self.offsets[name] = (key, sizes.get(key, 0), shape)
            sizes[key] = sizes.get(key, 0) + _numel(shape)
        kinds = {str(dt): dt for dt in self.dtypes.values()}
        self.flat = {k: torch.empty(n, dtype=kinds[k], device=self.device)
                     for k, n in sizes.items()}
        self.fill()

    def chunk(self, key, index, out=None):
        """Chunk ``index`` of buffer ``key`` as made from the seed (in
        ``out`` when given): N(0, std) from its own generator, then 1
        added to LayerNorm weights."""
        flat = self.flat[key]
        lo = index * CHUNK
        hi = min(lo + CHUNK, flat.numel())
        if out is None:
            out = flat[lo:hi]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(derive_seed(self.seed, "weights", key, index))
        out.normal_(0.0, self.std, generator=gen)
        for name, _, _ in self.layout:
            k, off, shape = self.offsets[name]
            if k != key or not _is_norm_weight(name):
                continue
            a, b = max(off, lo), min(off + _numel(shape), hi)
            if a < b:
                out[a - lo:b - lo] += 1.0
        return out

    def chunks(self, key):
        return -(-self.flat[key].numel() // CHUNK)

    def fill(self):
        for key in self.flat:
            for index in range(self.chunks(key)):
                self.chunk(key, index)

    def __getitem__(self, name):
        key, off, shape = self.offsets[name]
        return self.flat[key][off:off + _numel(shape)].view(shape)

    def names(self):
        return [name for name, _, _ in self.layout]

    def segment(self, name):
        """(buffer key, start, numel) of a leaf."""
        key, off, shape = self.offsets[name]
        return key, off, _numel(shape)


def _is_norm_weight(name):
    return name.endswith("ln.weight") or name == "ln_f.weight"


def load_into(model, weights, trainable):
    """Make every parameter of ``model`` (built on the meta device) the
    benchmark's view of the same name, checking names, shapes and
    dtypes: the program computes on the benchmark's values, in place."""
    params = dict(model.named_parameters())
    missing = sorted(set(weights.names()) ^ set(params))
    if missing:
        raise ValueError(f"parameter names differ from the benchmark's "
                         f"layout: {missing[:8]}")
    if list(model.buffers()):
        raise ValueError("the model holds buffers the benchmark does "
                         "not make")
    for name, param in params.items():
        view = weights[name]
        if tuple(param.shape) != tuple(view.shape) or param.dtype != view.dtype:
            raise ValueError(f"{name}: the model wants {tuple(param.shape)} "
                             f"{param.dtype}, the layout gives "
                             f"{tuple(view.shape)} {view.dtype}")
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        setattr(owner, leaf, torch.nn.Parameter(view,
                                                requires_grad=trainable))
    return model

"""The plain reference against the port's TransformerLM at tiny widths
(f32 on both sides: the comparison is of the mathematics, the
precision gap is the card's)."""

import torch

from benchmark.lib import reference
from benchmark.lib.weights import Weights, load_into

from .conftest import TINY

F32 = {"main": torch.float32, "f32": torch.float32}


def port_model(cfg, weights, trainable=False):
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM)
    model = TransformerLM(
        vocab_size=cfg["vocab_size"], embed_dim=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        max_seq_len=cfg["max_position_embeddings"],
        mlp_ratio=cfg["intermediate_size"] // cfg["hidden_size"],
        pos_embedding="rope", attention_window=cfg["sliding_window"],
        dtype=torch.float32, param_dtype=torch.float32, device="meta")
    return load_into(model, weights, trainable)


def test_logits_match_the_port():
    cfg = dict(TINY, initializer_range=0.05)
    w = Weights(cfg, 11, "cpu", F32)
    model = port_model(cfg, w)
    tokens = torch.randint(0, cfg["vocab_size"], (70,),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = model(tokens[None])[0]
    got = reference.logits(w, cfg, tokens, 0)
    # 70 > the 32 window: the band binds past position 31.
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)
    assert torch.allclose(reference.logits(w, cfg, tokens, 40), want[40:],
                          atol=2e-5, rtol=1e-5)


def test_training_loss_and_gradients_match_the_port():
    from container_engine_accelerators_tpu_torch.models.transformer import (
        next_token_loss_fn)
    from container_engine_accelerators_tpu_torch.parallel.train import (
        cross_entropy_loss)
    cfg = dict(TINY, initializer_range=0.05)
    w = Weights(cfg, 12, "cpu", F32)
    model = port_model(cfg, w, trainable=True)
    tokens = torch.randint(0, cfg["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(1))
    loss = next_token_loss_fn(cross_entropy_loss)(model(tokens), tokens)
    loss.backward()
    leaves = {n: w[n].detach().clone().requires_grad_(True)
              for n in w.names()}
    ref = reference.train_loss(leaves, cfg, tokens[0])
    ref.backward()
    assert abs(ref.item() - loss.item()) < 1e-5
    for name, p in model.named_parameters():
        assert torch.allclose(leaves[name].grad, p.grad, atol=1e-6,
                              rtol=1e-4), name


def test_fp8_control_is_coarser():
    x = torch.randn(8, 64)
    y = reference.fp8_round(x)
    err = ((y - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    assert 1e-4 < err < 0.1
    assert torch.equal(reference.fp8_round(y), y)

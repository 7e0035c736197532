"""The FLOP and bound arithmetic against hand counts at both
configurations' shapes."""

import json

import pytest

from benchmark.lib import flops

from .conftest import ROOT


def cfg(name):
    return json.loads(
        (ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def test_parameter_counts_by_hand():
    # E 4608, F 18432, 36 heads and 4 KV heads of 128: two LayerNorms
    # 4·E; Q E² + E; KV E·1024 + 1024; out E² + E; MLP 2·E·F + F + E.
    c7 = cfg("starcoder2-7b")
    block7 = (4 * 4608 + (4608 * 4608 + 4608) + (4608 * 1024 + 1024)
              + (4608 * 4608 + 4608) + (4608 * 18432 + 18432)
              + (18432 * 4608 + 4608))
    assert block7 == 217_106_944 == flops.block_params(c7)
    head7 = 2 * 4608 + 4608 * 49152 + 49152
    assert flops.head_params(c7) == head7 == 226_550_784
    assert flops.non_embedding_params(c7) == 32 * block7 + head7
    c3 = cfg("starcoder2-3b")
    assert flops.block_params(c3) == 95_979_008
    assert flops.non_embedding_params(c3) == 3_030_420_480


def test_train_step_flops_by_hand():
    c3 = cfg("starcoder2-3b")
    pairs = 4096 * 4097 // 2           # the 4096 window keeps them all
    assert flops.kept_pairs(4096, 4096) == pairs
    dense = 6 * 3_030_420_480 * 4096
    attention = 12 * 128 * pairs * 24 * 30
    assert flops.train_step_flops(c3, 1, 4096) == dense + attention
    assert dense + attention == 83_755_008_000_000


def test_window_binds_past_its_length():
    assert flops.kept_pairs(8, 3) == 3 * 4 // 2 + 5 * 3
    c7 = cfg("starcoder2-7b")
    base = 2 * 7_173_972_992
    assert flops.decode_token_flops(c7, 900) == base + 4 * 128 * 900 * 36 * 32
    assert flops.decode_token_flops(c7, 5000) == (
        base + 4 * 128 * 4096 * 36 * 32)


def test_attention_bounds_by_hand():
    ops = 4 * 128 * (4096 * 4097 // 2) * 24
    nbytes = 4 * 4096 * 24 * 128 * 2 + 4096 * 24 * 4
    assert ops / 989e12 > nbytes / 3.35e12
    assert flops.attention_bound_s("fwd", 1, 4096, 24, 128, 4096) == (
        pytest.approx(ops / 989e12, rel=1e-12))
    assert flops.attention_bound_s("dq", 1, 4096, 24, 128, 4096) == (
        pytest.approx(1.5 * ops / 989e12, rel=1e-12))
    assert flops.attention_bound_s("dkv", 1, 4096, 24, 128, 4096) == (
        pytest.approx(2 * ops / 989e12, rel=1e-12))


def test_xent_bounds_are_bytes():
    rows, vocab = 4095, 49152
    fwd = (4 * rows * vocab + 12 * rows) / 3.35e12
    bwd = (8 * rows * vocab + 12 * rows) / 3.35e12
    assert flops.xent_bound_s("fwd", rows, vocab) == pytest.approx(fwd)
    assert flops.xent_bound_s("bwd", rows, vocab) == pytest.approx(bwd)

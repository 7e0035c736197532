"""Tiny cells for the harness's CPU tests: the widths are cut, the
code paths are the cells' own."""

import json
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Logits spread about as the published widths' do (std ~1), so a
# wrong token reads as wide a gap here as on the card.
TINY = {"hidden_size": 64, "intermediate_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 2, "vocab_size": 512, "sliding_window": 32,
        "initializer_range": 0.15, "max_position_embeddings": 256,
        "serving": {"max_batch": 4},
        "training": {"learning_rate": 0.1, "momentum": 0.9}}

SERVE_MIX = {"driver": "serve", "loop": "closed", "clients": 4,
             "per_client": 40, "ramp_s": 0.5, "rate_per_s": 6,
             "prompt_len": {"dist": "lognormal", "median": 12, "sigma": 0.6,
                            "min": 4, "max": 32},
             "output_len": {"dist": "lognormal", "median": 8, "sigma": 0.5,
                            "min": 3, "max": 16},
             "buckets": [8, 16, 32], "drain_s": 10, "check_tokens": 60,
             "check_requests": 6}

TRAIN_MIX = {"driver": "train", "batch": 2, "seq_len": 48}


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_limits(name):
    return json.loads(
        (ROOT / "benchmark" / "cells" / f"{name}.json").read_text())["limits"]


@pytest.fixture
def tiny_cell():
    def make(kind, loop="closed"):
        b = bench()
        if kind == "serve":
            mix = dict(SERVE_MIX, loop=loop)
            limits = cell_limits("sc2-7b.codegen")
        else:
            mix = dict(TRAIN_MIX)
            limits = cell_limits("sc2-3b.pretrain-4k")
        return types.SimpleNamespace(
            name="tiny", config=dict(TINY), traffic=mix, limits=limits,
            chips=1, end_to_end=b["end_to_end"], per_layer=[])
    return make


@pytest.fixture
def run_args():
    from benchmark import run as bench_run
    bench_run.environment()

    def make(seed=3000000001, seconds=2):
        return bench_run.parse(["--workload", "tiny", "--seed", str(seed),
                                "--seconds", str(seconds), "--trace", "0"])
    return make

"""The control: the reference computed a step below the configured
precision, put in the program's place, comes out not correct under the
cells' limits. On the CPU at a tiny size; on the card (marked ``gpu``)
at the cells' own sizes through ``calibrate.py``."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.lib import judge, serve, train

from .conftest import ROOT, TINY, TRAIN_MIX, cell_limits


def test_training_control_is_not_correct():
    cfg = dict(TINY)
    ref = train.reference_readings(cfg, TRAIN_MIX, 5, "cpu")
    low = train.reference_readings(cfg, TRAIN_MIX, 5, "cpu", prec="fp8")
    ok, _ = judge.decide(judge.training_numbers(low, ref),
                         cell_limits("sc2-3b.pretrain-4k"))
    assert not ok


def test_serving_control_is_not_correct(tiny_cell, run_args):
    cell = tiny_cell("serve")
    args = run_args(seed=77)
    session = serve.Session(cell, args.seed, "cpu", trace=False)
    try:
        win = session.window(args.seed, args.seconds)
    finally:
        session.stop()
    sample = serve.check_sample(win, args.seed, cell.traffic)
    worst, _ = serve.served_gaps(cell.config, args.seed, "cpu", sample,
                                 control=True)
    limit = {"served_logit_gap": cell.limits["served_logit_gap"]}
    ok, _ = judge.decide({"served_logit_gap": worst["control_logit_gap"]},
                         limit)
    assert not ok, worst


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["sc2-7b.codegen", "sc2-3b.pretrain-4k"])
def test_control_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells' own sizes")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "calibrate.py"),
         "--workload", workload, "--seeds", "20261019", "--controls", "1"],
        capture_output=True, text=True, timeout=1800, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    limits = cell_limits(workload)
    for line in out.stdout.strip().splitlines():
        rec = json.loads(line)
        if rec["kind"] == "fault:token":
            continue    # no training number sees one token (PERF.md)
        # A reading holds the numbers the reference compares.
        ok, _ = judge.decide(rec["numbers"], {k: limits[k]
                                              for k in rec["numbers"]
                                              if k in limits})
        assert ok == (rec["kind"] == "program"), rec

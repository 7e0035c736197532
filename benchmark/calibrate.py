"""Readings that set a cell's correctness limits, on the card.

    python3 benchmark/calibrate.py --workload NAME --seeds 1,2,3 \
        [--seconds S] [--controls N]

For each seed, the numbers ``run.py`` compares, read from the program
as a run reads them (one process: a serving cell keeps its server and
makes each seed's weights in the same buffers; a training cell builds
its trainer anew). For the first ``--controls`` seeds also the
control's numbers, the reference computed a step below the configured
precision (float8 e4m3 operands for the bf16 products), and for a
training cell the faults planted in the reference put in the program's
place: "half" (the loss over half of the positions) and "token" (one
token of every row altered). A state left unchanged reads 1 by
``change_gap``'s measure and needs no run. One JSON line a reading;
the limits in ``benchmark/cells/`` are set from them (``PERF.md``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402


def emit(**fields):
    print(json.dumps(fields), flush=True)


def serving(cell, seeds, seconds, controls, device):
    from benchmark.lib import serve
    session = serve.Session(cell, seeds[0], device, trace=False)
    for i, seed in enumerate(seeds):
        control = i < controls
        session.reseed(seed)
        win = session.window(seed, seconds)
        e2e, attempted, failed = serve.end_to_end(win)
        sample = serve.check_sample(win, seed, cell.traffic)
        numbers, info = serve.served_gaps(cell.config, seed, device, sample,
                                          control=control)
        emit(seed=seed, kind="program", attempted=attempted, failed=failed,
             e2e=e2e, info=info,
             numbers={"served_logit_gap": numbers["served_logit_gap"]})
        if control:
            emit(seed=seed, kind="control",
                 numbers={"served_logit_gap":
                          numbers["control_logit_gap"]})
    session.stop()


def training(cell, seeds, controls, device):
    from benchmark.lib import judge, train
    from benchmark.lib.device import release
    cfg, mix = cell.config, cell.traffic
    for i, seed in enumerate(seeds):
        prog = train.Program(cfg, mix, seed, device)
        readings, _ = train.program_readings(prog, seed)
        del prog
        release(device)
        t0 = time.perf_counter()
        ref = train.reference_readings(cfg, mix, seed, device)
        ref_s = time.perf_counter() - t0
        emit(seed=seed, kind="program", reference_s=ref_s,
             losses=readings["losses"], ref_losses=ref["losses"],
             numbers=judge.training_numbers(readings, ref))
        if i >= controls:
            continue
        for kind, prec, fault in (("control", "fp8", None),
                                  ("fault:half", "f32", "half"),
                                  ("fault:token", "f32", "token")):
            other = train.reference_readings(cfg, mix, seed, device,
                                             prec=prec, fault=fault)
            emit(seed=seed, kind=kind,
                 numbers=judge.training_numbers(other, ref))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--controls", type=int, default=0)
    args = p.parse_args(argv)
    bench_run.environment()
    import torch
    from benchmark.lib import spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    seconds = args.seconds or cell.run_seconds
    if cell.traffic["driver"] == "serve":
        serving(cell, seeds, seconds, args.controls, "cuda:0")
    else:
        training(cell, seeds, args.controls, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())

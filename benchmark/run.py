"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Sets up (weights made on the card from the seed, the program built
and warmed on this cell's shapes), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints
one JSON line last: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``, then the
numbers compared beside their limits under ``compared``. The same
numbers are the last lines of standard error.

Exits non-zero, with no result, when there is no CUDA card or fewer
than the cell asks for, when JAX or the JAX package is loaded once
the window has closed, or when anything fails.
"""

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Modules that must not be loaded: JAX and the JAX package, compared by
# whole top-level name (the port's name begins with the package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "container_engine_accelerators_tpu")


def forbidden_modules(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def environment():
    """Caches at fixed paths inside the checkout, and the span journal's
    size a window's spans need."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CEA_TPU_TRACE_CAP"] = "2000000"
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    args.t_start = T_START
    return args


def execute(cell, args, device):
    """The run on ``device``: (result dict, compared lines)."""
    import torch

    from benchmark.lib import judge, serve, spec, train
    drivers = {"serve": serve.run, "train": train.run}
    out = drivers[cell.traffic["driver"]](cell, args, device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"loaded once the window closed: {found}")
    correct, lines = judge.decide(out["numbers"], cell.limits)
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(out["ctx"])
            if value is None:
                # Left out of the line, and said: a reader finds nothing
                # where the program no longer runs what it reads.
                print(f"per-layer {m['name']}: nothing to read",
                      file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out["e2e"]}
    dev = torch.device(device)
    result = {
        "correct": bool(correct),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": int(out["peak"])},
    }
    trace = out["ctx"].get("trace")
    if args.trace and trace is not None:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
        out["info"]["captures_kept"] = trace["captures"]
    # Numbers read but compared with no limit (PERF.md says why).
    result["info"] = dict(out["info"], uncompared={
        k: v for k, v in out["numbers"].items() if k not in cell.limits})
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in lines}
    return result, lines


def main(argv=None):
    args = parse(argv)
    environment()
    try:
        import torch
        from benchmark.lib import spec
        cell = spec.load_cell(args.workload)
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        result, lines = execute(cell, args, "cuda:0")
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 4
    except Exception:
        traceback.print_exc()
        return 1
    for name, value, limit in lines:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

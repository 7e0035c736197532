"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own, found by name:

- ``benchmark/configs/<config>.json``: the model, as run;
- ``benchmark/traffic/<traffic>.json``: the mix, read by one general
  generator (``lib/traffic.py``) and one driver per ``driver`` key;
- ``benchmark/cells/<workload>.json``: the cell's correctness limits;
- ``benchmark/metrics/<metric>.py``: a per-layer metric's reader; a
  metric named ``<reader>.<cell kind>`` (``device_idle_share.train``)
  may share ``<reader>.py`` with the same quantity in other cells.

A later change adds a cell by adding files and entries; no file here
needs an edit for it.
"""

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]        # benchmark/
ROOT = HERE.parent                                # the checkout
BENCHMARK_JSON = ROOT / "BENCHMARK.json"


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(path=BENCHMARK_JSON):
    return _read_json(path)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, its
    traffic, its limits and the metrics it reports."""

    def __init__(self, bench, name):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _read_json(ROOT / self.config_entry["file"])
        self.traffic = _read_json(
            HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = _read_json(HERE / "cells" / f"{name}.json")["limits"]
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]
        self.run_seconds = int(bench["run_seconds"])


def load_cell(name, path=BENCHMARK_JSON):
    return Cell(load_benchmark(path), name)


def metric_reader(name):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``,
    or, where there is none, of the file named by ``name`` less its
    last ``.`` suffix."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = HERE / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

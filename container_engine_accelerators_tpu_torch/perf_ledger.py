# Copyright 2026 The container-engine-accelerators-tpu Authors.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""The ledger writer of the port's perf rows (counterpart of the JAX
repo's tools/perf_ledger.py writer: its row schema, its validation and
its one append path, with a torch/CUDA rig fingerprint).

A row, validated field by field before it is written:

  {"source":      "torch_<harness>[:<config>]",
   "status":      "measured" | "skipped_unmeasurable",
   "metrics":     {name: finite number} ({} when skipped; every name
                   resolves to a direction in METRIC_DIRECTIONS),
   "fingerprint": {platform, device_kind, device_count, torch_version,
                   cuda_version, knobs: {CEA_TPU_*: value}},
   "provenance":  utils.provenance.stamp(devices=...),
   + optional "config", "note", "accepted"}

The fingerprint comes from ``stamp(devices=...)``: the torch and CUDA
versions and the devices' names, where the JAX writer's records only
``jax_version``; a CPU row and a card row never share one. ``source``
names start with ``torch_``, so the port's rows never mix with the JAX
package's sources.

The writer writes only to the path its caller gives, as the JAX
ledger's document ({"schema_version": 1, "rows": [...]}); it refuses
the repo's PERF_LEDGER.json (the JAX package's rows) and any
PERF_LEDGER.jsonl.

    python -m container_engine_accelerators_tpu_torch.perf_ledger \\
        append --ledger out/ledger.json --source torch_flash_bench \\
        --metric kernel_ms=0.1178 --device cuda
    python -m container_engine_accelerators_tpu_torch.perf_ledger \\
        validate --ledger out/ledger.json
"""

import argparse
import hashlib
import json
import math
import os
import sys

from . import obs
from .obs.metric_names import PERF_LEDGER_APPENDS
from .utils import env_str
from .utils.provenance import stamp

SCHEMA_VERSION = 1
SOURCE_PREFIX = "torch_"
STATUS_MEASURED = "measured"
STATUS_SKIPPED = "skipped_unmeasurable"
_STATUSES = (STATUS_MEASURED, STATUS_SKIPPED)
_ROW_KEYS = frozenset({"source", "status", "metrics", "fingerprint",
                       "provenance", "config", "note", "accepted"})
_FP_KEYS = ("platform", "device_kind", "device_count", "torch_version",
            "cuda_version", "knobs")
# Files this writer never writes: the JAX package's ledger, and the
# per-PR ledger lines kept beside it.
PROTECTED_NAMES = ("PERF_LEDGER.json", "PERF_LEDGER.jsonl")

# CEA_TPU_* knobs that change what a measurement means (the JAX
# writer's list).
FINGERPRINT_KNOBS = (
    "CEA_TPU_PAGED_KV", "CEA_TPU_KV_BLOCK", "CEA_TPU_KV_BLOCKS",
    "CEA_TPU_KV_QUANT", "CEA_TPU_KV_SPILL", "CEA_TPU_KV_SPILL_BYTES",
    "CEA_TPU_PEAK_FLOPS",
)

# Metric name (longest-prefix match) -> "up" (higher is better) or
# "down": the JAX writer's table, plus the names the port's harnesses
# report (kernel and step times, tokens a second, train MFU).
METRIC_DIRECTIONS = {
    "rows_per_step": "up", "rows_per_call": "up", "peak_rows": "up",
    "goodput_ratio": "up", "goodput_tokens_per_step": "up",
    "goodput_tokens_per_kwork": "up", "sustained_rows_ratio": "up",
    "spec_accept_ratio": "up", "accepted_tokens_per_step": "up",
    "spill_goodput_ratio": "up", "int8_rows_ratio": "up",
    "prefix_hit_rate": "up", "router_goodput_scale": "up",
    "router_affinity_hit_rate": "up", "router_overhead_ms": "down",
    "kv_block_utilization": "up", "kv_spill_hit_rate": "up",
    "batch_occupancy_avg": "up", "block_wait_tail_share": "up",
    "saturation_under_starvation": "up", "recovery_goodput_ratio": "up",
    "decode_tokens_per_sec": "up", "tflops": "up", "tflops_net": "up",
    "images_per_sec_per_chip": "up", "mfu": "up", "qps": "up",
    "largest_box_retention": "up",
    "ttft": "down", "tpot": "down",
    "fleet_fetches_per_engine_cycle": "down", "ms_per_token": "down",
    "ms_per_call": "down", "sec_per_call": "down",
    "p50_latency_steps": "down", "p99_latency_steps": "down",
    "p50_ms": "down", "p99_ms": "down", "checkpoint_badput_ratio": "down",
    "flops": "down", "bytes_accessed": "down",
    # The port's harnesses.
    "tokens_per_sec": "up", "images_per_sec": "up", "train_mfu": "up",
    "decode_mfu": "up", "kernel_ms": "down", "step_ms": "down",
    "library_ms": "down", "plain_ms": "down",
}


class LedgerError(Exception):
    """A ledger row or file violates the contract."""


def knob_values():
    """The set fingerprint knobs, as {name: raw value}."""
    knobs = {}
    for name in FINGERPRINT_KNOBS:
        value = env_str(name)
        if value is not None:
            knobs[name] = value
    return knobs


def rig_fingerprint(devices=None, knobs=None, provenance=None):
    """The comparison key of a measurement taken on ``devices`` (torch
    devices or device strings; none: the CPU), from
    ``stamp(devices=...)`` (or the ``provenance`` stamp given)."""
    devs = list(devices) if devices else ["cpu"]
    prov = provenance if provenance is not None else stamp(devices=devs)
    described = prov.get("devices") or []
    first = described[0] if described else {"type": "cpu"}
    gpu = first.get("type") == "cuda"
    return {
        "platform": "gpu" if gpu else "cpu",
        "device_kind": first.get("name", "cpu") if gpu else "cpu",
        "device_count": len(described),
        "torch_version": str(prov.get("torch_version") or "unknown"),
        "cuda_version": str(prov.get("cuda_version") or "none"),
        "knobs": dict(knobs) if knobs is not None else knob_values(),
    }


def fingerprint_label(fingerprint):
    """Short rig label + digest, for reports and the journal."""
    key = json.dumps({k: fingerprint.get(k) for k in _FP_KEYS},
                     sort_keys=True)
    digest = hashlib.sha256(key.encode()).hexdigest()[:8]
    return (f"{fingerprint.get('platform')}:{fingerprint.get('device_kind')}"
            f"x{fingerprint.get('device_count')}:torch"
            f"{fingerprint.get('torch_version')}:{digest}")


def metric_direction(name):
    """"up" or "down" (longest registered prefix); LedgerError when no
    prefix matches."""
    best = None
    for prefix in METRIC_DIRECTIONS:
        if name.startswith(prefix) and (best is None
                                        or len(prefix) > len(best)):
            best = prefix
    if best is None:
        raise LedgerError(f"metric {name!r} has no registered direction")
    return METRIC_DIRECTIONS[best]


def validate_row(row, where="row"):
    """Field-level problems with one row (empty list: it conforms)."""
    if not isinstance(row, dict):
        return [f"{where}: not an object"]
    problems = [f"{where}.{key}: unexpected field"
                for key in sorted(set(row) - _ROW_KEYS)]
    source = row.get("source")
    if not (isinstance(source, str) and source.startswith(SOURCE_PREFIX)
            and len(source) > len(SOURCE_PREFIX)):
        problems.append(f"{where}.source: want a {SOURCE_PREFIX}* name, "
                        f"got {source!r}")
    status = row.get("status")
    if status not in _STATUSES:
        problems.append(f"{where}.status: want one of {_STATUSES}, got "
                        f"{status!r}")
    metrics = row.get("metrics")
    if not isinstance(metrics, dict):
        problems.append(f"{where}.metrics: want an object, got "
                        f"{type(metrics).__name__}")
    else:
        if status == STATUS_SKIPPED and metrics:
            problems.append(f"{where}.metrics: a {STATUS_SKIPPED} row "
                            "measured nothing; metrics must be empty")
        for name, value in metrics.items():
            if not (isinstance(value, (int, float))
                    and not isinstance(value, bool)
                    and math.isfinite(value)):
                problems.append(f"{where}.metrics.{name}: want a finite "
                                f"number, got {value!r}")
            try:
                metric_direction(name)
            except LedgerError as e:
                problems.append(f"{where}.metrics.{name}: {e}")
    fp = row.get("fingerprint")
    if not isinstance(fp, dict):
        problems.append(f"{where}.fingerprint: want an object, got "
                        f"{type(fp).__name__}")
    else:
        for key in ("platform", "device_kind", "torch_version",
                    "cuda_version"):
            if not (isinstance(fp.get(key), str) and fp.get(key)):
                problems.append(f"{where}.fingerprint.{key}: want a "
                                f"non-empty string, got {fp.get(key)!r}")
        count = fp.get("device_count")
        if not (isinstance(count, int) and not isinstance(count, bool)
                and count >= 0):
            problems.append(f"{where}.fingerprint.device_count: want an "
                            f"int >= 0, got {count!r}")
        knobs = fp.get("knobs")
        if not (isinstance(knobs, dict) and all(
                isinstance(k, str) and isinstance(v, str)
                for k, v in knobs.items())):
            problems.append(f"{where}.fingerprint.knobs: want {{str: "
                            f"str}}, got {knobs!r}")
    prov = row.get("provenance")
    if not isinstance(prov, dict):
        problems.append(f"{where}.provenance: want an object, got "
                        f"{type(prov).__name__}")
    else:
        import datetime
        try:
            datetime.datetime.fromisoformat(prov.get("generated_utc"))
        except (TypeError, ValueError):
            problems.append(f"{where}.provenance.generated_utc: not an ISO "
                            f"timestamp: {prov.get('generated_utc')!r}")
        if not (isinstance(prov.get("git_sha"), str) and prov["git_sha"]):
            problems.append(f"{where}.provenance.git_sha: want a "
                            f"non-empty string, got "
                            f"{prov.get('git_sha')!r}")
    return problems


def validate_doc(doc):
    """Field-level problems with a whole ledger document."""
    if not isinstance(doc, dict):
        return ["ledger: not a JSON object"]
    problems = []
    if doc.get("schema_version") != SCHEMA_VERSION:
        problems.append(f"ledger.schema_version: want {SCHEMA_VERSION}, "
                        f"got {doc.get('schema_version')!r}")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        return problems + ["ledger.rows: want a list"]
    for i, row in enumerate(rows):
        problems.extend(validate_row(row, where=f"rows[{i}]"))
    return problems


def _check_path(path):
    if not path:
        raise LedgerError("the ledger path is the caller's to give")
    if os.path.basename(path) in PROTECTED_NAMES:
        raise LedgerError(f"refusing to write {path}: the port's rows go "
                          "to a ledger of their own")


def load_ledger(path):
    """The ledger document at ``path``; a missing file is an empty
    ledger, an unreadable one raises LedgerError."""
    if not os.path.exists(path):
        return {"schema_version": SCHEMA_VERSION, "rows": []}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise LedgerError(f"cannot read {path}: {e}")


def append_row(path, source, metrics, status=STATUS_MEASURED,
               devices=None, config=None, note=None, fingerprint=None):
    """The one writer: build the row (fingerprint and provenance from
    ``devices``), validate it and the document it joins, append, and
    journal a ``perf.ledger_append`` event and the appends counter.
    Returns the row."""
    _check_path(path)
    prov = stamp(devices=list(devices) if devices else ["cpu"])
    row = {
        "source": source,
        "status": status,
        "metrics": {k: v for k, v in (metrics or {}).items()
                    if v is not None},
        "fingerprint": (dict(fingerprint) if fingerprint is not None
                        else rig_fingerprint(devices, provenance=prov)),
        "provenance": prov,
    }
    if config is not None:
        row["config"] = config
    if note is not None:
        row["note"] = note
    problems = validate_row(row)
    if problems:
        raise LedgerError("refusing to append a non-conforming row:\n  "
                          + "\n  ".join(problems))
    doc = load_ledger(path)
    problems = validate_doc(doc)
    if problems:
        raise LedgerError(f"refusing to append to a non-conforming ledger "
                          f"{path}:\n  " + "\n  ".join(problems))
    doc["rows"].append(row)
    tmp = path + ".ledger.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    obs.event("perf.ledger_append", source=source, status=status,
              metrics=len(row["metrics"]),
              rig=fingerprint_label(row["fingerprint"]))
    obs.counter(PERF_LEDGER_APPENDS, 1, source=source)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description="The port's perf-ledger writer")
    sub = p.add_subparsers(dest="cmd", required=True)
    val = sub.add_parser("validate")
    val.add_argument("--ledger", required=True)
    app = sub.add_parser("append")
    app.add_argument("--ledger", required=True)
    app.add_argument("--source", required=True)
    app.add_argument("--metric", action="append", default=[],
                     help="name=value, repeated")
    app.add_argument("--status", default=STATUS_MEASURED,
                     choices=_STATUSES)
    app.add_argument("--device", action="append", default=[],
                     help="torch device the numbers were taken on")
    app.add_argument("--note")
    args = p.parse_args(argv)
    try:
        if args.cmd == "validate":
            problems = validate_doc(load_ledger(args.ledger))
            for problem in problems:
                print(problem)
            return 1 if problems else 0
        metrics = {}
        for item in args.metric:
            name, _, value = item.partition("=")
            metrics[name] = float(value)
        row = append_row(args.ledger, args.source, metrics,
                         status=args.status, devices=args.device or None,
                         note=args.note)
    except (LedgerError, ValueError) as e:
        print(f"perf_ledger: {e}", file=sys.stderr)
        return 1
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

"""Tracer exporters: Prometheus text, Perfetto trace_event, /varz.

The port's own copy of the JAX package's ``obs/export.py`` (less the
multi-journal merge): ``prometheus_text`` is the server's /metrics
body, histogram buckets included (the fleet collector de-cumulates
them for its exact fleet-wide merge); ``perfetto_trace`` and ``varz``
are the /debug/trace?perfetto=1 and /debug/varz payloads.
"""

import json
import os

from .identity import identity, process_label


def _escape_label(value):
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _label_str(labels, extra=None):
    pairs = dict(labels)
    if extra:
        pairs.update(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(pairs.items()))
    return "{" + inner + "}"


def _fmt(v):
    # Prometheus text wants plain decimals; repr() of a float is fine
    # but integers must not grow a trailing ".0" in le= labels.
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text(tracer):
    """Histograms, counters and gauges in Prometheus exposition
    format: the /metrics body (the fleet collector parses it)."""
    lines = []
    seen_help = set()
    # Grouped by name: the exposition format requires every line of
    # one metric family to be contiguous, and lazily-created label
    # sets (per-RPC-method histograms) would otherwise interleave
    # families in creation order and break strict parsers.
    for h in sorted(tracer.histograms(),
                    key=lambda h: (h.name,
                                   sorted(h.labels.items()))):
        counts, total_sum, total_count = h.snapshot()
        if h.name not in seen_help:
            seen_help.add(h.name)
            if h.help:
                lines.append(f"# HELP {h.name} {h.help}")
            lines.append(f"# TYPE {h.name} histogram")
        cum = 0
        for le, c in zip(h.buckets, counts):
            cum += c
            lines.append(f"{h.name}_bucket"
                         f"{_label_str(h.labels, {'le': _fmt(le)})}"
                         f" {cum}")
        cum += counts[-1]
        lines.append(f"{h.name}_bucket"
                     f"{_label_str(h.labels, {'le': '+Inf'})} {cum}")
        lines.append(f"{h.name}_sum{_label_str(h.labels)}"
                     f" {total_sum}")
        lines.append(f"{h.name}_count{_label_str(h.labels)}"
                     f" {total_count}")
    counter_names = set()
    for (name, labels), value in sorted(tracer.counters().items()):
        if name not in counter_names:
            counter_names.add(name)
            lines.append(f"# TYPE {name} counter")
        lines.append(f"{name}{_label_str(dict(labels))} {value}")
    gauge_names = set()
    for (name, labels), value in sorted(tracer.gauges().items()):
        if name not in gauge_names:
            gauge_names.add(name)
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{_label_str(dict(labels))} {value}")
    return ("\n".join(lines) + "\n") if lines else ""


def perfetto_trace(snapshot, pid=None):
    """Chrome/Perfetto trace_event JSON from a journal snapshot.

    Spans become "X" (complete) events with microsecond wall-clock
    timestamps; journal events become "i" (instant) events. Thread
    names ride as tid strings — Perfetto renders one track per
    (pid, tid) pair, which puts e.g. the serving batcher and the
    engine loop on separate labeled tracks.

    The pid is the JOURNAL's pid (its identity stamp), not the
    converting process's — a file-sourced journal keeps its origin —
    and a process_name metadata event labels the track
    ``role@host[pid]``, so journals from several processes merged
    into one file (merge_perfetto) land on distinct named process
    tracks.
    """
    ident = snapshot.get("identity") or {}
    if pid is None:
        pid = ident.get("pid") or os.getpid()
    tids = {}

    def safe_id(v):
        # Our own ids are minted below 2^53 (trace.py) and stay exact
        # ints through JSON.parse; ids PROPAGATED from foreign
        # spec-compliant clients (full 128-bit traceparent) would
        # silently lose low bits in JS consumers, so those export as
        # hex strings — still equal across every journal that carries
        # the same id, which is all the correlation needs.
        if isinstance(v, int) and abs(v) >= 2 ** 53:
            return format(v, "x")
        return v

    def tid_of(thread_name):
        # Stable small ints per thread name; metadata events below
        # attach the human-readable names.
        return tids.setdefault(thread_name, len(tids) + 1)

    events = []
    for span in snapshot.get("spans", []) + snapshot.get(
            "open_spans", []):
        dur = span.get("duration_s")
        args = dict(span.get("attrs") or {})
        args["trace_id"] = safe_id(span.get("trace_id"))
        args["span_id"] = safe_id(span.get("span_id"))
        if span.get("parent_id") is not None:
            args["parent_id"] = safe_id(span["parent_id"])
        if span.get("status") and span["status"] != "ok":
            args["status"] = span["status"]
        events.append({
            "name": span["name"],
            "cat": span["name"].split(".", 1)[0],
            "ph": "X",
            "ts": span["start_unix"] * 1e6,
            "dur": (dur if dur is not None else 0.0) * 1e6,
            "pid": pid,
            "tid": tid_of(span.get("thread", "main")),
            "args": args,
        })
    for ev in snapshot.get("events", []):
        events.append({
            "name": ev["name"],
            "cat": ev["name"].split(".", 1)[0],
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": ev["unix"] * 1e6,
            "pid": pid,
            "tid": tid_of(ev.get("thread", "main")),
            "args": dict(ev.get("fields") or {}),
        })
    for name, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    if ident:
        # Label with the pid actually used for the track — a merge
        # remap must not leave the label naming the old pid.
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": process_label(
                           dict(ident, pid=pid))}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def varz(tracer):
    """Quick-look process variables: the /debug/varz payload."""
    snap_hists = {}
    for h in tracer.histograms():
        _, total_sum, total_count = h.snapshot()
        key = h.name + _label_str(h.labels)
        snap_hists[key] = {
            "count": total_count,
            "sum_s": round(total_sum, 6),
            "p50_s": h.quantile(0.5),
            "p99_s": h.quantile(0.99),
        }
    counters = {name + _label_str(dict(labels)): value
                for (name, labels), value in
                sorted(tracer.counters().items())}
    gauges = {name + _label_str(dict(labels)): value
              for (name, labels), value in
              sorted(tracer.gauges().items())}
    with tracer._lock:
        spans = len(tracer._spans)
        events = len(tracer._events)
        open_spans = len(tracer._open)
        dropped = (tracer._dropped_spans, tracer._dropped_events)
        started = tracer._started_unix
    return {
        "tracing_enabled": tracer.enabled,
        "identity": identity(),
        "journal": {
            "capacity": tracer.capacity,
            "spans": spans,
            "open_spans": open_spans,
            "events": events,
            "dropped_spans": dropped[0],
            "dropped_events": dropped[1],
        },
        "started_unix": started,
        "histograms": snap_hists,
        "counters": counters,
        "gauges": gauges,
    }


def dump_json(obj):
    """Compact-but-diffable JSON bytes for the debug endpoints."""
    return (json.dumps(obj, indent=1, sort_keys=True) + "\n").encode()

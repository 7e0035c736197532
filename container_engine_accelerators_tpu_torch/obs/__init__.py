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

"""Observability for the port's servers: spans, histograms, the event
journal, the request ledger and trace propagation.

Own copies of the JAX package's obs modules, under the same names
(metric_names, identity, trace, propagate, reqledger, export, http,
fleet; efficiency, memory, profiler, postmortem, straggler), with the
same module-level helpers over one process-wide tracer::

    from container_engine_accelerators_tpu_torch import obs
    with obs.span("serving.prefill", prompt_tokens=64):
        ...
    with obs.span("model.attention", timed_on=q.device):
        ...                    # its record also gets ``device_s``
    obs.event("serving.engine_quarantine", reason="step")
    obs.histogram("serving_request_latency_seconds").observe(dt)

/metrics (prometheus_text), /debug/trace and /debug/varz
(debug_response) are the read side; /debug/profile (profile_response)
captures a torch.profiler trace; write_journal and obs.postmortem
write the journal to CEA_TPU_TRACE_FILE. obs.efficiency holds the MFU
and goodput ledgers, obs.memory samples the CUDA allocator, and
obs.straggler rates per-host step skew. Stdlib only at import: the
modules that read torch import it inside their calls.
"""

from .efficiency import (
    FlopsLedger,
    GoodputLedger,
    count_flops,
    peak_flops_per_chip,
    report_from_snapshots,
)
from .export import dump_json, perfetto_trace, prometheus_text, varz
from .http import TRACE_PATH, VARZ_PATH, debug_response, query_param
from .identity import identity, process_label, set_role
from .profiler import PROFILE_PATH, profile_response
from .propagate import (
    REQUEST_ID_KEY,
    TRACEPARENT_KEY,
    extract_headers,
    format_traceparent,
    inject_headers,
    parse_traceparent,
)
from .reqledger import (
    ATTRIBUTION_BUCKETS,
    GAP_BUCKETS,
    ROUTER_BUCKETS,
    SATURATION_CAUSES,
    TTFT_BUCKETS,
    RequestLedger,
    RequestTimeline,
    saturation,
)
from .trace import (
    DEFAULT_BUCKETS,
    NULL_SPAN,
    Histogram,
    Span,
    Tracer,
    get_tracer,
    write_journal,
)

TRACER = get_tracer()


def span(name, parent=None, timed_on=None, **attrs):
    """Open a span on the process-wide tracer (``timed_on``: a
    ``torch.device`` on which it is also timed; ``Tracer.span``)."""
    return TRACER.span(name, parent=parent, timed_on=timed_on, **attrs)


def event(name, **fields):
    """Record a journal event on the process-wide tracer."""
    TRACER.event(name, **fields)


def histogram(name, help_text="", labels=None, buckets=None):
    """Get-or-create a histogram on the process-wide tracer."""
    return TRACER.histogram(name, help_text, labels, buckets)


def counter(name, inc=1, **labels):
    """Increment a counter on the process-wide tracer."""
    TRACER.counter(name, inc, **labels)


def gauge(name, value, **labels):
    """Set an instantaneous gauge on the process-wide tracer."""
    TRACER.gauge(name, value, **labels)


def enabled():
    return TRACER.enabled


__all__ = [
    "ATTRIBUTION_BUCKETS", "DEFAULT_BUCKETS", "FlopsLedger", "GAP_BUCKETS",
    "GoodputLedger", "Histogram", "NULL_SPAN", "PROFILE_PATH",
    "REQUEST_ID_KEY", "ROUTER_BUCKETS", "RequestLedger",
    "RequestTimeline", "SATURATION_CAUSES", "Span", "TRACEPARENT_KEY",
    "TRACER", "TRACE_PATH", "TTFT_BUCKETS", "Tracer", "VARZ_PATH",
    "count_flops", "counter", "debug_response", "dump_json", "enabled",
    "event", "extract_headers", "format_traceparent", "gauge",
    "get_tracer", "histogram", "identity", "inject_headers",
    "parse_traceparent", "peak_flops_per_chip", "perfetto_trace",
    "process_label", "profile_response", "prometheus_text",
    "query_param", "report_from_snapshots", "saturation", "set_role",
    "span", "varz", "write_journal",
]

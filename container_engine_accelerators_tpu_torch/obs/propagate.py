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

"""W3C-``traceparent``-style context propagation over HTTP headers.

The port's own copy of the HTTP carrier of the JAX package's
``obs/propagate.py``: the header shape ``00-<trace-id-hex32>-<span-id-
hex16>-01`` under ``traceparent``, plus ``x-cea-request-id`` so one
request id survives every hop (including a router's mid-stream
failover splice, where the resubmitted sibling request must bill to
the ORIGINAL request). Ids map onto the tracer's integer trace/span
ids; foreign 128-bit trace ids round-trip as plain hex. The server
extracts both into its ``serving.request`` root span.
"""

import re

TRACEPARENT_KEY = "traceparent"
REQUEST_ID_KEY = "x-cea-request-id"

# Request ids on the wire: short printable tokens only — anything
# else is dropped (a hostile or corrupted header must not flow into
# logs/ledgers verbatim), mirroring parse_traceparent's posture.
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# version 00, 16-byte trace id, 8-byte parent id, flags byte.
_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$")


def format_traceparent(context):
    """(trace_id, span_id) -> a traceparent header value.

    flags are always 01 (sampled): a context is only injected when
    the caller actually recorded a span.
    """
    trace_id, span_id = context
    return "00-%032x-%016x-01" % (trace_id & (1 << 128) - 1,
                                  span_id & (1 << 64) - 1)


def parse_traceparent(value):
    """Header value -> (trace_id, span_id), or None when malformed.

    Malformed values are DROPPED, never raised: a bad header from an
    old client must not fail the RPC it rides on (the W3C spec's
    restart-the-trace behavior).
    """
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if not m:
        return None
    trace_id, span_id = int(m.group(1), 16), int(m.group(2), 16)
    if not trace_id or not span_id:  # all-zero ids are invalid per spec
        return None
    return (trace_id, span_id)


def inject_headers(context, request_id=None, headers=None):
    """Stamp the carrier onto an HTTP header dict and return it.

    ``context`` is a (trace_id, span_id) tuple (None injects no
    traceparent — an untraced caller still carries its request id);
    ``headers`` is mutated in place when given, else a fresh dict
    comes back, so callers can fold the carrier into an existing
    header set: ``inject_headers(ctx, rid, {"Content-Type": ...})``.
    """
    if headers is None:
        headers = {}
    if context is not None:
        headers[TRACEPARENT_KEY] = format_traceparent(context)
    if request_id:
        headers[REQUEST_ID_KEY] = str(request_id)
    return headers


def _header_get(headers, key):
    """Case-insensitive single-header lookup over whatever mapping
    the HTTP stack hands us (email.message.Message is already
    case-insensitive; a plain dict is not)."""
    if headers is None:
        return None
    getter = getattr(headers, "get", None)
    if getter is not None:
        value = getter(key)
        if value is not None:
            return value
    try:
        items = headers.items()
    except (AttributeError, TypeError):
        return None
    for k, v in items:
        if isinstance(k, str) and k.lower() == key:
            return v
    return None


def extract_headers(headers):
    """(parent context or None, request id or None) from HTTP request
    headers.

    The W3C restart-the-trace posture end to end: a malformed or
    absent ``traceparent`` yields None (the server opens a fresh root
    span), never a raise; a malformed request id is dropped the same
    way (the server mints its own). ``headers`` may be any mapping —
    ``BaseHTTPRequestHandler.headers``, a plain dict, or None.
    """
    context = None
    value = _header_get(headers, TRACEPARENT_KEY)
    if value is not None:
        context = parse_traceparent(str(value))
    request_id = _header_get(headers, REQUEST_ID_KEY)
    if request_id is not None:
        request_id = str(request_id).strip()
        if not _REQUEST_ID_RE.match(request_id):
            request_id = None
    return context, request_id

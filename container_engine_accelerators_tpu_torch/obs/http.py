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

"""The /debug/* HTTP surface of the port's servers (own copy of the
JAX package's ``obs/http.py``):

  /debug/trace   journal snapshot (completed + open spans, events)
                 as JSON; ?perfetto=1 returns Chrome/Perfetto
                 trace_event JSON directly
  /debug/varz    counters + histogram summaries + journal occupancy
"""

from .export import dump_json, perfetto_trace, varz

TRACE_PATH = "/debug/trace"
VARZ_PATH = "/debug/varz"


def query_param(query, key, default=None):
    """First ``key=value`` value in a raw query string, or
    ``default``. The ONE ?key=value scanner every /debug/* endpoint
    shares (typed parsing — int/float, junk policy — stays at the
    call site, where the endpoint's error contract lives)."""
    for part in (query or "").split("&"):
        name, _, value = part.partition("=")
        if name == key:
            return value
    return default


def debug_response(tracer, path, query=""):
    """(content_type, body_bytes) for a debug path, or None when the
    path is not a debug endpoint."""
    if path == TRACE_PATH:
        snap = tracer.snapshot()
        if "perfetto" in query:
            return ("application/json",
                    dump_json(perfetto_trace(snap)))
        return ("application/json", dump_json(snap))
    if path == VARZ_PATH:
        return ("application/json", dump_json(varz(tracer)))
    return None

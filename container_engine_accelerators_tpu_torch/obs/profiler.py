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
"""On-demand torch.profiler capture behind ``/debug/profile``
(counterpart of the JAX package's ``obs/profiler.py``, under its
names).

``GET /debug/profile?seconds=N`` captures N seconds of
``torch.profiler`` trace (CPU and, where there is a card, CUDA
activity) into a fresh directory under ``CEA_TPU_PROFILE_DIR`` (the
system temp directory by default) and answers with the artifact path
and the Chrome trace file in it. Three rules, the JAX package's:

  - ONE capture at a time, process-wide: a second concurrent request
    gets HTTP 409;
  - the artifact path lands in the journal (``profiler.capture``
    event) and ``tpu_profile_captures_total`` counts captures;
  - where the profiler cannot run (no torch; a failing start), the
    endpoint answers a documented error JSON with HTTP 501, never a
    traceback.

The capture runs on the HTTP handler's thread while the serving engine
steps on its own. CUPTI records the card's kernels whatever thread
launched them; the CPU side holds the operators of the thread that
started the profiler only (the handler's, which sleeps), so a serving
window is read from its CUDA rows. torch.profiler's experimental
``profile_all_threads`` switch would add the engine thread's
operators, but with it on the CUDA rows went missing from captures on
an H100 (torch 2.11), so it stays off. The first capture of a process
pays the profiler's start-up (``start_s`` in the answer: 9-15 s on an
H100 in a process that had just loaded its model, with the GIL held,
so every thread waits) before its window opens. torch is imported inside the
capture only.
"""

import json
import os
import tempfile
import threading
import time

from ..utils import env_str
from .metric_names import PROFILE_CAPTURES
from .trace import get_tracer

PROFILE_PATH = "/debug/profile"
CAPTURE_EVENT = "profiler.capture"
OUT_DIR_ENV = "CEA_TPU_PROFILE_DIR"
TRACE_NAME = "trace.json"

DEFAULT_SECONDS = 1.0
MAX_SECONDS = 60.0


class ProfilerBusy(Exception):
    """A capture is already in progress (the 409 surface)."""


class ProfilerUnavailable(Exception):
    """torch.profiler cannot run in this process (the 501 surface)."""


def start_profiler():
    """A started torch.profiler.profile over CPU and, with a card, CUDA
    activity. Raises ProfilerUnavailable where it cannot start."""
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
    except ImportError as e:
        raise ProfilerUnavailable(
            f"torch.profiler not importable here: {e!r}")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except (RuntimeError, AssertionError) as e:
        raise ProfilerUnavailable(
            f"torch.profiler failed to start: {e!r}")
    return prof


class ProfileCapture:
    """One-at-a-time guarded torch.profiler capture."""

    def __init__(self, tracer=None):
        self._tracer = tracer or get_tracer()
        self._lock = threading.Lock()
        self._captures = 0
        self._last = None

    def capture(self, seconds=DEFAULT_SECONDS, out_dir=None):
        """Trace for ``seconds``; returns {artifact, trace, seconds,
        start_s (the profiler's own start-up, before the window),
        capture_unix}. Raises ProfilerBusy when a capture is running,
        ProfilerUnavailable when torch.profiler cannot run here."""
        seconds = min(max(float(seconds), 0.01), MAX_SECONDS)
        if not self._lock.acquire(blocking=False):
            raise ProfilerBusy("profiler capture already in progress")
        try:
            base = out_dir or env_str(OUT_DIR_ENV) or tempfile.gettempdir()
            os.makedirs(base, exist_ok=True)
            # mkdtemp, not a timestamp name: two captures inside one
            # second must not share a directory.
            artifact = tempfile.mkdtemp(
                prefix=f"tpu-profile-{int(time.time())}-", dir=base)
            t0 = time.perf_counter()
            prof = start_profiler()
            start_s = time.perf_counter() - t0
            try:
                time.sleep(seconds)
            finally:
                # Stop whatever happens after the start: a profiler
                # left running blocks every later capture and taxes
                # the workload.
                prof.stop()
            trace = os.path.join(artifact, TRACE_NAME)
            prof.export_chrome_trace(trace)
            result = {"artifact": artifact, "trace": trace,
                      "seconds": seconds, "start_s": start_s,
                      "capture_unix": time.time()}
            self._captures += 1
            self._last = result
            self._tracer.event(CAPTURE_EVENT, artifact=artifact,
                               seconds=seconds)
            self._tracer.counter(PROFILE_CAPTURES)
            return result
        finally:
            self._lock.release()

    def busy(self):
        """True while a capture holds the guard (test seam)."""
        if self._lock.acquire(blocking=False):
            self._lock.release()
            return False
        return True

    def last(self):
        return self._last


# Process-wide: the one-at-a-time guard spans every HTTP surface of
# the process (they share torch's one profiler).
CAPTURE = ProfileCapture()


def _parse_seconds(query):
    from .http import query_param

    value = query_param(query, "seconds")
    return DEFAULT_SECONDS if value is None else float(value)


def profile_response(path, query=""):
    """(http_status, content_type, body_bytes) for /debug/profile, or
    None when ``path`` is another endpoint."""
    if path != PROFILE_PATH:
        return None

    def reply(status, payload):
        return (status, "application/json",
                (json.dumps(payload) + "\n").encode())

    try:
        seconds = _parse_seconds(query)
    except ValueError:
        return reply(400, {"error": "seconds must be a number"})
    try:
        result = CAPTURE.capture(seconds)
    except ProfilerBusy as e:
        return reply(409, {"error": str(e), "busy": True})
    except ProfilerUnavailable as e:
        return reply(501, {"error": str(e), "available": False})
    except Exception as e:  # a debug surface answers, never a traceback
        return reply(500, {"error": f"capture failed: {e!r}"})
    return reply(200, dict(result, ok=True))

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
"""Straggler detection over per-host step-time windows (counterpart of
the JAX package's ``obs/straggler.py``, under its names).

One slow host gates every synchronous step of a multi-host run. The
detector holds a sliding window of step times per host, compares each
host's window median with the fleet median, and

  - publishes every host's skew ratio as the
    ``tpu_train_step_skew_ratio{host=...}`` gauge (1.0 = at the fleet
    median), and
  - emits exactly ONE ``straggler.detected`` journal event per episode
    (hysteresis: a flagged host must drop back under the recovery
    threshold, which emits ``straggler.recovered``, before it can be
    flagged again).

``parallel.train.Trainer(straggler=...)`` feeds its own host's step
times live; ``scan_events()`` replays ``train.step_summary`` journal
events from merged journals, the offline fleet view.
"""

import statistics
import threading
from collections import deque

from .metric_names import TRAIN_STEP_SKEW as SKEW_GAUGE
from .trace import get_tracer

DETECTED_EVENT = "straggler.detected"
RECOVERED_EVENT = "straggler.recovered"

DEFAULT_WINDOW = 32
DEFAULT_FACTOR = 1.5
DEFAULT_MIN_SAMPLES = 8


class StragglerDetector:
    """Per-host sliding-window skew against the fleet median."""

    def __init__(self, window=DEFAULT_WINDOW, factor=DEFAULT_FACTOR,
                 min_samples=DEFAULT_MIN_SAMPLES, recovery_factor=None,
                 tracer=None):
        if window < 1:
            raise ValueError(f"window must be >= 1: {window}")
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1.0: {factor}")
        self._window = int(window)
        self._factor = float(factor)
        # The re-arm threshold sits halfway back toward the median, so
        # a host oscillating at ``factor`` yields one episode.
        self._recovery = (float(recovery_factor)
                          if recovery_factor is not None
                          else 1.0 + (self._factor - 1.0) / 2.0)
        self._min_samples = max(1, int(min_samples))
        self._tracer = tracer or get_tracer()
        self._lock = threading.Lock()
        self._steps = {}       # host -> deque[step_time_s]
        self._data_waits = {}  # host -> deque[data_wait_s]
        self._flagged = set()
        self._events = 0

    def observe(self, host, step_time_s, data_wait_s=None):
        """Record one step for ``host`` and re-rate that host."""
        host = str(host)
        with self._lock:
            dq = self._steps.get(host)
            if dq is None:
                dq = self._steps[host] = deque(maxlen=self._window)
                self._data_waits[host] = deque(maxlen=self._window)
            dq.append(float(step_time_s))
            if data_wait_s is not None:
                self._data_waits[host].append(float(data_wait_s))
        self._evaluate(host)

    def skews(self):
        """{host: host-window-median / fleet-median} over hosts with
        enough samples; empty until two hosts qualify."""
        with self._lock:
            medians = {h: statistics.median(dq)
                       for h, dq in self._steps.items()
                       if len(dq) >= self._min_samples}
        if len(medians) < 2:
            return {}
        fleet = statistics.median(medians.values())
        if fleet <= 0:
            return {}
        return {h: m / fleet for h, m in medians.items()}

    def _evaluate(self, host):
        """Re-rate the OBSERVED host only: its gauge and its flag
        transition."""
        ratio = self.skews().get(host)
        if ratio is None:
            return
        self._tracer.gauge(SKEW_GAUGE, round(ratio, 4), host=host)
        with self._lock:
            flagged = host in self._flagged
            if not flagged and ratio > self._factor:
                self._flagged.add(host)
                self._events += 1
                fire, name = True, DETECTED_EVENT
            elif flagged and ratio <= self._recovery:
                self._flagged.discard(host)
                fire, name = True, RECOVERED_EVENT
            else:
                fire = False
            waits = self._data_waits.get(host)
            data_wait_ms = (round(statistics.median(waits) * 1e3, 3)
                            if waits else None)
            samples = len(self._steps[host])
            host_p50_s = statistics.median(self._steps[host])
        if fire:
            self._tracer.event(
                name, host=host, skew_ratio=round(ratio, 4),
                threshold=self._factor, window=self._window,
                samples=samples,
                step_time_p50_ms=round(host_p50_s * 1e3, 3),
                data_wait_p50_ms=data_wait_ms)

    def flagged(self):
        with self._lock:
            return sorted(self._flagged)

    def event_count(self):
        """Number of straggler.detected events emitted (test seam)."""
        with self._lock:
            return self._events


def scan_events(events, window=DEFAULT_WINDOW, factor=DEFAULT_FACTOR,
                min_samples=DEFAULT_MIN_SAMPLES, tracer=None):
    """Replay ``train.step_summary`` events (one or several journals)
    through a fresh detector in timestamp order; returns it. Rows
    without the expected fields are skipped."""
    det = StragglerDetector(window=window, factor=factor,
                            min_samples=min_samples, tracer=tracer)
    rows = [e for e in events
            if e.get("name") == "train.step_summary"
            and isinstance(e.get("fields"), dict)]
    for ev in sorted(rows, key=lambda e: e.get("unix", 0.0)):
        f = ev["fields"]
        host, p50 = f.get("host"), f.get("step_time_p50_ms")
        if host is None or p50 is None:
            continue
        wait = f.get("data_wait_p50_ms")
        det.observe(host, p50 / 1e3,
                    wait / 1e3 if wait is not None else None)
    return det

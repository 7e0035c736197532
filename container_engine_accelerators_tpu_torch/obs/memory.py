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
"""Live device-memory telemetry from the workload's point of view
(counterpart of the JAX package's ``obs/memory.py``, under its names).

``device_memory_stats`` reads the CUDA caching allocator from inside
the process (``torch.cuda.memory_stats``): bytes allocated now, the
allocator's peak, and the card's total memory as the limit
(``torch.cuda.mem_get_info``). Per-device gauges:

  tpu_hbm_bytes_in_use{device=...}   allocated bytes right now
  tpu_hbm_peak_bytes{device=...}     high watermark since the monitor
                                     started (the allocator's peak or
                                     a sampled in-use, whichever is
                                     higher, kept across samples)
  tpu_hbm_bytes_limit{device=...}    the card's total memory

The monitor keeps its own watermark: a caller may reset the
allocator's peak (``torch.cuda.reset_peak_memory_stats``) between two
samples, and the watermark must not fall with it. Crossing
``CEA_TPU_HBM_SOFT_LIMIT`` (fraction of the limit, default 0.9) emits
ONE ``memory.pressure`` journal event per episode, with hysteresis
(``memory.pressure_recovered`` re-arms it). The monitor registers as a
postmortem state provider, so a flight record carries the last
watermarks.

A process without a CUDA device (a CPU run; a process without torch)
reports nothing: an empty dict is the documented degraded answer,
never a raise. torch is imported inside the sampling call only.
"""

import threading
import time

from ..utils import env_number
from .metric_names import (
    HBM_BYTES_IN_USE as IN_USE_GAUGE,
    HBM_BYTES_LIMIT as LIMIT_GAUGE,
    HBM_PEAK_BYTES as PEAK_GAUGE,
)
from .trace import get_tracer

PRESSURE_EVENT = "memory.pressure"
RECOVERED_EVENT = "memory.pressure_recovered"

SOFT_LIMIT_ENV = "CEA_TPU_HBM_SOFT_LIMIT"
DEFAULT_SOFT_LIMIT = 0.9
# Hysteresis: a device must drop this far back under the soft limit
# before another pressure event can fire (fractions of the limit).
RECOVERY_MARGIN = 0.05

STATE_PROVIDER_NAME = "hbm_memory"


def _cuda_devices():
    """Every visible CUDA device, or [] (no torch, no card)."""
    try:
        import torch
    except ImportError:
        return []
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _allocator_stats(device):
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of one device, or
    None where it has no allocator statistics. ``device`` is a torch
    device (or its string), or any object with a ``memory_stats()``
    method returning that dict."""
    if hasattr(device, "memory_stats"):
        return device.memory_stats()
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    if not stats:
        return None
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": total}


def device_memory_stats(devices=None):
    """{device_label: {bytes_in_use, peak_bytes_in_use, bytes_limit}}
    for every device (default: every visible CUDA device) that reports
    allocator statistics. A CPU device contributes nothing."""
    if devices is None:
        devices = _cuda_devices()
    out = {}
    for d in devices:
        try:
            stats = _allocator_stats(d)
        except (RuntimeError, ValueError):
            stats = None
        if not stats:
            continue
        out[str(d)] = {
            "bytes_in_use": stats.get("bytes_in_use"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "bytes_limit": stats.get("bytes_limit"),
        }
    return out


class MemoryMonitor:
    """Samples allocator stats into gauges and a watermark tracker.

    ``sample(min_interval_s=N)`` is safe on a hot loop: inside the
    interval it returns the cached stats without touching the device.
    All state is behind one lock; the serving loop and the /stats
    handler threads sample concurrently.
    """

    def __init__(self, soft_limit=None, tracer=None):
        if soft_limit is None:
            soft_limit = env_number(SOFT_LIMIT_ENV, DEFAULT_SOFT_LIMIT)
        self.soft_limit = soft_limit
        self._tracer = tracer or get_tracer()
        self._lock = threading.Lock()
        self._watermarks = {}     # device -> peak bytes seen
        self._last_sample = {}
        self._last_sample_t = None
        self._pressured = set()   # devices in an open episode

    def sample(self, devices=None, min_interval_s=0.0):
        """Sample every device, publish gauges, update watermarks and
        fire or clear pressure episodes. Returns the per-device stats
        (the cached ones inside ``min_interval_s``)."""
        with self._lock:
            if (min_interval_s and self._last_sample_t is not None
                    and time.monotonic() - self._last_sample_t
                    < min_interval_s):
                return dict(self._last_sample)
        stats = device_memory_stats(devices)
        fire = []
        with self._lock:
            self._last_sample = stats
            self._last_sample_t = time.monotonic()
            for dev, s in stats.items():
                in_use = s.get("bytes_in_use")
                limit = s.get("bytes_limit")
                peak = s.get("peak_bytes_in_use")
                if in_use is None:
                    continue
                mark = max(self._watermarks.get(dev, 0), in_use,
                           peak or 0)
                self._watermarks[dev] = mark
                self._tracer.gauge(IN_USE_GAUGE, in_use, device=dev)
                self._tracer.gauge(PEAK_GAUGE, mark, device=dev)
                if not limit:
                    continue
                self._tracer.gauge(LIMIT_GAUGE, limit, device=dev)
                frac = in_use / limit
                if dev not in self._pressured and frac >= self.soft_limit:
                    self._pressured.add(dev)
                    fire.append((PRESSURE_EVENT, dev, in_use, limit,
                                 frac))
                elif dev in self._pressured and frac <= max(
                        0.0, self.soft_limit - RECOVERY_MARGIN):
                    self._pressured.discard(dev)
                    fire.append((RECOVERED_EVENT, dev, in_use, limit,
                                 frac))
        for name, dev, in_use, limit, frac in fire:
            self._tracer.event(
                name, device=dev, bytes_in_use=int(in_use),
                bytes_limit=int(limit), fraction=round(frac, 4),
                soft_limit=self.soft_limit)
        return stats

    def watermarks(self):
        with self._lock:
            return dict(self._watermarks)

    def totals(self):
        """/stats' view: summed current in-use bytes and summed
        watermarks over the devices, or Nones where no device reports
        allocator stats (a CPU run)."""
        with self._lock:
            stats, marks = self._last_sample, self._watermarks
            in_use = [s["bytes_in_use"] for s in stats.values()
                      if s.get("bytes_in_use") is not None]
            return {
                "hbm_in_use_bytes": sum(in_use) if in_use else None,
                "hbm_peak_bytes": sum(marks.values()) if marks else None,
            }

    def state(self):
        """JSON-safe snapshot for the postmortem flight record."""
        with self._lock:
            return {
                "soft_limit": self.soft_limit,
                "watermarks": dict(self._watermarks),
                "last_sample": dict(self._last_sample),
                "pressured": sorted(self._pressured),
            }


_MONITOR = None
_monitor_lock = threading.Lock()


def get_monitor():
    """The process-wide monitor (one watermark history a process)."""
    global _MONITOR
    with _monitor_lock:
        if _MONITOR is None:
            _MONITOR = MemoryMonitor()
        return _MONITOR


def install_postmortem_provider(monitor=None):
    """Register the monitor as a postmortem state provider, so SIGTERM
    and crash flight records carry the last watermarks."""
    from . import postmortem

    postmortem.register_state_provider(
        STATE_PROVIDER_NAME, (monitor or get_monitor()).state)

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

"""Deterministic fault injection for serving survivability drills.

The port's own copy of the JAX package's ``utils/faults.py``: the slot
engine calls :func:`fire` where a device-side error would surface (the
decode step, an admission prefill, a spill-tier rehydrate upload), and
a **fault plan** names the invocation indices at which the call raises
:class:`InjectedFault` (a ``RuntimeError``, so the serving loop's
device-error handling sees exactly what a CUDA failure would look
like). The port fires at the JAX engine's sites, so a plan fires at
the same invocation of the same trace on both sides.

A plan is a JSON object mapping op name to a list of 0-based
invocation indices, counted from plan installation::

    {"step": [12], "prefill": [2], "hydrate": [0]}

Plans come from ``CEA_TPU_FAULT_PLAN`` (the env carries the JSON
inline; parsed lazily on first use) or programmatically via
:func:`install` (installation resets the per-op counters). With no
plan installed, :func:`fire` is a single module-global check.
"""

import json
import threading

from . import env_str

FAULT_PLAN_ENV = "CEA_TPU_FAULT_PLAN"

# The injectable sites: the decode step, the admission prefill, the
# spill-tier rehydrate upload.
FAULT_OPS = ("step", "prefill", "hydrate")


class InjectedFault(RuntimeError):
    """The injected device-side failure. A RuntimeError subclass so
    every handler written for real device errors fires identically."""


class FaultPlan:
    """One parsed plan: per-op invocation counters plus the index
    sets at which to raise. Counters are plan-scoped — installing a
    plan starts every op at 0, so warm-up traffic before the install
    never shifts the planned indices."""

    def __init__(self, spec):
        if not isinstance(spec, dict):
            raise ValueError(
                f"fault plan must be a JSON object mapping op to "
                f"index list, got: {type(spec).__name__}")
        unknown = sorted(set(spec) - set(FAULT_OPS))
        if unknown:
            raise ValueError(
                f"unknown fault op(s) {unknown}; valid: "
                f"{list(FAULT_OPS)}")
        self._at = {}
        for op, indices in spec.items():
            if not isinstance(indices, (list, tuple)):
                raise ValueError(
                    f"fault plan op {op!r} must map to a list of "
                    f"indices")
            self._at[op] = {int(i) for i in indices}
            if any(i < 0 for i in self._at[op]):
                raise ValueError(
                    f"fault plan op {op!r} has a negative index")
        self._lock = threading.Lock()
        self._count = dict.fromkeys(FAULT_OPS, 0)
        self._fired = {op: [] for op in FAULT_OPS}

    def fire(self, op):
        """Count one invocation of ``op``; raise InjectedFault when
        the plan names this index."""
        with self._lock:
            idx = self._count[op]
            self._count[op] = idx + 1
            hit = idx in self._at.get(op, ())
            if hit:
                self._fired[op].append(idx)
        if hit:
            raise InjectedFault(
                f"injected {op} fault at invocation {idx} "
                f"({FAULT_PLAN_ENV})")

    def counts(self):
        with self._lock:
            return dict(self._count)

    def fired(self):
        """{op: [indices that actually raised]}: a drill asserts its
        planned faults really fired (an episode whose injection
        never landed tested nothing)."""
        with self._lock:
            return {op: list(v) for op, v in self._fired.items() if v}

    def pending(self):
        """Planned indices not yet reached (diagnostic surface)."""
        with self._lock:
            return {op: sorted(i for i in at if i >= self._count[op])
                    for op, at in self._at.items()
                    if any(i >= self._count[op] for i in at)}


_lock = threading.Lock()
_plan = None
_loaded = False


def install(spec):
    """Install a plan (dict spec or FaultPlan) programmatically,
    resetting the per-op counters. Returns the active FaultPlan."""
    global _plan, _loaded
    plan = spec if isinstance(spec, FaultPlan) else FaultPlan(spec)
    with _lock:
        _plan = plan
        _loaded = True
    return plan


def reset():
    """Drop any installed plan and re-arm the lazy env parse (test
    isolation seam, mirroring postmortem.uninstall)."""
    global _plan, _loaded
    with _lock:
        _plan = None
        _loaded = False


def active():
    """The installed FaultPlan, parsing CEA_TPU_FAULT_PLAN on first
    use; None when no plan is configured."""
    global _plan, _loaded
    if _loaded:
        return _plan
    with _lock:
        if not _loaded:
            spec = env_str(FAULT_PLAN_ENV)
            _plan = FaultPlan(json.loads(spec)) if spec else None
            _loaded = True
    return _plan


def fire(op):
    """The engine-side hook: a no-op (one global read) without a
    plan; counts and possibly raises InjectedFault with one."""
    plan = _plan if _loaded else active()
    if plan is not None:
        plan.fire(op)

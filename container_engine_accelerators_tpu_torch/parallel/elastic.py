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

"""Elastic training supervision: eviction policy and mesh reshape
(counterpart of container_engine_accelerators_tpu/parallel/elastic.py).

- ``EvictionPolicy`` turns measured signals into eviction verdicts: a
  host whose skew ratio exceeds ``skew_factor`` (``CEA_TPU_EVICT_SKEW``)
  for ``skew_windows`` consecutive windows (``CEA_TPU_EVICT_WINDOWS``),
  a host whose health went DOWN, or a host whose liveness ping is more
  than ``stale_after_s`` old (``CEA_TPU_EVICT_STALE_S``).
- ``ElasticSupervisor`` owns the fleet view: an eviction emits exactly
  one ``train.eviction`` journal event per departed host and one
  ``train.reshape`` event per episode on the port's tracer, bumps
  ``tpu_train_recovery_total{reason=...}``, recomputes the mesh over
  the survivors (``mesh.reshape_spec``: 4x2 -> 3x2, or the 1-D
  fallback) and reassigns the departed hosts' data shards
  (``data.reassign_shards``). The ``ReshapePlan`` is what a launcher
  needs to relaunch the survivors; an in-process fleet calls
  ``rebuild()`` instead, which rebinds a Trainer to the reshaped mesh
  and restores the newest checkpoint laid out for it.

A host's devices are ranks of the world (``host_devices`` maps each
host to its ranks). A ``DeviceMesh`` makes its axis groups collectively
over the whole world, so ``rebuild()`` is called on every rank, the
departed ones too: every rank takes part in building the survivors'
mesh, in which a departed rank holds no coordinate (``grid_mesh``
allows that), and a departed rank then returns without a Trainer. A
process that really died cannot take part: a fleet that lost one
relaunches from the ``ReshapePlan`` (a new world over the survivors).

The recovery wall time lands in the goodput ledger's ``restart``
bucket and rides the ``train.recovered`` event (``recovery_s``), so
the offline goodput replay attributes it the same way.
"""

import dataclasses
import logging
import time

from .. import obs
from ..obs.metric_names import TRAIN_RECOVERY
from ..utils import env_number
from .data import reassign_shards, shard_assignment
from .mesh import build_mesh, reshape_spec

log = logging.getLogger("cea_tpu.elastic")

EVICTION_EVENT = "train.eviction"
RESHAPE_EVENT = "train.reshape"
RECOVERED_EVENT = "train.recovered"
RECOVERY_COUNTER = TRAIN_RECOVERY

EVICT_SKEW_ENV = "CEA_TPU_EVICT_SKEW"
EVICT_WINDOWS_ENV = "CEA_TPU_EVICT_WINDOWS"
EVICT_STALE_ENV = "CEA_TPU_EVICT_STALE_S"

DEFAULT_SKEW_FACTOR = 2.0
DEFAULT_SKEW_WINDOWS = 3
DEFAULT_STALE_AFTER_S = 10.0

REASON_STRAGGLER = "straggler"
REASON_HEALTH = "health_down"
REASON_HUNG = "host_hung"


class FleetExhausted(RuntimeError):
    """Eviction would leave fewer hosts than ``min_hosts``: the
    operator gets the failure instead of a 0-host 'recovery'."""


@dataclasses.dataclass
class ReshapePlan:
    """Everything a launcher needs to rebuild after an eviction."""

    evicted: list          # [(host, reason)] this recovery removed
    survivors: list        # hosts, in stable (original) order
    old_spec: object       # MeshSpec before
    mesh_spec: object      # MeshSpec after (reshape_spec result)
    assignment: dict       # {host: [shard indices]} after
    resume_step: object = None  # latest checkpoint step, if known

    @property
    def worker_ids(self):
        """{host: new contiguous worker id}: the relaunched world's
        ranks 0..n-1 over the survivors."""
        return {h: i for i, h in enumerate(self.survivors)}


class EvictionPolicy:
    """Signals in, eviction verdicts out. Stateless except for the
    consecutive-skew-breach counters (one noisy window must not
    evict)."""

    def __init__(self, skew_factor=None, skew_windows=None,
                 stale_after_s=None):
        self.skew_factor = (float(skew_factor) if skew_factor is not None
                            else env_number(EVICT_SKEW_ENV,
                                            DEFAULT_SKEW_FACTOR))
        self.skew_windows = (int(skew_windows) if skew_windows is not None
                             else env_number(EVICT_WINDOWS_ENV,
                                             DEFAULT_SKEW_WINDOWS,
                                             parse=int))
        self.stale_after_s = (float(stale_after_s)
                              if stale_after_s is not None
                              else env_number(EVICT_STALE_ENV,
                                              DEFAULT_STALE_AFTER_S))
        if self.skew_factor <= 1.0:
            raise ValueError(
                f"skew_factor must be > 1.0: {self.skew_factor}")
        if self.skew_windows < 1:
            raise ValueError(
                f"skew_windows must be >= 1: {self.skew_windows}")
        self._breaches = {}

    def evaluate(self, skews=None, down=(), stale=None):
        """One evaluation round -> [(host, reason)], sorted by host.

        ``skews``: {host: ratio} (obs.straggler's skews); ``down``:
        hosts whose health flipped DOWN or whose process exited;
        ``stale``: {host: seconds since its last liveness ping}. A
        window with no reading for a host leaves its breach count
        alone."""
        verdicts = {}
        for host in down or ():
            verdicts[str(host)] = REASON_HEALTH
        for host, seconds in (stale or {}).items():
            if host not in verdicts and seconds > self.stale_after_s:
                verdicts[str(host)] = REASON_HUNG
        for host, ratio in (skews or {}).items():
            host = str(host)
            if ratio > self.skew_factor:
                self._breaches[host] = self._breaches.get(host, 0) + 1
                if (self._breaches[host] >= self.skew_windows
                        and host not in verdicts):
                    verdicts[host] = REASON_STRAGGLER
            else:
                self._breaches.pop(host, None)
        return sorted(verdicts.items())


def down_hosts_from_events(events, device_to_host):
    """Hosts whose devices flipped Unhealthy, from the plugin's
    ``health.transition`` journal events. The last transition of a
    device wins, and a host is down while ANY of its devices is (one
    chip recovering does not mask a sibling still Unhealthy)."""
    state = {}
    for ev in sorted(events or [], key=lambda e: e.get("unix", 0.0)):
        if ev.get("name") != "health.transition":
            continue
        fields = ev.get("fields") or {}
        dev = fields.get("device")
        host = device_to_host.get(dev)
        if host is None:
            continue
        state[dev] = (
            host, str(fields.get("to", "")).lower() == "unhealthy")
    return sorted({h for h, bad in state.values() if bad})


class ElasticSupervisor:
    """Fleet-level reaction: consume signals, evict, plan the rebuild,
    account the recovery. ``host_devices`` ({host: [ranks]}) lets
    ``rebuild`` build the reshaped mesh itself (an in-process fleet);
    a launcher-managed fleet leaves it None and reads the plan."""

    def __init__(self, hosts, chips_per_host=1, model_parallel=1,
                 num_shards=None, policy=None, goodput=None, tracer=None,
                 min_hosts=1, host_devices=None):
        hosts = [str(h) for h in hosts]
        if len(set(hosts)) != len(hosts):
            raise ValueError(f"duplicate hosts: {hosts}")
        self.hosts = hosts
        self.chips_per_host = int(chips_per_host)
        self.model_parallel = int(model_parallel)
        self.policy = policy or EvictionPolicy()
        self.goodput = goodput
        self._tracer = tracer or obs.TRACER
        self.min_hosts = max(1, int(min_hosts))
        self.host_devices = ({str(h): list(d)
                              for h, d in host_devices.items()}
                             if host_devices else None)
        self.assignment = shard_assignment(
            num_shards if num_shards is not None else len(hosts), hosts)
        self.mesh_spec = reshape_spec(
            len(hosts) * self.chips_per_host, self.model_parallel)
        self._evicted = {}
        self.plans = []

    def observe(self, skews=None, down=(), stale=None):
        """Feed one evaluation round of signals; a ReshapePlan when the
        policy evicts, else None."""
        verdicts = [(h, r) for h, r
                    in self.policy.evaluate(skews=skews, down=down,
                                            stale=stale)
                    if h in self.hosts]
        if not verdicts:
            return None
        return self.evict(verdicts)

    def evict(self, verdicts):
        """Remove hosts from the fleet and plan the reshape: exactly
        one ``train.eviction`` event a newly departed host and one
        ``train.reshape`` event for the episode; hosts already gone are
        ignored, so a signal that keeps firing cannot double-count."""
        verdicts = [(str(h), r) for h, r in verdicts
                    if str(h) in self.hosts]
        if not verdicts:
            return None
        gone = {h for h, _ in verdicts}
        survivors = [h for h in self.hosts if h not in gone]
        if len(survivors) < self.min_hosts:
            raise FleetExhausted(
                f"evicting {[h for h, _ in verdicts]} would leave "
                f"{len(survivors)} host(s); min_hosts={self.min_hosts}")
        old_spec = self.mesh_spec
        for host, reason in verdicts:
            self._evicted[host] = reason
            log.warning("evicting host %s: %s", host, reason)
            self._tracer.event(EVICTION_EVENT, host=host, reason=reason,
                               survivors=len(survivors))
            self._tracer.counter(RECOVERY_COUNTER, 1, reason=reason)
        new_spec = reshape_spec(
            len(survivors) * self.chips_per_host, self.model_parallel)
        self.assignment = reassign_shards(self.assignment, gone)
        self.hosts = survivors
        self.mesh_spec = new_spec
        plan = ReshapePlan(
            evicted=verdicts, survivors=list(survivors),
            old_spec=old_spec, mesh_spec=new_spec,
            assignment={h: list(s) for h, s in self.assignment.items()})
        self._tracer.event(
            RESHAPE_EVENT,
            evicted=",".join(h for h, _ in verdicts),
            reasons=",".join(r for _, r in verdicts),
            old_shape=f"{old_spec.data}x{old_spec.model}",
            new_shape=f"{new_spec.data}x{new_spec.model}",
            survivors=len(survivors))
        self.plans.append(plan)
        return plan

    def evicted(self):
        """{host: reason} of everyone removed so far."""
        return dict(self._evicted)

    def complete_recovery(self, plan, seconds, resume_step=None):
        """Close the books on one recovery: the ``restart`` bucket and
        a ``train.recovered`` event carrying ``recovery_s`` (the field
        the offline goodput replay attributes, as ``train.restart``'s)."""
        seconds = float(seconds)
        plan.resume_step = resume_step
        if self.goodput is not None:
            self.goodput.record("restart", seconds)
        self._tracer.event(
            RECOVERED_EVENT,
            evicted=",".join(h for h, _ in plan.evicted),
            new_shape=f"{plan.mesh_spec.data}x{plan.mesh_spec.model}",
            resume_step=resume_step, recovery_s=round(seconds, 6))

    def rebuild(self, plan, trainer, checkpoint, init_state, step=None,
                config=None, schedule=False):
        """Tear down -> reshape -> resharded resume, in one process a
        rank; called on every rank of the world (module docstring).

        Waits for the checkpoint's pending writes, builds the reshaped
        mesh over the survivors' ranks, rebinds the Trainer
        (``Trainer.remesh``: same configuration, the goodput ledger
        carries over) and restores the newest checkpoint laid out for
        the new mesh (``restore_state(shardings=)``). ``init_state(
        trainer) -> TrainState`` gives the restore's template, and the
        state itself when no checkpoint has landed yet (an eviction
        before the first save resumes from it instead of failing).
        ``config`` and ``schedule`` are ``restore_state``'s (an LM's
        TransformerLM keywords; a learning-rate schedule's count).
        Returns (trainer, state, mesh); a departed rank gets (None,
        None, mesh) and keeps no books."""
        from .checkpoint import restore_state

        if self.host_devices is None:
            raise ValueError(
                "rebuild() needs host_devices={host: [ranks]}; "
                "launcher-managed fleets consume the ReshapePlan instead")
        t0 = time.perf_counter()
        # A save of the newest step may still be on the writer thread;
        # resuming before it lands would rewind further than needed.
        wait = getattr(checkpoint, "wait_until_finished", None)
        if wait is not None:
            wait()
        ranks = [r for h in plan.survivors for r in self.host_devices[h]]
        mesh = build_mesh(plan.mesh_spec, devices=ranks)
        if mesh.get_coordinate() is None:
            return None, None, mesh
        new_trainer = trainer.remesh(mesh)
        template = init_state(new_trainer)
        latest = getattr(checkpoint, "latest_step", None)
        if step is None and latest is not None and latest() is None:
            log.warning("no finished checkpoint to restore; resuming "
                        "from initialized state")
            state = template
        else:
            state = restore_state(
                checkpoint, template, step=step, config=config,
                schedule=schedule,
                shardings=new_trainer.state_shardings(template))
        resume = int(state.step)
        self.complete_recovery(plan, time.perf_counter() - t0,
                               resume_step=resume)
        return new_trainer, state, mesh

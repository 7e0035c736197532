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

"""Multi-host start-up from the device plugin's env contract
(counterpart of container_engine_accelerators_tpu/parallel/distributed.py).

Each host's pod receives ``TPU_WORKER_ID`` and ``TPU_WORKER_HOSTNAMES``
from the plugin's Allocate response. ``initialize_from_plugin_env``
turns that contract into a ``torch.distributed.init_process_group``
call, one rank per host, with worker 0 as the TCP rendezvous: the
counterpart of the JAX module's ``jax.distributed.initialize``. The
backend is explicit: NCCL for a CUDA device, gloo for the CPU, and
never one in place of the other.

Environment read:

- ``TPU_WORKER_HOSTNAMES`` (comma-separated; one host or none is a
  single-host run, and a no-op) and ``TPU_WORKER_ID`` (this host's
  rank);
- ``CEA_COORDINATOR_ADDRESS`` (host:port, overrides the default
  rendezvous) or ``CEA_COORDINATOR_PORT`` (port on worker 0's host,
  default 8476);
- ``CEA_TPU_COORD_TIMEOUT_MS`` (each attempt's deadline, default
  60000), ``CEA_TPU_COORD_RETRIES`` (default 2) and
  ``CEA_TPU_COORD_BACKOFF_MS`` (first pause, default 500, doubling,
  capped at 30 s).

``start_world`` also reads ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; one
rank a local device) before the plugin's, and starts a one-rank group
where neither names a world.

The deadline bounds the rendezvous only, as the JAX module's
``initialization_timeout`` bounds its connect: the group's collectives
keep torch's default timeout, so a rank that comes late to one (a cold
kernel build, rank 0's restore) does not trip NCCL's watchdog.
"""

import datetime
import logging
import socket
import time

from .. import obs
from ..obs.metric_names import TRAIN_RECOVERY
from ..utils import env_number, env_str

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = 8476

COORD_TIMEOUT_ENV = "CEA_TPU_COORD_TIMEOUT_MS"
COORD_RETRIES_ENV = "CEA_TPU_COORD_RETRIES"
COORD_BACKOFF_ENV = "CEA_TPU_COORD_BACKOFF_MS"

DEFAULT_COORD_TIMEOUT_MS = 60_000
DEFAULT_COORD_RETRIES = 2
DEFAULT_COORD_BACKOFF_MS = 500
_BACKOFF_CAP_MS = 30_000

# The elastic layer's recovery counter: one query covers every
# recovery action (coordinator retries and timeouts among them).
RECOVERY_COUNTER = TRAIN_RECOVERY


class DeadlineExceeded(TimeoutError):
    """A bounded distributed-runtime operation ran out its deadline
    (coordinator connect, barrier)."""


def _env_int(name, default):
    return env_number(name, default, parse=int)


def backend_for(device):
    """The process-group backend of ``device``: "nccl" for a CUDA
    device, "gloo" for the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {device}")


def free_local_port():
    """A TCP port on localhost that is free now (a one-host group's
    rendezvous)."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_process_group(*, backend, init_method, world_size, rank,
                        timeout, device):
    """``torch.distributed.init_process_group`` with this module's
    backend rule: under NCCL the rank's CUDA device is set and bound to
    the group (``device_id``); NCCL without a CUDA device raises.

    ``init_method`` is ``tcp://host:port`` (rank 0 listens there) and
    ``timeout`` bounds the rendezvous: the world must assemble within
    it. The group's collectives then keep torch's default timeout."""
    import torch
    import torch.distributed as dist
    from torch.distributed.constants import default_pg_timeout

    if not init_method.startswith("tcp://"):
        raise ValueError(f"init_method must be tcp://host:port: "
                         f"{init_method!r}")
    host, port = init_method[len("tcp://"):].rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world_size,
                          is_master=rank == 0, timeout=timeout,
                          wait_for_workers=True)
    store.set_timeout(default_pg_timeout)
    kwargs = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs a CUDA device; "
                               "torch.cuda.is_available() is False")
        device = torch.device(device)
        torch.cuda.set_device(device)
        kwargs["device_id"] = torch.device(
            "cuda", torch.cuda.current_device())
    dist.init_process_group(backend=backend, store=store,
                            world_size=world_size, rank=rank, **kwargs)


def start_local_group(device, _initialize=None):
    """A one-rank group of this process on ``device``'s backend, on a
    free localhost port (a mesh one rank wide)."""
    (_initialize or start_process_group)(
        backend=backend_for(device),
        init_method=f"tcp://127.0.0.1:{free_local_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(minutes=5), device=device)


def initialize_from_plugin_env(coordinator_port=None, timeout_ms=None,
                               retries=None, backoff_ms=None,
                               device="cuda", _initialize=None):
    """Start this host's rank of the process group from the plugin's
    env contract (module docstring), with bounded retries instead of
    an indefinite hang.

    Returns False (and does nothing) on a single-host slice, True once
    the group is up. Each attempt is capped at ``timeout_ms``; a
    failure retries up to ``retries`` times after ``backoff_ms``,
    doubling, and bumps ``tpu_train_recovery_total{reason=
    "coordinator_retry"}``; the last failure raises DeadlineExceeded.
    ``device`` picks the backend (``backend_for``). ``_initialize``
    is the test seam (keyword arguments backend, init_method,
    world_size, rank, timeout, device)."""
    hostnames = [h for h in
                 env_str("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    if len(hostnames) <= 1:
        log.info("single-host slice; skipping torch.distributed")
        return False
    raw_id = env_str("TPU_WORKER_ID")
    if raw_id is None:
        raise ValueError(
            "TPU_WORKER_HOSTNAMES lists multiple hosts but TPU_WORKER_ID "
            "is unset; every host would claim rank 0. Set it via the "
            "plugin's --tpu-worker-id or the Job downward API.")
    worker_id = int(raw_id)
    if not 0 <= worker_id < len(hostnames):
        raise ValueError(
            f"TPU_WORKER_ID={worker_id} out of range for "
            f"{len(hostnames)} workers")
    coordinator = env_str("CEA_COORDINATOR_ADDRESS", "")
    if not coordinator:
        if coordinator_port is None:
            coordinator_port = int(env_str(
                "CEA_COORDINATOR_PORT", "") or DEFAULT_COORDINATOR_PORT)
        coordinator = f"{hostnames[0]}:{coordinator_port}"

    timeout_ms = (timeout_ms if timeout_ms is not None
                  else _env_int(COORD_TIMEOUT_ENV,
                                DEFAULT_COORD_TIMEOUT_MS))
    retries = (retries if retries is not None
               else _env_int(COORD_RETRIES_ENV, DEFAULT_COORD_RETRIES))
    backoff_ms = (backoff_ms if backoff_ms is not None
                  else _env_int(COORD_BACKOFF_ENV,
                                DEFAULT_COORD_BACKOFF_MS))
    backend = backend_for(device)
    initialize = _initialize or start_process_group

    last_error = None
    for attempt in range(max(0, int(retries)) + 1):
        try:
            initialize(
                backend=backend, init_method=f"tcp://{coordinator}",
                world_size=len(hostnames), rank=worker_id,
                timeout=datetime.timedelta(
                    milliseconds=max(1000, int(timeout_ms))),
                device=device)
            log.info("torch.distributed up: rank %d/%d via %s on %s "
                     "(attempt %d)", worker_id, len(hostnames),
                     coordinator, backend, attempt + 1)
            return True
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            last_error = e
            if _initialize is None:
                shutdown()
            if attempt >= retries:
                break
            pause = min(backoff_ms * (2 ** attempt),
                        _BACKOFF_CAP_MS) / 1e3
            log.warning(
                "process group start failed (attempt %d/%d, "
                "coordinator %s): %s; retrying in %.1fs",
                attempt + 1, retries + 1, coordinator, e, pause)
            obs.counter(RECOVERY_COUNTER, 1,
                        reason="coordinator_retry")
            time.sleep(pause)
    obs.counter(RECOVERY_COUNTER, 1, reason="coordinator_timeout")
    raise DeadlineExceeded(
        f"process group start failed after {retries + 1} attempt(s) "
        f"against {coordinator} (timeout {timeout_ms}ms each): "
        f"{last_error}") from last_error


def start_world(device="cuda", _initialize=None):
    """Start this process's rank of the world: from ``torchrun``'s
    environment (a CUDA rank on card ``LOCAL_RANK``), else the plugin's
    env contract (``initialize_from_plugin_env``; card 0), else a
    one-rank group on a free localhost port (card 0). Returns the
    rank's device. ``_initialize``: the test seam, as
    ``initialize_from_plugin_env``'s."""
    import torch

    world, rank = env_str("WORLD_SIZE", ""), env_str("RANK", "")
    index = int(env_str("LOCAL_RANK", "") or 0) if world and rank else 0
    kind = torch.device(device).type
    local = f"cuda:{index}" if kind == "cuda" else kind
    if world and rank:
        addr = env_str("MASTER_ADDR", "") or "127.0.0.1"
        port = env_str("MASTER_PORT", "") or "29500"
        (_initialize or start_process_group)(
            backend=backend_for(local), init_method=f"tcp://{addr}:{port}",
            world_size=int(world), rank=int(rank),
            timeout=datetime.timedelta(minutes=5), device=local)
    elif not initialize_from_plugin_env(device=local,
                                        _initialize=_initialize):
        start_local_group(local, _initialize)
    return local


_barrier_calls = {}


def barrier(name, timeout_ms=None):
    """Fleet barrier with a deadline: every rank calls it with the same
    ``name``; raises DeadlineExceeded when the world does not assemble
    within ``timeout_ms`` (default CEA_TPU_COORD_TIMEOUT_MS). It counts
    arrivals in the process group's rendezvous store, so it waits the
    same way under either backend. Returns False without a process
    group (a single host: nothing to wait for)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return False
    timeout_ms = (timeout_ms if timeout_ms is not None
                  else _env_int(COORD_TIMEOUT_ENV,
                                DEFAULT_COORD_TIMEOUT_MS))
    world = dist.get_world_size()
    generation = _barrier_calls[name] = _barrier_calls.get(name, 0) + 1
    store = dist.distributed_c10d._get_default_store()
    key = f"cea_barrier/{name}"
    t0 = time.perf_counter()
    arrived = store.add(key, 1)
    while arrived < generation * world:
        waited = time.perf_counter() - t0
        if waited * 1e3 > timeout_ms:
            obs.counter(RECOVERY_COUNTER, 1, reason="barrier_timeout")
            raise DeadlineExceeded(
                f"barrier {name!r} did not assemble within "
                f"{timeout_ms}ms (waited {waited:.1f}s; {arrived} of "
                f"{generation * world} arrivals)")
        time.sleep(0.005)
        arrived = store.add(key, 0)
    return True


def shutdown():
    """Tear down this process's process group; safe to call when none
    was started (returns False then)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return False
    try:
        dist.destroy_process_group()
    except Exception as e:
        log.info("torch.distributed shutdown: %s", e)
        return False
    return True

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

"""Async checkpoints in the JAX package's format (counterpart of
container_engine_accelerators_tpu/parallel/checkpoint.py).

A checkpoint is a directory ``checkpoint_N`` holding ``meta.json``
(format_version 1, step, created_unix, identity, mesh_axes, async,
leaf_count, keys, bytes) and ``arrays.npz``, whose members are keyed by
each leaf's pytree path as ``jax.tree_util.keystr`` renders it:
``['name']`` for a mapping key, ``[i]`` for a sequence index,
``.field`` for a named state field (``['opt_state'][2][0].trace``).
The port renders the same strings itself (``keystr_items``), so either
side restores what the other wrote.

``CheckpointManager`` keeps the JAX manager's behaviour: ``save()``
blocks only for the snapshot (every leaf copied to host memory; on the
card a synchronous device-to-host copy), timed into the
``tpu_train_checkpoint_block_seconds`` histogram and the
``train.checkpoint`` span; one background thread serializes, fsyncs
and ``os.replace``s ``checkpoint_N.tmp-<pid>-<seq>`` to
``checkpoint_N``; ``keep`` retention counts finished directories only;
a background failure is raised at the next call; ``restore`` reads a
template's paths (a subset of the archive restores cleanly).

The snapshot always copies: the port updates parameters and momentum
buffers in place, and a numpy view of a live CPU tensor would let the
background write archive a later step's values. Leaves come back
whole, as host numpy arrays; ``restore(shardings=)`` and
``restore_state(shardings=)`` lay them out for the restoring mesh
(``Trainer.state_shardings``: each rank keeps its FSDP or column
shard, whatever mesh wrote the archive), and a sharded Trainer can
also restore inside ``Trainer.full_state``. ``goodput`` is the Trainer's GoodputLedger (or
any object with ``record(bucket, seconds)``): each save's blocking
seconds go to its ``checkpoint`` bucket, as in the JAX manager. The
queue's writers call the lock-order sanitizer's ``note_write`` where
the JAX manager does. Every save is async unless
``save(blocking=True)``, always fsynced, and written by this process:
the JAX manager's ``fsync`` and ``async_save`` switches come back
with their callers. ``primary=False`` (a rank other than 0
of a multi-process run) turns saves into free no-ops, as the JAX
manager's does: exactly one process writes, every process restores by
reading the same directory, and the archive holds whole leaves (the
sharded Trainer makes its state whole first, ``Trainer.full_state``).

``state_payload`` and ``restore_state`` carry the port's ``TrainState``
in the JAX TrainState's layout, through models/convert.py: ``step``
int32; ``params`` (and ``batch_stats`` for BN models) in the flax
layout; ``opt_state`` as the demo's optax chain holds it, the momentum
traces at ``[2][0].trace`` and, under a learning-rate schedule, the
update count at ``[2][1].count``; ``ema_params`` when EMA is tracked.
"""

import collections
import collections.abc
import json
import logging
import os
import queue
import shutil
import sys
import threading
import time

import numpy as np
import torch

from .. import obs
from ..analysis import tsan
from ..models import convert
from ..obs.metric_names import TRAIN_CHECKPOINT_BLOCK

log = logging.getLogger("cea_tpu.checkpoint")

CHECKPOINT_PREFIX = "checkpoint_"
META_NAME = "meta.json"
ARRAYS_NAME = "arrays.npz"
FORMAT_VERSION = 1

SAVED_EVENT = "train.checkpoint_saved"

_SAVE_HISTOGRAM = TRAIN_CHECKPOINT_BLOCK

# optax's states in the demo's chain (clip or identity, masked decay,
# sgd = trace then the learning rate): named fields render as ".field".
EmptyState = collections.namedtuple("EmptyState", [])
TraceState = collections.namedtuple("TraceState", ["trace"])
ScaleByScheduleState = collections.namedtuple("ScaleByScheduleState",
                                              ["count"])


def _is_named(node):
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(path suffix, child)] of an inner node, or None for a leaf. A
    None node is an empty subtree, as in jax."""
    if isinstance(node, collections.abc.Mapping):
        return [(f"[{key!r}]", node[key]) for key in sorted(node)]
    if _is_named(node):
        return [(f".{field}", getattr(node, field))
                for field in node._fields]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", child) for i, child in enumerate(node)]
    return None


def keystr_items(tree, prefix=""):
    """[(path key, leaf)] of ``tree`` in ``jax.tree_util.keystr``'s
    rendering (mapping keys sorted, as jax flattens a dict)."""
    if tree is None:
        return []
    children = _children(tree)
    if children is None:
        return [(prefix, tree)]
    out = []
    for suffix, child in children:
        out += keystr_items(child, prefix + suffix)
    return out


def _rebuild(tree, fn, prefix=""):
    """``tree``'s structure with each leaf replaced by ``fn(key,
    leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, collections.abc.Mapping):
        return {key: _rebuild(tree[key], fn, f"{prefix}[{key!r}]")
                for key in tree}
    if _is_named(tree):
        return type(tree)(*[_rebuild(getattr(tree, f), fn,
                                     f"{prefix}.{f}")
                            for f in tree._fields])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(child, fn, f"{prefix}[{i}]")
                          for i, child in enumerate(tree))
    return fn(prefix, tree)


def _host_copy(leaf):
    """A host numpy array that shares no storage with ``leaf``."""
    if isinstance(leaf, torch.Tensor):
        value = leaf.detach()
        if value.device.type == "cpu":
            return value.clone(
                memory_format=torch.contiguous_format).numpy()
        return value.contiguous().to("cpu").numpy()
    value = np.asarray(leaf)
    if value is leaf or not value.flags.owndata:
        value = np.array(value)
    return value


def list_checkpoints(directory):
    """Sorted (step, name) pairs of finished checkpoints: integer-
    suffixed ``checkpoint_N`` directories holding a ``meta.json``.
    In-flight ``checkpoint_N.tmp-*`` siblings and foreign entries never
    qualify."""
    entries = []
    try:
        names = os.listdir(directory)
    except OSError:
        return entries
    for name in names:
        if not name.startswith(CHECKPOINT_PREFIX):
            continue
        try:
            step = int(name[len(CHECKPOINT_PREFIX):])
        except ValueError:
            continue
        if os.path.exists(os.path.join(directory, name, META_NAME)):
            entries.append((step, name))
    return sorted(entries)


def unrecognized_checkpoints(directory):
    """``checkpoint_``-prefixed entries that are neither finished
    checkpoints nor this format's in-flight ``.tmp-`` siblings: a
    directory written in another format."""
    finished = {name for _, name in list_checkpoints(directory)}
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if (name.startswith(CHECKPOINT_PREFIX)
                and ".tmp-" not in name and name not in finished):
            out.append(name)
    return sorted(out)


def warn_unrecognized_checkpoints(directory, action, stream=None):
    """Warn (to ``stream``, default stderr) when ``directory`` holds
    unrecognized ``checkpoint_*`` entries, and return them; ``action``
    ends the sentence with what the caller does instead. The JAX
    package's wording, letter for letter."""
    foreign = unrecognized_checkpoints(directory)
    if foreign:
        if stream is None:
            stream = sys.stderr
        plural = "y" if len(foreign) == 1 else "ies"
        more = "..." if len(foreign) > 3 else ""
        stream.write(
            f"WARNING: {directory!r} holds {len(foreign)} "
            f"checkpoint entr{plural} in an unrecognized format "
            f"(pre-library orbax run?): {foreign[:3]}{more} — "
            f"{action}\n")
    return foreign


def latest_meta(directory):
    """The newest finished checkpoint's meta dict (plus its path), or
    None."""
    entries = list_checkpoints(directory)
    if not entries:
        return None
    _, name = entries[-1]
    path = os.path.join(directory, name)
    try:
        with open(os.path.join(path, META_NAME)) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        return {"path": path, "error": f"{type(e).__name__}: {e}"}
    meta["path"] = path
    return meta


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointError(RuntimeError):
    """A background write failed; raised at the next save() or
    wait_until_finished() so the failure cannot pass silently."""


class CheckpointManager:
    """Owns one checkpoint directory: async saves, retention, restore.
    ``keep > 0`` retains only the newest ``keep`` finished
    checkpoints; ``goodput`` receives each save's blocking seconds in
    its ``checkpoint`` bucket; ``primary=False`` makes saves no-ops
    (the non-writer ranks of a multi-process run)."""

    def __init__(self, directory, keep=0, goodput=None, primary=True):
        self.directory = str(directory)
        self.keep = int(keep)
        self.primary = bool(primary)
        self._goodput = goodput
        self._seq = 0
        self._error = None
        self._queue = None
        self._worker = None
        self._closed = False
        self._lock = threading.Lock()
        # Pending writes under the lock, not queue emptiness: between
        # save()'s snapshot and its put() the queue is empty.
        self._pending = 0
        self._all_done = threading.Condition(self._lock)
        # The blocking seconds of the last save (the histogram's
        # observation), for a driver's report.
        self.last_blocked_s = None

    def configure(self, keep=None, goodput=None, primary=None):
        """Re-point a long-lived manager; None leaves a setting alone."""
        if keep is not None:
            self.keep = int(keep)
        if primary is not None:
            self.primary = bool(primary)
        if goodput is not None:
            self._goodput = goodput

    # -- listing ------------------------------------------------------

    def steps(self):
        return [step for step, _ in list_checkpoints(self.directory)]

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def manifest(self, step=None):
        """meta dict of ``step`` (default: newest), or None."""
        if step is None:
            return latest_meta(self.directory)
        path = os.path.join(self.directory,
                            f"{CHECKPOINT_PREFIX}{int(step)}")
        if not os.path.exists(os.path.join(path, META_NAME)):
            return None
        with open(os.path.join(path, META_NAME)) as f:
            meta = json.load(f)
        meta["path"] = path
        return meta

    # -- save ---------------------------------------------------------

    def save(self, payload, step, blocking=False):
        """Snapshot ``payload`` (a tree of mappings, sequences and named
        tuples over tensors, arrays and scalars) and schedule the write
        of ``checkpoint_<step>``. Returns the final path (None on a
        non-primary rank, which writes nothing). Blocks only for the
        snapshot unless ``blocking``."""
        self._raise_pending()
        if not self.primary:
            return None
        step = int(step)
        path = os.path.join(self.directory,
                            f"{CHECKPOINT_PREFIX}{step}")
        t0 = time.perf_counter()
        with obs.span("train.checkpoint", step=step,
                      mode="sync" if blocking else "async"):
            arrays, meta = self._snapshot(payload, step)
            if not blocking:
                self._ensure_worker()
                # Enqueue under the lock: close() puts its sentinel
                # under the same lock, so an accepted save never lands
                # behind it.
                with self._lock:
                    if self._closed:
                        raise CheckpointError(
                            "save() on a closed CheckpointManager")
                    tsan.note_write("checkpoint.queue", self)
                    self._pending += 1
                    self._queue.put((arrays, meta, path))
            blocked = time.perf_counter() - t0
            if blocking:
                self._write(arrays, meta, path)
                blocked = time.perf_counter() - t0
        obs.histogram(
            _SAVE_HISTOGRAM,
            "Host-blocking portion of a checkpoint save").observe(
                blocked)
        self.last_blocked_s = blocked
        if self._goodput is not None:
            self._goodput.record("checkpoint", blocked)
        return path

    def _snapshot(self, payload, step):
        """The blocking part: every leaf copied to host numpy, plus the
        meta block."""
        arrays = {}
        for key, leaf in keystr_items(payload):
            if leaf is None:
                continue
            if key in arrays:
                raise CheckpointError(
                    f"duplicate pytree path key {key!r}")
            arrays[key] = _host_copy(leaf)
        meta = {
            "format_version": FORMAT_VERSION,
            "step": step,
            "created_unix": time.time(),
            "identity": obs.identity(),
            "mesh_axes": None,
            "async": True,
            "leaf_count": len(arrays),
            "keys": sorted(arrays),
            "bytes": int(sum(a.nbytes for a in arrays.values())),
        }
        return arrays, meta

    def _write(self, arrays, meta, path):
        # On the worker thread for queued saves, on the caller's for
        # blocking ones: the seq is taken under the lock so two writers
        # never share a tmp directory.
        with self._lock:
            seq = self._seq
            self._seq += 1
        tmp = f"{path}.tmp-{os.getpid()}-{seq}"
        os.makedirs(tmp, exist_ok=True)
        stale = None
        try:
            with open(os.path.join(tmp, ARRAYS_NAME), "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, META_NAME), "w") as f:
                json.dump(meta, f, indent=1)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            if os.path.isdir(path):
                # A same-step overwrite: move the finished directory
                # aside, land the new one, only then delete the old.
                stale = f"{path}.tmp-stale-{os.getpid()}-{seq}"
                os.replace(path, stale)
            os.replace(tmp, path)
            _fsync_dir(self.directory)
            if stale is not None:
                shutil.rmtree(stale, ignore_errors=True)
        except BaseException:
            if stale is not None and not os.path.isdir(path):
                try:
                    os.replace(stale, path)
                except OSError:
                    pass
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        obs.event(SAVED_EVENT, step=meta["step"], path=path,
                  bytes=meta["bytes"], leaves=meta["leaf_count"])
        if self.keep > 0:
            self.prune()
        return path

    def prune(self):
        """Delete all but the newest ``keep`` finished checkpoints."""
        if self.keep < 1:
            return
        for _, name in list_checkpoints(self.directory)[:-self.keep]:
            victim = os.path.join(self.directory, name)
            shutil.rmtree(victim, ignore_errors=True)
            log.info("pruned checkpoint %s", victim)

    # -- background worker --------------------------------------------

    def _ensure_worker(self):
        with self._lock:
            if self._closed:
                raise CheckpointError(
                    "save() on a closed CheckpointManager")
            if self._worker is not None and self._worker.is_alive():
                return
            self._queue = queue.Queue()
            self._worker = threading.Thread(
                target=self._drain, name="tpu-checkpoint-writer",
                daemon=True)
            self._worker.start()

    def _drain(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            arrays, meta, path = item
            try:
                self._write(arrays, meta, path)
            except BaseException as e:  # raised at the next save/wait
                log.exception("background checkpoint write failed: %s",
                              path)
                with self._lock:
                    self._error = e
            finally:
                with self._all_done:
                    tsan.note_write("checkpoint.queue", self)
                    self._pending -= 1
                    if self._pending == 0:
                        self._all_done.notify_all()

    def wait_until_finished(self, timeout=None):
        """Block until every queued write has landed; re-raises the
        first background failure."""
        with self._all_done:
            ok = self._all_done.wait_for(
                lambda: self._pending == 0, timeout)
        if not ok:
            raise CheckpointError(
                f"checkpoint writes still pending after {timeout}s")
        self._raise_pending()

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointError(
                f"background checkpoint write failed: {err}") from err

    def close(self):
        """Finish queued writes and stop the worker; raises if a write
        is still in flight after 60 s. Later saves raise."""
        with self._lock:
            self._closed = True
            worker = self._worker
            if worker is not None:
                self._queue.put(None)
        if worker is not None:
            worker.join(timeout=60)
            if worker.is_alive():
                raise CheckpointError(
                    "checkpoint writer still running after 60s; the "
                    "final write may not have landed")
            self._worker = None
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- restore ------------------------------------------------------

    def restore(self, template, step=None, missing="error",
                shardings=None):
        """``template``'s tree rebuilt from ``checkpoint_<step>``
        (default: newest) as host numpy arrays. The template gives only
        the structure: values are looked up by path, so a template
        holding part of the saved tree restores cleanly.
        ``missing="template"`` keeps the template's own leaf for a path
        the archive lacks; ``"error"`` (default) raises KeyError.
        ``shardings``: a tree like ``template`` whose leaves are
        callables ``whole leaf -> this rank's leaf`` (None keeps a leaf
        whole), applied to each restored leaf: the archive holds whole
        leaves whatever mesh wrote it, and this lays them out for the
        restoring one (the JAX argument's NamedSharding pytree)."""
        if missing not in ("error", "template"):
            raise ValueError(f"missing must be error|template: "
                             f"{missing!r}")
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no finished checkpoints under "
                    f"{self.directory!r}")
        path = os.path.join(self.directory,
                            f"{CHECKPOINT_PREFIX}{int(step)}")
        with obs.span("train.checkpoint_restore", step=int(step)):
            with np.load(os.path.join(path, ARRAYS_NAME)) as archive:
                files = set(archive.files)

                def leaf(key, value):
                    if key in files:
                        return archive[key]
                    if missing == "template":
                        return value
                    raise KeyError(
                        f"checkpoint {path} has no leaf {key}; saved "
                        f"keys: {sorted(files)[:8]}...")

                out = _rebuild(template, leaf)
        if shardings is not None:
            fns = dict(keystr_items(shardings))
            out = _rebuild(out, lambda key, value: value
                           if fns.get(key) is None else fns[key](value))
        return out

    def has_leaf(self, key_substring, step=None):
        """True when the checkpoint archives any path containing
        ``key_substring`` (reads the meta only)."""
        meta = self.manifest(step)
        if not meta:
            return False
        return any(key_substring in k for k in meta.get("keys", []))


# -- TrainState ---------------------------------------------------------

def state_payload(state, config=None, schedule=False):
    """The on-disk payload of the port's ``TrainState``, in the JAX
    TrainState's layout: a plain dict of ``step``, ``params``,
    ``opt_state``, ``batch_stats`` and, when EMA is tracked,
    ``ema_params``. ``config``: the LM's TransformerLM config (its
    leaves through ``params_to_flax``); None for an image model (through
    the image layout, ``batch_stats`` from the BN buffers).
    ``schedule``: the optimizer reads a learning-rate schedule, whose
    optax state keeps the update count. The leaves are tensors on the
    model's device in the flax layout; ``CheckpointManager.save`` copies
    them to the host."""
    model = state.model
    if config is None:
        variables = convert.image_variables_to_flax(model, tensors=True)
        params = variables.get("params", {})
        batch_stats = variables.get("batch_stats", {})
    else:
        params = convert.params_to_flax(model, config, tensors=True)
        batch_stats = {}
    trace = convert.opt_state_to_flax(state.optimizer, model, config,
                                      tensors=True)
    step = np.asarray(state.step, np.int32)
    rate = ScaleByScheduleState(count=step) if schedule else EmptyState()
    payload = {"step": step, "params": params,
               "opt_state": (EmptyState(), EmptyState(),
                             (TraceState(trace=trace), rate)),
               "batch_stats": batch_stats}
    if state.ema is not None:
        payload["ema_params"] = convert.named_params_to_flax(
            model, state.ema, config, tensors=True)
    return payload


def restore_state(manager, state, step=None, config=None, schedule=False,
                  shardings=None):
    """Load ``manager``'s newest (or ``step``'s) checkpoint into
    ``state`` in place and return it: the parameters and BN statistics
    into the model, the momentum traces into the optimizer (created if
    it has not stepped), the step, and the EMA shadow. ``config`` and
    ``schedule`` as in ``state_payload``. A state tracking EMA takes
    the archived shadow when there is one and re-seeds it from the
    restored parameters otherwise (a checkpoint written before EMA was
    turned on).

    ``shardings`` (``Trainer.state_shardings``) lays the whole leaves
    out for a sharded ``state``, whatever mesh wrote them: each
    parameter, momentum trace and EMA shadow takes its piece under the
    restoring Trainer's layout (FSDP shards, column shards), with no
    collective. Without it ``state`` must be whole (a Trainer off a
    mesh, or inside ``Trainer.full_state``)."""
    template = state_payload(state, config, schedule)
    track_ema = state.ema is not None
    archived_ema = track_ema and manager.has_leaf("['ema_params']",
                                                  step=step)
    if track_ema and not archived_ema:
        del template["ema_params"]
    restored = manager.restore(template, step=step)
    model = state.model
    local = None if shardings is None else shardings.local
    if config is None:
        variables = {"params": restored["params"]}
        if restored["batch_stats"]:
            variables["batch_stats"] = restored["batch_stats"]
        whole = convert.image_variables_from_flax(
            model, variables, check_shapes=local is None)
    else:
        whole = convert.params_from_flax(restored["params"])
    if local is not None:
        whole = {name: local(name, value) for name, value in whole.items()}
    model.load_state_dict(whole)
    convert.opt_state_from_flax(state.optimizer, model,
                                restored["opt_state"][2][0].trace, config,
                                local=local)
    state.step = int(restored["step"])
    if track_ema:
        source = (restored["ema_params"] if archived_ema
                  else restored["params"])
        named = convert.named_params_from_flax(
            model, source, config, check_shapes=local is None)
        with torch.no_grad():
            for name, shadow in state.ema.items():
                value = named[name]
                shadow.copy_(value if local is None else local(name, value))
    return state

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

"""The slot engine in lockstep over the ranks of a tensor-parallel
group (what ``serve.py --tensor-parallel N`` runs).

The JAX launcher shards the wide parameters over a ("data", "model")
mesh and GSPMD runs the unchanged engine as one program across the
chips. Torch has no single controller, so every rank runs its own
``SlotDecodeEngine`` on its shard of the model (``parallel.spmd.
Spmd`` on a 1 x N mesh: the column-parallel layers gather their
outputs over the model axis, so every rank sees the same logits), and
the engines move in lockstep:

- rank 0 serves HTTP; its engine is a ``LockstepEngine``, which sends
  every call that changes the engine's state (``STATE_CALLS``: the
  method's name and its arguments, token ids, sampling knobs and
  seeds) to the followers before it runs the call itself. Reads
  (admission gates, telemetry) stay on rank 0;
- each follower loops in ``follow``: it receives a call and runs it on
  its own engine. Admission, bucket choice, block allocation, prefix
  hits and spill follow from the calls alone, so the follower reaches
  rank 0's decisions by replaying them; every message carries a digest
  of rank 0's host-side engine state before the call (slots,
  positions, last tokens, block tables, the pool's counts), and a
  follower whose own state differs stops with ``LockstepError``;
- the tokens a step or an admission picks are rank 0's: the engine's
  ``agree`` seam broadcasts them before anything reads them, so two
  near-equal logits cannot split the ranks;
- ``build`` makes every rank's engine (a quarantine's rebuild too),
  ``stop`` ends the followers' loops.

The messages travel on a gloo group of their own (``Channel``), under
NCCL too, so a follower waits on the host. Rank 0 sends a heartbeat
when the channel has been idle for ``HEARTBEAT_S``: a follower whose
channel stays silent for ``CHANNEL_TIMEOUT_S`` gives up, and rank 0
fails when a send cannot reach a follower. A one-rank group sends
nothing.
"""

import datetime
import logging
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

STATE_CALLS = ("admit", "step", "release", "pin_prefix", "score",
               "force_reclaim", "reset_prefix_counters",
               "drain_rehydrate_events")

HEARTBEAT_S = 5.0
CHANNEL_TIMEOUT_S = 120.0


class LockstepError(RuntimeError):
    """A follower's engine state no longer matches rank 0's."""


def engine_digest(engine):
    """A CRC of the engine's host-side decision state: active slots,
    positions, last tokens and, on the paged pool, the block tables,
    reservations and the pool's free and committed counts."""
    parts = [engine._active, engine._row_pos, engine._tok]
    if engine.paged:
        pool = engine._pool
        parts += [engine._tables, engine._committed_slot,
                  np.asarray([pool.free_count(), pool.committed],
                             np.int64)]
    crc = 0
    for a in parts:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc


class Channel:
    """rank 0's messages to the followers, on a gloo group over every
    rank of the world (made collectively: every rank constructs it at
    the same point)."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.group = (dist.new_group(
            backend="gloo",
            timeout=datetime.timedelta(seconds=CHANNEL_TIMEOUT_S))
            if self.world > 1 else None)
        # Held for a whole call on rank 0, so a heartbeat never lands
        # between a call and the token broadcasts inside it.
        self.lock = threading.RLock()
        self._last_send = time.monotonic()
        self._beat = None
        self._stopped = threading.Event()

    def send(self, msg):
        """Broadcast ``msg`` (picklable) from rank 0."""
        if self.group is None:
            return
        with self.lock:
            dist.broadcast_object_list([msg], src=0, group=self.group)
            self._last_send = time.monotonic()

    def recv(self):
        """The next message from rank 0 (a follower)."""
        buf = [None]
        dist.broadcast_object_list(buf, src=0, group=self.group)
        return buf[0]

    def agree(self, tokens):
        """The engine's ``agree`` seam: rank 0's ``tokens`` on every
        rank (int64, on the tokens' device)."""
        if self.group is None:
            return tokens
        host = tokens.detach().to("cpu", torch.int64).contiguous()
        dist.broadcast(host, src=0, group=self.group)
        if self.rank == 0:
            return tokens
        return host.to(tokens.device)

    def start_heartbeat(self, on_failure):
        """Rank 0: ping the followers whenever the channel has been idle
        for HEARTBEAT_S; ``on_failure(error)`` when a ping fails."""
        if self.group is None or self._beat is not None:
            return

        def beat():
            while not self._stopped.wait(HEARTBEAT_S / 2):
                if time.monotonic() - self._last_send < HEARTBEAT_S:
                    continue
                try:
                    with self.lock:
                        if self._stopped.is_set():
                            return
                        self.send(("ping",))
                except Exception as e:  # a follower is gone
                    on_failure(e)
                    return

        self._beat = threading.Thread(target=beat, name="lockstep-beat",
                                      daemon=True)
        self._beat.start()

    def stop(self):
        """Rank 0: end the followers' loops (idempotent)."""
        if self._stopped.is_set():
            return
        with self.lock:
            self._stopped.set()
            self.send(("stop",))


class LockstepEngine:
    """Rank 0's engine: a ``SlotDecodeEngine`` whose state-changing
    calls are sent to the followers first (module docstring); every
    other attribute reads the engine itself."""

    def __init__(self, channel, engine):
        self._channel = channel
        self._engine = engine
        engine.agree = channel.agree

    def __getattr__(self, name):
        if name in STATE_CALLS:
            def call(*args, span=None, **kwargs):
                # An admission's ``span`` is rank 0's trace; the
                # followers replay the call without it.
                with self._channel.lock:
                    self._channel.send(("call", name, args, kwargs,
                                        engine_digest(self._engine)))
                    if span is not None:
                        kwargs["span"] = span
                    return getattr(self._engine, name)(*args, **kwargs)
            return call
        return getattr(self._engine, name)


def build_engine(channel, model, draft_model=None, **kwargs):
    """Rank 0: make every rank's engine with ``kwargs`` (the
    ``SlotDecodeEngine`` keywords; ``draft_model`` given means each
    rank uses its own draft) and return rank 0's ``LockstepEngine``."""
    from ..models.decode import SlotDecodeEngine

    with channel.lock:
        channel.send(("build", dict(kwargs,
                                    with_draft=draft_model is not None)))
        engine = SlotDecodeEngine(model, draft_model=draft_model, **kwargs)
    return LockstepEngine(channel, engine)


def follow(channel, model, draft_model=None):
    """A follower's loop: build, replay and stop as rank 0 says.
    Returns when rank 0 sends ``stop``; raises LockstepError when the
    engine state diverges, and the channel's error when rank 0 is
    gone."""
    from ..models.decode import SlotDecodeEngine

    engine = None
    while True:
        msg = channel.recv()
        kind = msg[0]
        if kind == "stop":
            return
        if kind == "ping":
            continue
        if kind == "build":
            kwargs = dict(msg[1])
            with_draft = kwargs.pop("with_draft")
            engine = SlotDecodeEngine(
                model, draft_model=draft_model if with_draft else None,
                **kwargs)
            engine.agree = channel.agree
            continue
        _, name, args, kwargs, digest = msg
        mine = engine_digest(engine)
        if mine != digest:
            raise LockstepError(
                f"engine state diverged from rank 0's before {name} "
                f"(digest {mine} != {digest})")
        try:
            getattr(engine, name)(*args, **kwargs)
        except Exception as e:
            # Rank 0's own call raised the same (a capacity race, an
            # injected fault); its next message says what comes next.
            log.info("lockstep %s raised on rank %d: %s", name,
                     channel.rank, e)

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

"""A pool of gloo ranks for the port's distributed tests.

``RankPool(world)`` spawns ``world`` CPU processes once, joins them in
one gloo process group on a free localhost port, and then runs what a
test hands it: ``pool.run(fn, *args)`` calls the module-level ``fn(rank,
*args)`` on every rank at once and returns the ranks' results in rank
order (numpy arrays and plain values travel; a rank's exception comes
back as a RuntimeError with its traceback). A test module starts one
pool as a module-scoped fixture, so the start-up is paid once a file.
The ranks import the port only (never JAX).
"""

import multiprocessing
import os
import traceback

from container_engine_accelerators_tpu_torch.parallel.distributed import (
    free_local_port,
)

_TIMEOUT_S = 300.0


def _rank_main(rank, world, port, conn):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            module, name, args, kwargs = msg
            try:
                fn = getattr(importlib.import_module(module), name)
                conn.send(("ok", fn(rank, *args, **kwargs)))
            except BaseException:
                conn.send(("error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks that run test functions (module
    docstring)."""

    def __init__(self, world):
        ctx = multiprocessing.get_context("spawn")
        port = free_local_port()
        self.world = world
        self._conns, self._procs = [], []
        for rank in range(world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_main,
                               args=(rank, world, port, child),
                               daemon=True)
            proc.start()
            self._conns.append(parent)
            self._procs.append(proc)

    def run(self, fn, *args, **kwargs):
        """``fn(rank, *args, **kwargs)`` on every rank; the results in
        rank order."""
        msg = (fn.__module__, fn.__name__, args, kwargs)
        for conn in self._conns:
            conn.send(msg)
        results, errors = [], []
        for rank, conn in enumerate(self._conns):
            if not conn.poll(_TIMEOUT_S):
                self.close(kill=True)
                raise TimeoutError(f"rank {rank} gave no answer to "
                                   f"{fn.__name__} in {_TIMEOUT_S} s")
            status, value = conn.recv()
            if status == "error":
                errors.append(f"rank {rank}:\n{value}")
            results.append(value)
        if errors:
            raise RuntimeError("\n".join(errors))
        return results

    def close(self, kill=False):
        for conn, proc in zip(self._conns, self._procs):
            if not kill and proc.is_alive():
                try:
                    conn.send(None)
                except OSError:
                    pass
        for proc in self._procs:
            proc.join(timeout=0 if kill else 30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        self._conns, self._procs = [], []

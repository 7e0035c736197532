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


# Seeded violations of the port lint's lock-with rule (parsed, never
# imported). Each finding line carries an EXPECT comment.
import threading

_LOCK = threading.Lock()
_RLOCK = threading.RLock()


def bare_blocking_acquire():
    _LOCK.acquire()  # EXPECT: lock-with
    try:
        return 1
    finally:
        _LOCK.release()


def bare_acquire_of_an_attribute(holder):
    holder.lock.acquire()  # EXPECT: lock-with
    holder.lock.release()


def checked_probe_is_fine():
    # A non-blocking probe with a checked result: the profiler's guard.
    if _LOCK.acquire(blocking=False):
        try:
            return 1
        finally:
            _LOCK.release()
    return 0


def bounded_wait_is_fine(sem):
    if not sem.acquire(timeout=300):
        raise TimeoutError("no slot")
    sem.release()


def with_is_fine():
    with _RLOCK:
        return 2


def escaped():
    _LOCK.acquire()  # lint: disable=lock-with
    _LOCK.release()

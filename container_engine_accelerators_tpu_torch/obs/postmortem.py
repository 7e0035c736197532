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
"""Fault-time postmortem capture: flush telemetry before dying
(counterpart of the JAX package's ``obs/postmortem.py``, under its
names).

The atexit journal write (obs.trace) covers only clean interpreter
exits; a SIGTERM'd pod or an unhandled exception loses what an
operator needs. ``install()`` closes the gap:

  - signal handlers (SIGTERM by default) write the journal, every OPEN
    span and every registered state provider's snapshot to
    CEA_TPU_TRACE_FILE at signal time, then chain to the previously
    installed handler, or restore the default disposition and re-raise
    the signal (the exit status stays honest);
  - a sys.excepthook wrapper does the same for unhandled exceptions.

State providers are named zero-argument callables registered by the
process's layers (a server registers its request ledger and its KV
block pool; the memory monitor its watermarks); their results land
under ``postmortem_state`` in the journal file. A provider's failure
is recorded in place, never raised.
"""

import os
import signal
import sys
import threading
import time

from .trace import write_journal

_lock = threading.Lock()
_providers = {}
_prev_handlers = {}
_prev_excepthook = None
_captured = False


def register_state_provider(name, fn):
    """Register a zero-arg callable whose JSON-safe result is included
    under postmortem_state[name] in every capture."""
    with _lock:
        _providers[name] = fn


def unregister_state_provider(name):
    with _lock:
        _providers.pop(name, None)


def _collect_state():
    with _lock:
        providers = dict(_providers)
    state = {"captured_unix": time.time()}
    for name, fn in sorted(providers.items()):
        try:
            state[name] = fn()
        except Exception as e:  # a dead provider must not mask death
            state[name] = {"provider_error": repr(e)}
    return state


def capture(reason, path=None, force=False):
    """Write journal, open spans and provider state now. Returns the
    path written (None when neither CEA_TPU_TRACE_FILE nor ``path`` is
    set, or when an earlier capture already wrote).

    First death wins: when several death paths fire (a signal, then an
    exception in the chained shutdown, then atexit) the first capture
    that wrote to CEA_TPU_TRACE_FILE stands and later ones return None.
    A capture to an explicit ``path`` neither consumes nor honours the
    guard; ``force=True`` overrides it.
    """
    global _captured
    with _lock:
        if _captured and path is None and not force:
            return None
    out = write_journal(path=path, reason=reason,
                        state=_collect_state(), final=True)
    if out is not None and path is None:
        with _lock:
            _captured = True
    return out


def captured():
    with _lock:
        return _captured


def _signal_handler(signum, frame):
    name = signal.Signals(signum).name
    capture("signal:" + name)
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
    elif prev != signal.SIG_IGN:
        # SIG_DFL, or None (a handler installed outside Python):
        # restore the default and re-raise so the process reports the
        # true signal death.
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def _excepthook(exc_type, exc, tb):
    capture("unhandled:" + exc_type.__name__)
    (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)


def install(signals=(signal.SIGTERM,), fatal_errors=True):
    """Install the capture hooks. Call from the MAIN thread (the signal
    module's contract), after the graceful-shutdown handlers, so the
    capture chains in front of them."""
    global _prev_excepthook
    for sig in signals:
        prev = signal.getsignal(sig)
        if prev is _signal_handler:
            continue  # already installed
        _prev_handlers[sig] = prev
        signal.signal(sig, _signal_handler)
    if fatal_errors and sys.excepthook is not _excepthook:
        _prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook


def uninstall():
    """Restore the previous handlers and re-arm capture (test
    isolation seam)."""
    global _prev_excepthook, _captured
    for sig, prev in list(_prev_handlers.items()):
        signal.signal(sig, prev)
    _prev_handlers.clear()
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    with _lock:
        _captured = False

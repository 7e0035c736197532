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
"""Runtime lock-order sanitizer (the port's own copy of the JAX
package's ``analysis/tsan.py``, under its names).

Opt-in via ``CEA_TPU_TSAN=1`` to ``install()``, or
``session(force=True)`` in a test. When installed:

* ``threading.Lock`` / ``threading.RLock`` construction is wrapped so
  every acquisition is recorded against the lock's CREATION SITE
  (file:line) with the per-thread set of locks already held;
* each "held A, acquired B" pair becomes an edge of the lock-order
  graph; :func:`report` finds cycles — two threads taking the same
  pair of locks in opposite orders is a deadlock waiting for the
  right interleaving, exactly the class review keeps catching by
  hand (save() vs close(), the repartition epoch gate);
* a blocking re-acquire of a non-reentrant Lock already held by the
  same thread — certain deadlock — raises immediately instead of
  hanging the suite;
* registered hot structures (the engine's slot tables and
  ``_BlockPool`` refcounts, the serving loop's slot-work map, the
  CheckpointManager queue) call :func:`note_write` at mutation points
  (a no-op when the shim is off); writes from two threads that share
  no common held lock are reported as unguarded.

Same-site edges between DIFFERENT lock instances are skipped: many
instances share one constructor line (every ``Histogram._lock``),
and ordering between peers of one class is almost never a protocol
— flagging them would bury real inversions. The skip is the
documented blind spot.

The real primitives come from ``_thread``, never from ``threading``:
another sanitizer (the JAX package's, which its test harness installs
process-wide under CEA_TPU_TSAN=1) may already have swapped
``threading.Lock``, and a wrapper captured as "real" would double-track
every lock. ``uninstall()`` puts back whatever constructors its
``install()`` found, so sessions nest under either sanitizer.

Stdlib only: of the package it imports only ``utils`` (stdlib too).
"""

import _thread
import itertools
import os
import sys
import threading
import traceback

from ..utils import env_str

TSAN_ENV = "CEA_TPU_TSAN"

# The interpreter's own constructors, whatever threading holds now.
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock

_STACK_LIMIT = 14

# Owner tokens are minted process-wide (next() is atomic under the
# GIL): instances outlive sanitizer sessions, and their pinned
# tokens must never collide with a later session's mints.
_OWNER_TOKENS = itertools.count(1)

# Only locks CREATED by this repo's code are tracked: torch and stdlib
# machinery allocate locks whose ordering is not ours to fix. Untracked
# creation sites get the real primitive back, at no cost.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


_HERE = os.path.abspath(__file__)


def _creation_site():
    """file:line of the first frame outside this FILE and the
    threading/queue machinery — the lock's aggregate identity; None
    when that frame is outside the repo (untracked)."""
    frame = sys._getframe(2)
    while frame is not None:
        fn = frame.f_code.co_filename
        if (os.path.abspath(fn) != _HERE
                and os.path.basename(fn) not in ("threading.py",
                                                 "queue.py")):
            absfn = os.path.abspath(fn)
            if (not absfn.startswith(_REPO_ROOT + os.sep)
                    or "site-packages" in absfn):
                return None
            return (f"{os.path.relpath(absfn, _REPO_ROOT)}:"
                    f"{frame.f_lineno}")
        frame = frame.f_back
    return None


class _State:
    """One sanitizer session's graph + write log."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._tls = threading.local()
        # (held_site, acquired_site) -> {"count": n, "stack": text}
        self.edges = {}
        # (name, owner token) -> {thread: [frozenset(held ids), ...]}
        self.writes = {}
        self.recursive = []     # [{"site", "stack"}]
        self.lock_count = 0

    # -- per-thread held list ----------------------------------------

    def _held(self):
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def on_acquire(self, lock, blocking, timeout):
        held = self._held()
        # Only an UNbounded blocking re-acquire is a certain
        # deadlock; a timed acquire legally returns False at its
        # deadline (the checked-probe pattern) and must not raise.
        if blocking and timeout < 0 and not lock._san_reentrant \
                and any(h is lock for h, _ in held):
            stack = "".join(traceback.format_stack(
                limit=_STACK_LIMIT))
            with self._mu:
                self.recursive.append({"site": lock._san_site,
                                       "stack": stack})
            raise RuntimeError(
                "tsan: blocking re-acquire of non-reentrant Lock "
                f"created at {lock._san_site} — certain deadlock")

    def on_acquired(self, lock):
        held = self._held()
        new_edges = []
        for h, _ in held:
            if h is lock:       # RLock recursion: no new edge
                continue
            if h._san_site == lock._san_site:
                continue        # same-site peers: documented skip
            key = (h._san_site, lock._san_site)
            new_edges.append(key)
        held.append((lock, None))
        if not new_edges:
            return
        with self._mu:
            for key in new_edges:
                rec = self.edges.get(key)
                if rec is None:
                    self.edges[key] = {
                        "count": 1,
                        "stack": "".join(traceback.format_stack(
                            limit=_STACK_LIMIT)),
                    }
                else:
                    rec["count"] += 1

    def on_release(self, lock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    def on_release_all(self, lock):
        """Condition.wait's _release_save: drop every held entry of
        ``lock`` (an RLock released through its full recursion
        depth). Returns the count for _acquire_restore."""
        held = self._held()
        count = 0
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                count += 1
        return count

    def on_reacquired(self, lock, count):
        """Condition.wait's _acquire_restore: restore the held
        entries WITHOUT minting order edges — the wakeup re-acquire
        is the stdlib's doing, not an ordering choice in repo
        code."""
        held = self._held()
        for _ in range(max(count, 1)):
            held.append((lock, None))

    def held_ids(self):
        return frozenset(id(h) for h, _ in self._held())

    # -- shared-structure writes -------------------------------------

    def _owner_token(self, owner):
        """A stable per-instance token. id() alone can be recycled
        after gc — two sequential managers aliasing one key would
        merge unrelated write histories into a false finding — so
        the token is minted once (from a MODULE-global counter: a
        per-session counter would hand a fresh session's instance a
        token some long-lived instance already pinned across the
        session boundary) and pinned on the instance."""
        if owner is None:
            return ""
        tok = getattr(owner, "_tsan_token", None)
        if tok is None:
            tok = next(_OWNER_TOKENS)
            try:
                owner._tsan_token = tok
            except (AttributeError, TypeError):
                tok = id(owner)
        return tok

    def on_write(self, name, owner=None):
        thread = threading.current_thread().name
        held = self.held_ids()
        key = (name, self._owner_token(owner))
        with self._mu:
            per = self.writes.setdefault(key, {})
            samples = per.setdefault(thread, [])
            if len(samples) < 64 and held not in samples:
                samples.append(held)

    # -- reporting ----------------------------------------------------

    def cycles(self):
        """Site-level cycles, each as the ordered list of sites with
        per-edge sample stacks."""
        graph = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
        index = {}
        low = {}
        on_stack = set()
        stack = []
        sccs = []
        counter = [0]

        def strongconnect(v):
            # Iterative Tarjan: suites create enough edges that
            # recursion depth is a real hazard.
            work = [(v, iter(sorted(graph.get(v, ()))))]
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            while work:
                node, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(sorted(
                            graph.get(w, ())))))
                        advanced = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
                if low[node] == index[node]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        scc.append(w)
                        if w == node:
                            break
                    if len(scc) > 1:
                        sccs.append(sorted(scc))

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        out = []
        for scc in sccs:
            members = set(scc)
            sample = {
                f"{a} -> {b}": self.edges[(a, b)]["stack"]
                for (a, b) in self.edges
                if a in members and b in members
            }
            out.append({"sites": scc, "edges": sample})
        return out

    def unguarded(self):
        """Structures (per owning instance) written by >= 2 threads
        with no common lock held across every sampled write."""
        out = []
        seen_names = set()
        for (name, _tok), per in sorted(self.writes.items(),
                                        key=lambda kv: kv[0][0]):
            if len(per) < 2 or name in seen_names:
                continue
            all_sets = [s for samples in per.values()
                        for s in samples]
            common = frozenset.intersection(*all_sets) \
                if all_sets else frozenset()
            if not common:
                seen_names.add(name)   # one finding per name
                out.append({"name": name,
                            "threads": sorted(per)})
        return out

    def report(self):
        return {
            "locks_created": self.lock_count,
            "edges": len(self.edges),
            "cycles": self.cycles(),
            "unguarded_writes": self.unguarded(),
            "recursive_acquires": self.recursive,
        }


class _SanLockBase:
    """Wrapper over a real lock primitive; tracking delegates to the
    installing session's _State."""

    _san_reentrant = False

    def __init__(self, state, real, site):
        self._state = state
        self._real = real
        self._san_site = site
        with state._mu:
            state.lock_count += 1

    def acquire(self, blocking=True, timeout=-1):
        self._state.on_acquire(self, blocking, timeout)
        got = self._real.acquire(blocking, timeout)
        if got:
            self._state.on_acquired(self)
        return got

    # Some callers (Condition's _is_owned probe) pass positionally.
    def release(self):
        self._real.release()
        self._state.on_release(self)

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()  # lint: disable=lock-with (IS the `with` impl)
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return (f"<tsan {type(self).__name__} site={self._san_site} "
                f"real={self._real!r}>")


class _SanLock(_SanLockBase):
    _san_reentrant = False


class _SanRLock(_SanLockBase):
    _san_reentrant = True

    # The Condition protocol. Without these, Condition falls back to
    # a single release() (wrong past recursion depth 1) and to an
    # acquire(False) ownership probe — which SUCCEEDS on a re-entrant
    # lock the thread already holds, making wait()/notify() raise
    # "cannot wait on un-acquired lock" while the lock is held.
    # Delegate to the real RLock's own implementations, keeping the
    # held-entry bookkeeping balanced across the full-depth release.

    def _is_owned(self):
        return self._real._is_owned()

    def _release_save(self):
        saved = self._real._release_save()
        count = self._state.on_release_all(self)
        return (saved, count)

    def _acquire_restore(self, saved):
        real_saved, count = saved
        self._real._acquire_restore(real_saved)
        self._state.on_reacquired(self, count)


_INSTALL_MU = _REAL_LOCK()
_ACTIVE = []     # stack of _State (session() nests)
_PREVIOUS = []   # the (Lock, RLock) each install() replaced


def _make_factories(state):
    def Lock():
        site = _creation_site()
        if site is None:
            return _REAL_LOCK()
        return _SanLock(state, _REAL_LOCK(), site)

    def RLock():
        site = _creation_site()
        if site is None:
            return _REAL_RLOCK()
        return _SanRLock(state, _REAL_RLOCK(), site)

    return Lock, RLock


def enabled():
    """True while a sanitizer session is installed."""
    return bool(_ACTIVE)


def env_requested():
    return env_str(TSAN_ENV, "") not in ("", "0")


def install(force=False):
    """Swap threading.Lock/RLock for the tracking wrappers. No-op
    unless CEA_TPU_TSAN=1 or ``force``. Returns the session state (or
    None when not installed). Locks created BEFORE install are
    untracked: install as early as the harness allows."""
    if not (force or env_requested()):
        return None
    with _INSTALL_MU:
        state = _State()
        _PREVIOUS.append((threading.Lock, threading.RLock))
        _ACTIVE.append(state)
        threading.Lock, threading.RLock = _make_factories(state)
        return state


def uninstall():
    """Pop the innermost session and put back the constructors its
    install() replaced."""
    with _INSTALL_MU:
        if not _ACTIVE:
            return None
        state = _ACTIVE.pop()
        threading.Lock, threading.RLock = _PREVIOUS.pop()
        return state


class session:
    """``with tsan.session(force=True) as state:`` — a scoped
    install/uninstall for tests and fixtures."""

    def __init__(self, force=False):
        self._force = force
        self.state = None

    def __enter__(self):
        self.state = install(force=self._force)
        return self.state

    def __exit__(self, *exc):
        if self.state is not None:
            uninstall()
        return False


def current():
    """The innermost active session state, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def note_write(name, owner=None):
    """Mark a mutation of a registered hot structure; ``owner`` is
    the instance holding it (writes are analyzed per instance — two
    managers' queues each have their own lock). Call sites pay one
    truthiness check when the sanitizer is off."""
    if _ACTIVE:
        _ACTIVE[-1].on_write(name, owner)


def report():
    """The innermost session's findings (empty report when off)."""
    state = current()
    if state is None:
        return {"locks_created": 0, "edges": 0, "cycles": [],
                "unguarded_writes": [], "recursive_acquires": []}
    return state.report()


def is_clean(rep=None):
    rep = rep if rep is not None else report()
    return not (rep["cycles"] or rep["unguarded_writes"]
                or rep["recursive_acquires"])


def format_report(rep=None):
    rep = rep if rep is not None else report()
    lines = [f"tsan: {rep['locks_created']} locks, "
             f"{rep['edges']} order edges"]
    for cyc in rep["cycles"]:
        lines.append("LOCK-ORDER CYCLE: " + " <-> ".join(
            cyc["sites"]))
        for edge, stack in sorted(cyc["edges"].items()):
            lines.append(f"  edge {edge}\n{stack}")
    for w in rep["unguarded_writes"]:
        lines.append(
            f"UNGUARDED WRITES to {w['name']} from threads "
            f"{w['threads']} with no common lock")
    for r in rep["recursive_acquires"]:
        lines.append(
            f"RECURSIVE ACQUIRE of Lock at {r['site']}\n"
            f"{r['stack']}")
    return "\n".join(lines)

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

"""Program-count guard: the slot engine's launch-shape bound, enforced
(the port's stand-in for the JAX package's analysis/retrace.py).

The JAX engine's bound is its compiled-program set: one admission
prefill a bucket, one insert, one step, whatever the traffic. The port
compiles no programs; what stands for one is a distinct launch shape:
the shapes, dtypes and devices of the tensors a call hands its
kernels, and the flag values that pick a code path. A shape that leaks
(an unpadded prompt, a per-row length reaching a tensor's shape) makes
every admission a fresh set of kernel configurations, allocator
blocks and, on the card, cuDNN/cuBLAS heuristics; nothing fails, the
engine only gets slower.

``ProgramGuard`` watches named callables (a module function, or a
method of one object) for the guarded region: each call's program is
the signature of its arguments plus the signatures of the model calls
it makes (``watch_model``), and each name may see at most its budget
of distinct programs. ``watch_captures`` counts CUDA-graph captures
(``torch.cuda.CUDAGraph.capture_begin``) against a budget of their own.
On a clean exit the guard raises ``ProgramBoundError`` naming every
program over budget and by how much.

``engine_guard(engine)`` holds a ``SlotDecodeEngine`` to its bound:
``engine.prefill`` one program a bucket, ``engine.insert`` one (the
paged pool's arena write; the dense pool prefills into the slot's rows
and has none), ``engine.step`` one, and no CUDA-graph capture.

Stdlib only at import time (torch is imported inside the calls that
need it), as the rest of ``analysis``.
"""

import threading


class ProgramBoundError(AssertionError):
    """A watched callable saw more distinct launch shapes than its
    budget inside the guarded region."""


def signature(value):
    """A hashable launch signature of ``value``: a tensor's shape,
    dtype and device type; sequences and mappings element-wise (one
    that holds no tensor and no flag counts as nothing); str and bool
    as they are (flags that pick a path). Other values (host ints and
    their lists, None, modules, generators) are runtime arguments, not
    shapes, and count as nothing."""
    shape = getattr(value, "shape", None)
    if shape is not None and hasattr(value, "dtype"):
        device = getattr(value, "device", None)
        return ("T", tuple(int(d) for d in shape), str(value.dtype),
                getattr(device, "type", str(device)))
    if isinstance(value, (str, bool)):
        return value
    if isinstance(value, dict):
        sig = tuple(sorted((k, signature(v)) for k, v in value.items()))
        return sig if any(v != "-" for _, v in sig) else "-"
    if isinstance(value, (list, tuple)):
        sig = tuple(signature(v) for v in value)
        return sig if any(v != "-" for v in sig) else "-"
    return "-"


class _Watch:
    def __init__(self, name, owner, attr, budget):
        self.name, self.owner, self.attr = name, owner, attr
        self.budget = int(budget)
        self.programs = set()
        self.original = None


class ProgramGuard:
    """Per-callable launch-shape budgets over a region (module
    docstring).

    >>> guard = ProgramGuard()
    >>> guard.watch("engine.step", engine, "step", max_new=1)
    >>> with guard:
    ...     drive_mixed_traffic()
    """

    def __init__(self):
        self._watches = []
        self._models = []
        self._captures = None
        self._hooks = []
        self._local = threading.local()
        self._entered = False

    def watch(self, name, owner, attr, max_new=1):
        """Watch ``getattr(owner, attr)`` (a module's function, or an
        object's method, patched on ``owner`` for the region): at most
        ``max_new`` distinct programs."""
        if not callable(getattr(owner, attr, None)):
            raise TypeError(f"{name}: {owner!r}.{attr} is not callable")
        self._watches.append(_Watch(name, owner, attr, max_new))
        return self

    def watch_model(self, model):
        """Fold ``model``'s calls inside a watched call into that call's
        program (a forward pre-hook for the region)."""
        self._models.append(model)
        return self

    def watch_captures(self, name="cuda_graph.capture", max_new=0):
        """Count CUDA-graph captures in the region against ``max_new``."""
        self._captures = _Watch(name, None, "capture_begin", max_new)
        self._captures.count = 0
        return self

    # -- the region -------------------------------------------------------

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _wrap(self, watch):
        original = watch.original

        def wrapper(*args, **kwargs):
            calls = []
            self._stack().append(calls)
            try:
                return original(*args, **kwargs)
            finally:
                self._stack().pop()
                watch.programs.add((signature(args), signature(kwargs),
                                    tuple(calls)))
        return wrapper

    def _model_hook(self, module, args, kwargs):
        stack = self._stack()
        if stack:
            stack[-1].append((signature(args), signature(kwargs)))

    def __enter__(self):
        if self._entered:
            raise RuntimeError("guard already entered")
        self._entered = True
        for watch in self._watches:
            watch.programs = set()
            watch.original = getattr(watch.owner, watch.attr)
            # A module's function or an attribute of the object itself
            # is put back; a method the object's class provides is
            # shadowed by an instance attribute, then deleted.
            watch.own = watch.attr in vars(watch.owner)
            setattr(watch.owner, watch.attr, self._wrap(watch))
        for model in self._models:
            self._hooks.append(model.register_forward_pre_hook(
                self._model_hook, with_kwargs=True))
        if self._captures is not None:
            import torch

            cap = self._captures
            cap.count = 0
            cap.owner = torch.cuda.CUDAGraph
            cap.original = cap.owner.capture_begin

            def capture_begin(graph, *args, **kwargs):
                cap.count += 1
                return cap.original(graph, *args, **kwargs)

            cap.owner.capture_begin = capture_begin
        return self

    def _restore(self):
        for watch in self._watches:
            if watch.original is not None:
                if watch.own:
                    setattr(watch.owner, watch.attr, watch.original)
                else:
                    delattr(watch.owner, watch.attr)
                watch.original = None
        for hook in self._hooks:
            hook.remove()
        del self._hooks[:]
        cap = self._captures
        if cap is not None and cap.original is not None:
            cap.owner.capture_begin = cap.original
            cap.original = None
        self._entered = False

    def programs(self):
        """{name: distinct programs seen in the region}."""
        out = {w.name: len(w.programs) for w in self._watches}
        if self._captures is not None:
            out[self._captures.name] = self._captures.count
        return out

    def budgets(self):
        out = {w.name: w.budget for w in self._watches}
        if self._captures is not None:
            out[self._captures.name] = self._captures.budget
        return out

    def check(self):
        """Raise ProgramBoundError when a watched name is over budget;
        return the counts otherwise."""
        counts, budgets = self.programs(), self.budgets()
        over = [(name, counts[name], budgets[name]) for name in counts
                if counts[name] > budgets[name]]
        if over:
            detail = "; ".join(
                f"{name}: {got} distinct launch shapes (budget {budget}, "
                f"over by {got - budget})" for name, got, budget in over)
            raise ProgramBoundError(
                f"program-count bound violated: {detail}. A shape leaks "
                f"into a launch: pad prompts to a bucket, keep per-row "
                f"values in tensors of a fixed shape.")
        return counts

    def __exit__(self, exc_type, exc, tb):
        self._restore()
        # Only assert on the clean path: an exception inside the region
        # already carries the real failure.
        if exc_type is None:
            self.check()
        return False


def engine_programs(engine):
    """(name, owner, attr) of the slot engine's programs: the admission
    prefill (``models.decode``'s dense or paged prefill function), the
    paged pool's insert, and the step."""
    from ..models import decode

    prefill = "_paged_prefill_impl" if engine.paged else "_slot_prefill"
    out = [("engine.prefill", decode, prefill)]
    if engine.paged:
        out.append(("engine.insert", engine, "_paged_insert"))
    out.append(("engine.step", engine, "step"))
    return out


def engine_guard(engine, prefill_budget=None):
    """A guard preloaded with ``engine``'s bound: ``prefill_budget``
    admission programs (default: one a bucket the paged pool was
    configured with; the dense pool prefills the widths its caller pads
    to, so its caller gives the count), one insert (paged), one step,
    the model's calls folded into each, and no CUDA-graph capture.
    Enter it after the engine is built."""
    if engine._draft_model is not None:
        raise ValueError("engine_guard holds a draft-free engine; a "
                         "speculative engine adds draft programs")
    if prefill_budget is None:
        buckets = getattr(engine, "_buckets", None)
        if not buckets:
            raise ValueError("the engine has no buckets of its own: pass "
                             "prefill_budget, the widths its caller pads "
                             "to")
        prefill_budget = len(buckets)
    guard = ProgramGuard()
    for name, owner, attr in engine_programs(engine):
        guard.watch(name, owner, attr,
                    max_new=prefill_budget if name == "engine.prefill"
                    else 1)
    guard.watch_model(engine._model)
    guard.watch_captures()
    return guard

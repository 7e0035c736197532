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


"""The trainer (counterpart of
container_engine_accelerators_tpu/parallel/train.py).

The JAX Trainer jit-compiles one SPMD step over a ("data", "model")
mesh. The port runs the same step eagerly: forward, loss, backward
through the port's kernels, then the optimizer; on one device, or with
``mesh=`` (a ``parallel.mesh`` DeviceMesh) as one rank of the mesh,
with ``fsdp=`` sharding the big kernels and their momentum over the
data axis (``parallel/spmd.py`` holds the layout and the collectives).
Parameters and optimizer state are updated in place (what the JAX
step's state donation does), so ``train_step`` hands back the state it
was given. The loss comes back as a device tensor: nothing in the step
reads the device from the host.

The optimizer is ``Sgd``, the counterpart of the demo driver's optax
chain: optional ``clip_by_global_norm``, then ``add_decayed_weights``
with a mask, then ``sgd`` with momentum and a learning-rate schedule
read at the update count before the update, as optax reads it.

remat, gradient accumulation, augmentation, EMA, the eval step and the
step telemetry (straggler detector, MFU and goodput ledgers, the
``train.step_compile`` / ``train.step_run`` spans and the
``train.step_summary`` event) follow the JAX Trainer (``Trainer``'s
docstring). A step without state donation raises "not yet ported".
"""

import contextlib
import copy
import dataclasses
import inspect
import time
from typing import Any

import torch
import torch.utils.checkpoint

from .. import obs
from ..models.layers import BatchNorm
from ..obs.efficiency import (
    TRAIN_MFU_GAUGE,
    FlopsLedger,
    GoodputLedger,
    count_flops,
    device_kind,
    peak_flops_per_chip,
    transformer_train_flops,
)
from ..utils import not_ported, step_generator
from .mesh import build_mesh
from .spmd import Spmd


@dataclasses.dataclass
class TrainState:
    """What a step carries: ``step`` is the host count of updates
    applied; ``model`` holds the parameters and the BN running
    statistics (its buffers, updated by the train-mode forward),
    ``optimizer`` the momentum traces, all updated in place; ``ema``
    the EMA shadow {name: tensor} (None when EMA is off)."""

    step: int
    model: Any
    optimizer: Any
    ema: Any = None

    @property
    def batch_stats(self):
        """{name: tensor}: the model's buffers (the BN running mean and
        variance; empty for a model without BN)."""
        return dict(self.model.named_buffers())


class Sgd:
    """clip_by_global_norm (when ``grad_clip`` > 0) -> masked
    add_decayed_weights -> sgd(learning_rate, momentum), as optax.

    ``learning_rate``: a float, or a schedule ``count -> float`` read
    at the number of updates applied before this one. ``decay_mask``:
    ``(name, parameter) -> bool``, True where weight decay applies
    (None: everywhere, as optax without a mask).

    optax's sgd keeps ``trace = g + momentum * trace`` and applies
    ``-lr * trace``, with the decayed weights added to ``g`` first:
    ``torch.optim.SGD`` with dampening 0 and nesterov off is that
    update, its parameter groups carry the mask, and its step is given
    the schedule's value. The clip is written out here because
    ``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and optax
    does not."""

    def __init__(self, learning_rate, momentum=0.0, weight_decay=0.0,
                 decay_mask=None, grad_clip=0.0):
        self.learning_rate = learning_rate
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.decay_mask = decay_mask
        self.grad_clip = float(grad_clip)

    def lr(self, count):
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(self.learning_rate)

    def init(self, model):
        """A torch.optim.SGD over ``model``'s trainable parameters,
        one group with the decay and one without."""
        decayed, plain = [], []
        for name, param in model.named_parameters():
            if not param.requires_grad:
                continue
            mask = self.decay_mask
            (decayed if mask is None or mask(name, param) else
             plain).append(param)
        groups = [{"params": params, "weight_decay": wd}
                  for params, wd in ((decayed, self.weight_decay),
                                     (plain, 0.0)) if params]
        return torch.optim.SGD(groups, lr=self.lr(0),
                               momentum=self.momentum, dampening=0.0,
                               nesterov=False)

    def update(self, optimizer, count, norm=None):
        """Apply one update from the parameters' ``.grad``: clip, then
        the optimizer's step at the schedule's value for ``count``.
        ``norm``: the whole gradient's global norm where the ``.grad``
        are shards of it (``Spmd.grad_norm``); None reads it from them."""
        if self.grad_clip > 0:
            clip_by_global_norm(
                [p.grad for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None],
                self.grad_clip, norm=norm)
        lr = self.lr(count)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()


ADAM_BETAS = (0.9, 0.999)  # optax.adam's b1, b2
ADAM_EPS = 1e-8


class Adam(Sgd):
    """optax.adam(learning_rate) with its default b1, b2 and eps:
    ``torch.optim.Adam``'s step (no weight decay, no amsgrad). ``Sgd``'s
    interface with no clip (optax.adam clips nothing). The multichip
    dryrun's MoE stage trains on it, as the JAX dryrun on optax's."""

    def init(self, model):
        """A torch.optim.Adam over ``model``'s trainable parameters."""
        return torch.optim.Adam(
            [p for p in model.parameters() if p.requires_grad],
            lr=self.lr(0), betas=ADAM_BETAS, eps=ADAM_EPS)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm, norm=None):
    """optax.clip_by_global_norm in place: g is left as it is when the
    global L2 norm is below ``max_norm``, else becomes
    ``(g / norm) * max_norm``; no epsilon. Stays on the device.
    ``norm``: the global norm when ``grads`` are not all of it."""
    if not grads:
        return
    if norm is None:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))


def cross_entropy_loss(logits, labels, label_smoothing=0.0):
    """Mean softmax cross entropy; labels are int class ids (the plain
    loss behind --no-pallas-loss). A label outside [0, C) has an
    all-zero one-hot, as jax.nn.one_hot gives it."""
    num_classes = logits.shape[-1]
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (labels.long()[..., None] == classes).to(logits.dtype)
    if label_smoothing:
        onehot = (onehot * (1.0 - label_smoothing)
                  + label_smoothing / num_classes)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.mean(torch.sum(onehot.float() * logp, dim=-1))


AUGMENT_KEY = 17  # the JAX step's PRNGKey(17) for augment_fn


class Trainer:
    """Owns one model's train and eval steps, on one device or as one
    rank of a mesh.

    ``model(inputs) -> logits``, or ``model(inputs, step=...)`` for a
    model with step-keyed randomness (Inception's dropout; detected
    from the forward's signature, as the JAX Trainer detects a ``step``
    argument of its apply function); ``loss_fn(logits, labels) ->
    scalar``; ``optimizer``: an ``Sgd`` or an ``Adam``.

    - ``remat``: the forward runs under ``torch.utils.checkpoint``
      (non-reentrant) and is recomputed in the backward, as
      ``jax.checkpoint`` on the apply function. The recomputation
      leaves the BN running statistics alone, so a step with remat
      gives the loss, gradients and statistics of the step without it.
    - ``grad_accum``: the batch is cut into that many equal chunks, run
      one after another with one optimizer update: the gradient and
      the loss are the means over the chunks, the BN running
      statistics pass from chunk to chunk, and chunk ``idx`` sees the
      virtual step ``step * grad_accum + idx``.
    - ``augment_fn(generator, images) -> images`` runs in train steps
      only, with a generator seeded from (17, step) on the batch's
      device: a step repeats its augmentation.
    - ``ema_decay``: an EMA shadow of the parameters, seeded as their
      copy, becomes ``e * d + p * (1 - d)`` after each update;
      ``eval_params`` reads it.
    - ``mesh``: a ("data", "model") DeviceMesh (``parallel.mesh.
      build_mesh``), a ("data", "context") one (``context.
      build_context_mesh``: each context rank runs its slice of the
      sequence, an LM whose attention_fn is the ring or Ulysses
      schedule over the axis), a ("data", "expert") one
      (``expert.build_expert_mesh``: a MoE bound to it holds its E/P
      experts) or the three axes at once (``dryrun.combined_mesh``)
      this process is one rank of. ``train_step`` and
      ``eval_step`` then take the GLOBAL batch, as the JAX steps do:
      each data rank computes on its slice (a grad_accum chunk is cut
      from the global batch first, then sliced), the gradients and
      BatchNorm statistics are averaged over the data axis, wide
      kernels are column-parallel over the model axis, and the loss
      returned is the global batch's. ``fsdp``: big kernels, their
      momentum and EMA shadow are stored as 1/N shards over the data
      axis (a mesh over the whole world is built when none is given).
      ``parallel/spmd.py`` has the details; ``full_state`` makes the
      state whole for a checkpoint, ``state_shardings`` lays a
      checkpoint's whole leaves out for this rank, and ``remesh``
      rebinds the configuration to another mesh (elastic recovery,
      ``parallel/elastic.py``).

    Step telemetry, as the JAX Trainer's:

    - ``straggler``: an ``obs.straggler.StragglerDetector`` fed every
      step's time and data wait under ``host_id`` (default
      ``host<rank>``); a ``train.step_summary`` journal event (p50/max
      step time, data wait) every ``summary_every`` steps is what a
      merged fleet view replays.
    - ``mfu_source`` picks the per-step FLOPs numerator: "auto" counts
      the first step (``obs.efficiency.count_flops``: FlopCounterMode's
      products plus each flash kernel's declared products, one count on
      the card and on the CPU; the analytic form if it counts nothing),
      "analytic" the 6·N·B·S estimate, "off" no MFU, a number pins it.
      On a mesh the numerator is the global batch's step (the data
      ranks' counts summed; on a model axis wider than one, the
      analytic form over the whole parameters) and the ledger rates it
      across the mesh's ranks, as the JAX Trainer across its devices.
      The MFU ledger's denominator is the wall time between step
      boundaries: a CUDA call returns before the device finishes, and
      the gap to the next boundary is where the device computed.
    - ``goodput``: the ``GoodputLedger`` (a fresh one by default, its
      wall clock running from construction). The first step goes to
      ``compile`` (kernel builds, cuDNN autotuning, the FLOP count)
      under the ``train.step_compile`` span, later steps to
      ``productive`` under ``train.step_run``; ``record_data_wait`` and
      ``record_badput`` are the seams train.py records through.
    - ``train.step_run`` and, inside every step, ``train.forward``,
      ``train.backward`` and ``train.update`` carry their time on the
      device's stream (``device_s``; ``obs.trace``), without a sync.
    """

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 donate_state=True, remat=False, grad_accum=1,
                 augment_fn=None, ema_decay=0.0, fsdp=False,
                 host_id=None, straggler=None, summary_every=32,
                 mfu_source="auto", goodput=None):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1: {grad_accum}")
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1): {ema_decay}")
        if not donate_state:
            raise not_ported(f"Trainer(donate_state={donate_state!r})")
        if not (mfu_source in ("auto", "analytic", "off")
                or isinstance(mfu_source, (int, float))):
            raise ValueError(
                f"mfu_source must be auto/analytic/off or a FLOPs "
                f"count: {mfu_source!r}")
        if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
            raise TypeError(f"mesh must be a DeviceMesh (parallel.mesh."
                            f"build_mesh), got {type(mesh).__name__}")
        if fsdp and mesh is None:
            mesh = build_mesh()
        self.mesh = mesh
        self._fsdp = bool(fsdp)
        # The model's structure before the layout slices it, for remesh
        # (meta tensors: no storage).
        self._skeleton = None
        if mesh is not None:
            try:
                self._skeleton = _meta_copy(model, keep=(mesh,))
            except Exception as e:  # raised by remesh, which needs it
                self._skeleton = e
        self._spmd = (Spmd(mesh, model, fsdp=fsdp) if mesh is not None
                      else None)
        self.model = model
        self._loss = loss_fn
        self._tx = optimizer
        self._remat = bool(remat)
        self._grad_accum = int(grad_accum)
        self._augment = augment_fn
        self._ema_decay = float(ema_decay)
        self._wants_step = "step" in inspect.signature(
            model.forward).parameters
        self._host_id = host_id
        self._straggler = straggler
        self._summary_every = max(1, int(summary_every))
        self._steps_seen = 0
        self._step_window = []
        self._wait_window = []
        self._pending_data_wait = 0.0
        self._mfu_source = mfu_source
        self._flops_per_step = None
        self._mfu_ledger = None
        self.goodput = goodput if goodput is not None else GoodputLedger()
        self._last_step_end = None
        self._stepped = False

    def init_state(self, params=None):
        """A TrainState at step 0 with fresh momentum traces (and the
        EMA shadow when ``ema_decay`` is on). ``params``: a whole
        state_dict ({name: tensor}, buffers included) loaded into the
        model first, each entry laid out for the mesh
        (``state_shardings``), as the JAX ``init_state(variables)``
        places its variables."""
        if params is not None:
            local = self.state_shardings(None).local
            self.model.load_state_dict(
                {name: local(name, value) for name, value in params.items()})
        return self.ensure_ema(TrainState(
            step=0, model=self.model, optimizer=self._tx.init(self.model)))

    def state_shardings(self, state):
        """How a whole checkpoint leaf lays out on this rank
        (``restore_state(shardings=)``): a ``StateShardings`` over this
        Trainer's layout (the identity off a mesh). ``state`` is
        accepted for the JAX signature; the layout is the Trainer's."""
        return StateShardings(self._spmd)

    def remesh(self, mesh):
        """A fresh Trainer bound to ``mesh`` with this one's exact
        configuration, the elastic-recovery path. Its model is a new
        instance of this one's structure on the same device, whole
        before the new layout slices it, with uninitialized values: a
        restore (``restore_state(shardings=)``) or ``init_state(params=)``
        fills them. The goodput ledger carries over (recovery is one
        run's wall time, not a new run); the host identity re-resolves
        lazily (ranks renumber after an eviction)."""
        source = self._skeleton
        if isinstance(source, Exception):
            raise ValueError(f"remesh needs a copy of the model's "
                             f"structure, which failed: {source}")
        if source is None:
            source = _meta_copy(self.model)
        model = _meta_copy(source).to_empty(device=self._device())
        return Trainer(model, self._loss, self._tx, mesh=mesh,
                       remat=self._remat, grad_accum=self._grad_accum,
                       augment_fn=self._augment,
                       ema_decay=self._ema_decay, fsdp=self._fsdp,
                       straggler=self._straggler,
                       summary_every=self._summary_every,
                       mfu_source=self._mfu_source, goodput=self.goodput)

    def _forward(self, images, step):
        def forward(x):
            if self._wants_step:
                return self.model(x, step=step)
            return self.model(x)

        if not self._remat:
            return forward(images)
        return torch.utils.checkpoint.checkpoint(
            forward, images, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                _frozen_running_stats(self.model)))

    def train_step(self, state, batch):
        """One step: (inputs, labels) -> (state, loss). ``state`` is
        updated in place and returned; the loss is a 0-d device
        tensor.

        The first call is the compile step (``train.step_compile``, the
        goodput ledger's compile bucket; it also resolves the FLOPs
        numerator); later calls run under ``train.step_run`` and feed
        the step telemetry. With tracing off and no straggler detector
        the span objects are skipped, the ledgers still record."""
        if not self._stepped:
            t0 = time.perf_counter()
            with obs.span("train.step_compile"):
                out = self._first_step(state, batch)
            self._stepped = True
            self.goodput.record("compile", time.perf_counter() - t0)
            return out
        if not obs.TRACER.enabled and self._straggler is None:
            t0 = time.perf_counter()
            out = self._step(state, batch)
            self._record_step(time.perf_counter() - t0)
            return out
        t0 = time.perf_counter()
        with obs.span("train.step_run", timed_on=self._device()):
            out = self._step(state, batch)
        self._record_step(time.perf_counter() - t0)
        return out

    def _first_step(self, state, batch):
        """The first step, with the FLOPs numerator pinned on it."""
        src = self._mfu_source
        spmd = self._spmd
        if src == "auto":
            out, flops = count_flops(self._step, state, batch)
            if spmd is not None:
                # A rank counted its slice of the batch (and of the
                # sequence); on a model or expert axis its count mixes
                # split and replicated work, which no sum over ranks
                # undoes: the analytic form then.
                flops = (spmd.sum_over_data(flops, self._device())
                         if spmd.mp == 1 and spmd.ep == 1 else 0)
            self._flops_per_step = flops or None
        else:
            out = self._step(state, batch)
            if isinstance(src, (int, float)):
                self._flops_per_step = float(src)
        if src in ("auto", "analytic") and self._flops_per_step is None:
            n = (spmd.whole_numel(self.model) if spmd is not None
                 else sum(p.numel() for p in self.model.parameters()))
            inputs = batch[0]
            # B·S for token models ([B, S] int batches), B for image
            # models (the "sequence" is one sample).
            tokens = int(inputs.shape[0]) * (
                int(inputs.shape[1]) if inputs.dim() == 2 else 1)
            self._flops_per_step = transformer_train_flops(n, tokens)
        return out

    def _local(self, x):
        """This rank's slice of a global batch (the batch itself off a
        mesh)."""
        return x if self._spmd is None else self._spmd.local_batch(x)

    def _context(self):
        """Whether the step runs sequence-sharded (a context axis wider
        than one rank)."""
        return self._spmd is not None and self._spmd.cp > 1

    def _loss_of(self, images, labels, step):
        """The forward and the loss of one (micro)batch of the global
        batch: this rank's data slice, and on a context axis its slice
        of the sequence, whose loss is weighed by the slice's share of
        the S - 1 shifted positions (the label window reaches one
        token into the next rank's slice; ``next_token_loss_fn``)."""
        images, labels = self._local(images), self._local(labels)
        if not self._context():
            return self._loss(self._forward(images, step), labels)
        spmd = self._spmd
        seq = images.shape[1]
        shard, start = spmd.local_sequence(images)
        size = shard.shape[1]
        window = labels[:, start:start + size + 1]
        self.model.seq_offset = start
        valid = min(size, seq - 1 - start)
        return self._loss(self._forward(shard, step), window) * (
            valid / (seq - 1))

    def _step(self, state, batch):
        """The step's work, in ``train.forward``, ``train.backward`` (a
        pair per micro-batch) and ``train.update`` spans timed on the
        device."""
        images, labels = batch
        dev = self._device()
        if self._augment is not None:
            images = self._augment(step_generator(
                AUGMENT_KEY, state.step, images.device), images)
        state.optimizer.zero_grad(set_to_none=True)
        accum = self._grad_accum
        if accum == 1:
            with obs.span("train.forward", timed_on=dev):
                loss = self._loss_of(images, labels, state.step)
            with obs.span("train.backward", timed_on=dev):
                loss.backward()
            loss = loss.detach()
        else:
            if images.shape[0] % accum:
                raise ValueError(
                    f"global batch {images.shape[0]} not divisible into "
                    f"grad_accum={accum} microbatches")
            loss = torch.zeros((), dtype=torch.float32, device=images.device)
            chunks = zip(images.chunk(accum), labels.chunk(accum))
            for idx, (images_c, labels_c) in enumerate(chunks):
                with obs.span("train.forward", timed_on=dev):
                    chunk_loss = self._loss_of(images_c, labels_c,
                                               state.step * accum + idx)
                with obs.span("train.backward", timed_on=dev):
                    (chunk_loss / accum).backward()
                loss = loss + chunk_loss.detach().float() / accum
        norm = None
        if self._spmd is not None:
            self._spmd.reduce_grads(self.model)
            loss = self._spmd.mean_over_data(loss)
            if self._tx.grad_clip > 0:
                norm = self._spmd.grad_norm(self.model)
        with obs.span("train.update", timed_on=dev):
            self._tx.update(state.optimizer, state.step, norm=norm)
        if self._ema_decay:
            self._update_ema(state)
        state.step += 1
        return state, loss

    def host_id(self):
        """This trainer's host identity for step telemetry."""
        if self._host_id is None:
            rank = (torch.distributed.get_rank()
                    if torch.distributed.is_available()
                    and torch.distributed.is_initialized() else 0)
            self._host_id = f"host{rank}"
        return self._host_id

    def record_data_wait(self, seconds):
        """Attribute input-pipeline wait to the NEXT step's telemetry
        and to the goodput ledger; wire as ``PrefetchLoader(wait_cb=)``
        (its one consumer is the train loop's thread)."""
        self._pending_data_wait += float(seconds)
        self.goodput.record("data_wait", seconds)

    def record_badput(self, bucket, seconds):
        """Attribute non-step wall time (checkpoint, restart recovery)
        to the goodput ledger (train.py records restores here)."""
        self.goodput.record(bucket, seconds)

    def flops_per_step(self):
        """Model FLOPs of one step (None before the first step, or with
        mfu_source="off")."""
        return self._flops_per_step

    def _mfu(self):
        """The MFU ledger, built at first use: the peak of the model's
        device (a known card, or CEA_TPU_PEAK_FLOPS)."""
        if self._mfu_ledger is None:
            self._mfu_ledger = FlopsLedger(
                gauge=TRAIN_MFU_GAUGE,
                peak_flops=peak_flops_per_chip(device_kind(self._device())),
                chips=1 if self.mesh is None else self.mesh.size(),
                publish_every=self._summary_every)
        return self._mfu_ledger

    def _device(self):
        return next(self.model.parameters()).device

    def _record_step(self, dt):
        """Per-step telemetry: the straggler detector, the productive
        bucket, the MFU ledger (wall time between step boundaries; the
        first recorded step only anchors the clock) and, every
        summary_every steps, the goodput gauges and a
        ``train.step_summary`` journal event."""
        host = self.host_id()
        wait, self._pending_data_wait = self._pending_data_wait, 0.0
        if self._straggler is not None:
            self._straggler.observe(host, dt, wait)
        self.goodput.record("productive", dt)
        if self._flops_per_step:
            now = time.perf_counter()
            if self._last_step_end is not None:
                self._mfu().observe(self._flops_per_step,
                                    now - self._last_step_end)
            self._last_step_end = now
        self._steps_seen += 1
        boundary = self._steps_seen % self._summary_every == 0
        if boundary:
            self.goodput.publish()
        if not obs.TRACER.enabled:
            return
        self._step_window.append(dt)
        self._wait_window.append(wait)
        if not boundary or not self._step_window:
            return
        times = sorted(self._step_window)
        waits = sorted(self._wait_window)
        obs.event(
            "train.step_summary", host=host, step=self._steps_seen,
            steps=len(times),
            step_time_p50_ms=round(times[len(times) // 2] * 1e3, 3),
            step_time_max_ms=round(times[-1] * 1e3, 3),
            data_wait_p50_ms=round(waits[len(waits) // 2] * 1e3, 3),
            data_wait_total_ms=round(sum(waits) * 1e3, 3))
        del self._step_window[:], self._wait_window[:]

    @torch.no_grad()
    def _update_ema(self, state):
        d = self._ema_decay
        shadow = list(state.ema.values())
        params = [state.model.get_parameter(n) for n in state.ema]
        torch._foreach_mul_(shadow, d)
        torch._foreach_add_(shadow, torch._foreach_mul(params, 1.0 - d))

    def eval_params(self, state):
        """{name: tensor}: the weights eval should read, the EMA shadow
        when it is tracked, the live parameters otherwise."""
        if self._ema_decay and state.ema is not None:
            return state.ema
        return dict(state.model.named_parameters())

    def ensure_ema(self, state):
        """Seed the EMA shadow from the parameters if it is missing."""
        if self._ema_decay and state.ema is None:
            state.ema = {n: p.detach().clone()
                         for n, p in state.model.named_parameters()
                         if p.requires_grad}
        return state

    def eval_step(self, state, images):
        """Logits of ``images`` in eval mode (BN on its running
        statistics, no dropout, no augmentation) with ``eval_params``,
        without gradients. The model's mode is restored afterwards. On
        a mesh ``images`` is the global batch: each data rank runs its
        slice and the logits are gathered."""
        model = state.model
        was_training = model.training
        model.eval()
        inputs = self._local(images)
        if self._context():
            inputs, model.seq_offset = self._spmd.local_sequence(inputs)
        try:
            with torch.no_grad():
                out = torch.func.functional_call(
                    model, self.eval_params(state), (inputs,))
        finally:
            model.train(was_training)
        if self._spmd is not None and (self._spmd.dp > 1
                                       or self._spmd.cp > 1):
            if isinstance(out, tuple):
                out = (self._spmd.gather_batch(out[0]),) + out[1:]
            else:
                out = self._spmd.gather_batch(out)
        return out

    def full_state(self, state):
        """A context in which ``state``'s parameters, momentum and EMA
        shadow are whole (every rank of the mesh enters it together):
        what a checkpoint saves and restores. Off a mesh it does
        nothing."""
        if self._spmd is None:
            return contextlib.nullcontext()
        return self._spmd.full_state(state.model, state.optimizer,
                                     state.ema)


class StateShardings:
    """The layout of a Trainer's state on this rank: ``local(name,
    whole)`` is this rank's piece of parameter ``name``'s whole tensor
    (or of its momentum trace or EMA shadow, which share its layout),
    the tensor itself for a leaf whole on the mesh or a Trainer off
    one. No collective: each rank cuts its own piece."""

    def __init__(self, spmd):
        self._spmd = spmd

    def local(self, name, whole):
        spmd = self._spmd
        layout = None if spmd is None else spmd.layouts.get(name)
        if layout is None or not layout.sharded:
            return whole
        return spmd._local(whole, layout)


def _meta_copy(module, keep=()):
    """A deep copy of ``module`` whose parameters and buffers are meta
    tensors (no storage is copied); objects in ``keep`` (a mesh a
    module is bound to) are shared, not copied."""
    memo = {id(obj): obj for obj in keep}
    for param in module.parameters():
        memo[id(param)] = torch.nn.Parameter(
            torch.empty_like(param, device="meta"),
            requires_grad=param.requires_grad)
    for buf in module.buffers():
        memo[id(buf)] = torch.empty_like(buf, device="meta")
    return copy.deepcopy(module, memo)


@contextlib.contextmanager
def _frozen_running_stats(model):
    """While remat recomputes a forward: the BN layers normalise as
    before but leave their running statistics as the first forward
    left them (jax.checkpoint returns the new statistics once)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True

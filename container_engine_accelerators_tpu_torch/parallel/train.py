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


"""Single-device trainer (counterpart of
container_engine_accelerators_tpu/parallel/train.py).

The JAX Trainer jit-compiles one SPMD step over a ("data", "model")
mesh. The port runs the same step eagerly on one device: forward,
loss, backward through the port's kernels, then the optimizer.
Parameters and optimizer state are updated in place (what the JAX
step's state donation does), so ``train_step`` hands back the state it
was given. The loss comes back as a device tensor: nothing in the step
reads the device from the host.

The optimizer is ``Sgd``, the counterpart of the demo driver's optax
chain: optional ``clip_by_global_norm``, then ``add_decayed_weights``
with a mask, then ``sgd`` with momentum and a learning-rate schedule
read at the update count before the update, as optax reads it.

remat, gradient accumulation, augmentation, EMA and the eval step
follow the JAX Trainer (``Trainer``'s docstring). Its options that
this port does not carry (a mesh, FSDP, straggler and MFU/goodput
telemetry, a step without state donation) raise "not yet ported".
"""

import contextlib
import dataclasses
import inspect
from typing import Any

import torch
import torch.utils.checkpoint

from ..models.layers import BatchNorm
from ..utils import not_ported, step_generator


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

    def update(self, optimizer, count):
        """Apply one update from the parameters' ``.grad``: clip, then
        the optimizer's step at the schedule's value for ``count``."""
        if self.grad_clip > 0:
            clip_by_global_norm(
                [p.grad for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None],
                self.grad_clip)
        lr = self.lr(count)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm):
    """optax.clip_by_global_norm in place: g is left as it is when the
    global L2 norm is below ``max_norm``, else becomes
    ``(g / norm) * max_norm``; no epsilon. Stays on the device."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
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
    """Owns one model's train and eval steps on one device.

    ``model(inputs) -> logits``, or ``model(inputs, step=...)`` for a
    model with step-keyed randomness (Inception's dropout; detected
    from the forward's signature, as the JAX Trainer detects a ``step``
    argument of its apply function); ``loss_fn(logits, labels) ->
    scalar``; ``optimizer``: an ``Sgd``.

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
    """

    def __init__(self, model, loss_fn, optimizer, mesh=None,
                 donate_state=True, remat=False, grad_accum=1,
                 augment_fn=None, ema_decay=0.0, fsdp=False,
                 straggler=None, mfu_source="off", goodput=None):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1: {grad_accum}")
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1): {ema_decay}")
        for option, value, default in (
                ("mesh", mesh, None), ("donate_state", donate_state, True),
                ("fsdp", fsdp, False), ("straggler", straggler, None),
                ("mfu_source", mfu_source, "off"),
                ("goodput", goodput, None)):
            if value != default:
                raise not_ported(f"Trainer({option}={value!r})")
        self.model = model
        self._loss = loss_fn
        self._tx = optimizer
        self._remat = bool(remat)
        self._grad_accum = int(grad_accum)
        self._augment = augment_fn
        self._ema_decay = float(ema_decay)
        self._wants_step = "step" in inspect.signature(
            model.forward).parameters

    def init_state(self):
        """A TrainState at step 0 with fresh momentum traces (and the
        EMA shadow when ``ema_decay`` is on)."""
        return self.ensure_ema(TrainState(
            step=0, model=self.model, optimizer=self._tx.init(self.model)))

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
        tensor."""
        images, labels = batch
        if self._augment is not None:
            images = self._augment(step_generator(
                AUGMENT_KEY, state.step, images.device), images)
        state.optimizer.zero_grad(set_to_none=True)
        accum = self._grad_accum
        if accum == 1:
            loss = self._loss(self._forward(images, state.step), labels)
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
                chunk_loss = self._loss(
                    self._forward(images_c, state.step * accum + idx),
                    labels_c)
                (chunk_loss / accum).backward()
                loss = loss + chunk_loss.detach().float() / accum
        self._tx.update(state.optimizer, state.step)
        if self._ema_decay:
            self._update_ema(state)
        state.step += 1
        return state, loss

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
        without gradients. The model's mode is restored afterwards."""
        model = state.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return torch.func.functional_call(
                    model, self.eval_params(state), (images,))
        finally:
            model.train(was_training)


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

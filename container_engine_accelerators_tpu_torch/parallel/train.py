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

Options of the JAX Trainer that this slice does not carry (a mesh,
remat, gradient accumulation, augmentation, EMA, FSDP, straggler and
MFU/goodput telemetry, the eval step) raise "not yet ported".
"""

import dataclasses
from typing import Any

import torch

from ..utils import not_ported


@dataclasses.dataclass
class TrainState:
    """What a step carries: ``step`` is the host count of updates
    applied; ``model`` holds the parameters and ``optimizer`` the
    momentum traces, both updated in place."""

    step: int
    model: Any
    optimizer: Any


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


class Trainer:
    """Owns one model's train step on one device.

    ``model(inputs) -> logits``; ``loss_fn(logits, labels) -> scalar``;
    ``optimizer``: an ``Sgd``."""

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
                ("remat", remat, False), ("grad_accum", grad_accum, 1),
                ("augment_fn", augment_fn, None),
                ("ema_decay", ema_decay, 0.0), ("fsdp", fsdp, False),
                ("straggler", straggler, None),
                ("mfu_source", mfu_source, "off"),
                ("goodput", goodput, None)):
            if value != default:
                raise not_ported(f"Trainer({option}={value!r})")
        self.model = model
        self._loss = loss_fn
        self._tx = optimizer

    def init_state(self):
        """A TrainState at step 0 with fresh momentum traces."""
        return TrainState(step=0, model=self.model,
                          optimizer=self._tx.init(self.model))

    def train_step(self, state, batch):
        """One step: (inputs, labels) -> (state, loss). ``state`` is
        updated in place and returned; the loss is a 0-d device
        tensor."""
        inputs, labels = batch
        state.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(state.model(inputs), labels)
        loss.backward()
        self._tx.update(state.optimizer, state.step)
        state.step += 1
        return state, loss.detach()

    @property
    def eval_step(self):
        raise not_ported("Trainer.eval_step")

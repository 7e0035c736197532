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

"""What the gloo ranks of ``torch_dist_pool.RankPool`` run for the
port's mesh, collective and sharded-trainer tests. Every function takes
the rank first, builds what it needs from numpy inputs and returns
numpy or plain values; nothing here imports JAX."""

import numpy as np
import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.models import convert, mlp
from container_engine_accelerators_tpu_torch.models.resnet import resnet
from container_engine_accelerators_tpu_torch.models.transformer import (
    next_token_loss_fn,
)
from container_engine_accelerators_tpu_torch.obs.straggler import (
    StragglerDetector,
)
from container_engine_accelerators_tpu_torch.parallel import (
    Sgd,
    Trainer,
    cross_entropy_loss,
    distributed,
)
from container_engine_accelerators_tpu_torch.parallel import collectives
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    MeshSpec,
    axis_group,
    build_mesh,
    host_grid_mesh,
    mesh_shape,
)


# -- meshes ---------------------------------------------------------------


def mesh_facts(rank, data=None, model=1):
    """(shape dict, coordinate, data-axis peers, model-axis peers) of
    this rank in build_mesh(MeshSpec(data, model)) (default spec when
    ``data`` is None)."""
    spec = None if data is None else MeshSpec(data=data, model=model)
    mesh = build_mesh(spec)
    coord = mesh.get_coordinate()
    if coord is None:
        return mesh_shape(mesh), None, None, None
    return (mesh_shape(mesh), tuple(coord),
            dist.get_process_group_ranks(axis_group(mesh, DATA_AXIS)),
            dist.get_process_group_ranks(axis_group(mesh, MODEL_AXIS)))


def mesh_error(rank, data, model):
    """The exception type name build_mesh raises for the spec."""
    try:
        build_mesh(MeshSpec(data=data, model=model))
    except ValueError as e:
        return type(e).__name__
    return None


def host_grid(rank, bounds):
    mesh = host_grid_mesh(bounds)
    return mesh_shape(mesh), tuple(mesh.get_coordinate())


def world_size(rank):
    return dist.get_world_size(), dist.get_backend()


def barrier_all(rank, name):
    return distributed.barrier(name, timeout_ms=20000)


def barrier_missing_peer(rank, name):
    """Rank 0 alone waits: DeadlineExceeded after the short deadline."""
    if rank != 0:
        return None
    try:
        distributed.barrier(name, timeout_ms=300)
    except distributed.DeadlineExceeded as e:
        return str(e)
    return None


# -- collectives ------------------------------------------------------------


def collective(rank, kind, x, data=None):
    """Run one collective of parallel/collectives.py on this rank's
    shard of ``x`` (its leading-dim slice; the whole of ``x`` for
    reduce_scatter) on a data mesh of ``data`` ranks (the world by
    default). Ranks outside the mesh return None."""
    world = dist.get_world_size()
    data = data or world
    mesh = build_mesh(MeshSpec(data=data), devices=list(range(world)))
    if mesh.get_coordinate() is None:
        return None
    t = torch.from_numpy(np.asarray(x))
    if kind == "reduce_scatter":
        shard = t
    else:
        shard = t.chunk(data)[rank]
    fn = getattr(collectives, kind)
    return fn(mesh, shard).numpy()


# -- trainers ---------------------------------------------------------------


def _mlp(tree, hidden):
    model = mlp.MnistMLP(hidden=hidden, dtype=torch.float32, device="meta")
    return convert.load_image_model(model.to_empty(device="cpu"), tree)


def _resnet(tree, width, classes=8):
    model = resnet(18, classes, dtype=torch.float32, width=width,
                   device="meta")
    return convert.load_image_model(model.to_empty(device="cpu"), tree)


def init_tree(kind, seed=0, **size):
    """The flax-layout variables of the port's model (numpy, made from
    ``seed``): the one init every rank and the JAX side load."""
    if kind == "mlp":
        model = mlp.MnistMLP(hidden=size["hidden"], dtype=torch.float32,
                             device="meta")
    else:
        model = resnet(18, size.get("classes", 8), dtype=torch.float32,
                       width=size["width"], device="meta")
    return convert.init_flax_layout_image(model, seed)


def _model(kind, tree, size):
    if kind == "mlp":
        return _mlp(tree, size["hidden"])
    return _resnet(tree, size["width"], size.get("classes", 8))


def train(rank, kind, tree, batches, size, data=None, model=1, fsdp=False,
          lr=0.1, momentum=0.9, grad_accum=1, ema_decay=0.0, remat=False,
          eval_images=None, telemetry=False, grad_clip=0.0,
          mfu_source="analytic"):
    """Train the port's ``kind`` model from ``tree`` on ``batches``
    (global numpy (images, labels) pairs) as one rank of a
    (data, model) mesh (``data`` None: no mesh, one process). Returns
    the losses, the whole variables in the flax layout after the last
    step, this rank's layout facts, the eval logits of
    ``eval_images`` and, with ``telemetry``, the step telemetry (the
    straggler detector's hosts, the goodput buckets, the FLOPs a step
    from ``mfu_source``, the MFU ledger's chips and the Trainer's host
    id). ``grad_clip``: the optimizer's global-norm clip (0: none)."""
    torch.manual_seed(0)
    net = _model(kind, tree, size).train()
    mesh = (None if data is None
            else build_mesh(MeshSpec(data=data, model=model)))
    detector = StragglerDetector(window=4, min_samples=2) if telemetry \
        else None
    trainer = Trainer(net, cross_entropy_loss,
                      Sgd(lr, momentum=momentum, grad_clip=grad_clip),
                      mesh=mesh, fsdp=fsdp, grad_accum=grad_accum,
                      ema_decay=ema_decay, remat=remat, straggler=detector,
                      mfu_source=mfu_source if telemetry else "off")
    state = trainer.init_state()
    losses = []
    for images, labels in batches:
        state, loss = trainer.train_step(
            state, (torch.from_numpy(np.asarray(images)),
                    torch.from_numpy(np.asarray(labels).astype(np.int64))))
        losses.append(float(loss))
    facts = {}
    for name, param in state.model.named_parameters():
        buf = state.optimizer.state.get(param, {}).get("momentum_buffer")
        facts[name] = (tuple(param.shape),
                       None if buf is None else tuple(buf.shape))
    layouts = ({} if trainer._spmd is None else
               {n: (lay.spec, lay.data_dim, lay.model_dim)
                for n, lay in trainer._spmd.layouts.items()})
    logits = None
    if eval_images is not None:
        logits = trainer.eval_step(
            state, torch.from_numpy(np.asarray(eval_images))).numpy()
    with trainer.full_state(state):
        variables = convert.image_variables_to_flax(state.model)
        ema = (None if state.ema is None else
               convert.named_params_to_flax(state.model, state.ema))
    out = {"losses": losses, "variables": _numpy(variables),
           "ema": None if ema is None else _numpy(ema),
           "facts": facts, "layouts": layouts, "eval_logits": logits}
    if telemetry:
        books = trainer.goodput.publish()
        out["telemetry"] = {
            "hosts": sorted(detector._steps),
            "buckets": books["buckets"],
            "flops_per_step": trainer.flops_per_step(),
            "chips": trainer._mfu().chips,
            "host_id": trainer.host_id()}
    return out


def train_lm(rank, config, tree, batches, data=None, model=1, fsdp=False):
    """Train the port's TransformerLM of ``config`` (f32 compute) from
    the flax tree ``tree`` on global token batches, as one rank of a
    (data, model) mesh (``data`` None: one process). Returns the losses,
    the whole parameters by name and the layouts."""
    torch.manual_seed(0)
    net = convert.load_lm(config, tree, device="cpu", dtype=torch.float32,
                          trainable=True)
    mesh = (None if data is None
            else build_mesh(MeshSpec(data=data, model=model)))
    trainer = Trainer(net, next_token_loss_fn(cross_entropy_loss),
                      Sgd(0.1, momentum=0.9), mesh=mesh, fsdp=fsdp,
                      mfu_source="off")
    state = trainer.init_state()
    losses = []
    for tokens in batches:
        tokens = torch.from_numpy(np.asarray(tokens).astype(np.int64))
        state, loss = trainer.train_step(state, (tokens, tokens))
        losses.append(float(loss))
    layouts = ({} if trainer._spmd is None else
               {n: (lay.spec, lay.data_dim, lay.model_dim)
                for n, lay in trainer._spmd.layouts.items()})
    with trainer.full_state(state):
        params = {n: p.detach().numpy().copy()
                  for n, p in state.model.named_parameters()}
    return {"losses": losses, "params": params, "layouts": layouts}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


# -- the rendezvous deadline -----------------------------------------------


def late_collective(rank, port, conn):
    """Worker ``rank`` of a two-host slice started through the plugin's
    env contract with a 1 s rendezvous deadline; rank 1 then comes to
    an all-reduce 2.5 s late. Sends the sum (or the error) to ``conn``."""
    import os
    import time

    os.environ.update(TPU_WORKER_HOSTNAMES="127.0.0.1,127.0.0.1",
                      TPU_WORKER_ID=str(rank), CEA_COORDINATOR_PORT=port,
                      CEA_TPU_COORD_TIMEOUT_MS="1000")
    os.environ.pop("CEA_COORDINATOR_ADDRESS", None)
    try:
        assert distributed.initialize_from_plugin_env(device="cpu")
        if rank == 1:
            time.sleep(2.5)
        t = torch.full((2,), float(rank + 1))
        dist.all_reduce(t)
        conn.send(("ok", t.tolist()))
    except Exception as e:
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        distributed.shutdown()

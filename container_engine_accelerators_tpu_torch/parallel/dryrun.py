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

"""The multichip dryrun: one full training step of every parallel form
over an ``n_devices``-rank world (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

    python -m container_engine_accelerators_tpu_torch.parallel.dryrun
    python -m container_engine_accelerators_tpu_torch.parallel.dryrun \\
        --device cpu --n-devices 4

Each stage is a function that runs on every rank of an initialized
process group of ``n_devices`` ranks (one rank a device), takes
optional weights and inputs as numpy (the JAX init, converted: a
check hands both packages the same ones; default: the port's own
seeded init) and returns the step's loss, its step count, the mesh and
the updated parameters as numpy in the JAX layout:

1. ``stage_dp_tp``: ResNet-50 (width 16, 16 classes, f32, 32 x 32) on
   a ("data", "model") mesh with model = 2 when n is even, SGD 0.1 with
   momentum 0.9 on a batch of 2n; ``fsdp=True`` is stage 1b, the same
   model on an (n, 1) mesh with its big kernels stored as data shards.
2. ``stage_dp_sp_ep``: the MoE LM (vocab 32, E 32, 2 layers, 4 heads,
   4 experts, S 16, f32) over one ("data", "context", "expert") mesh
   of (n/4, 2, 2): ring attention over "context", the routed layers'
   experts over "expert", the next-token loss plus the router's aux,
   Adam 1e-3 on a batch of 4 · n/4.
3. ``stage_pp``: the GPipe toy (dim 8, a tanh stage, 2 microbatches,
   plain SGD 0.1 on the stacked stages) over a ("data", "pipe") mesh,
   then the circular schedule on ``PipelinedLM`` (vocab 32, E 16, two
   blocks a pipe rank, 4 heads, S 16, batch 4 · data, sequence 12,
   plain SGD 0.01).
4. ``stage_host_grid``: ``host_grid_mesh((2, 2, 1))`` with the batch
   over the host axes and "chip": one least-squares gradient step.

``dryrun_multichip`` runs them under the JAX dryrun's gates (1b when n
> 1 and n divides 512, 2 and 4 when 4 divides n, 3 when n >= 2) and
returns a summary. The JAX dryrun also reads the SPMD partitioner's
stderr for replicate-then-reshard fallbacks (``check_no_resharding``);
the port's collectives are written out, so nothing is left to read.

The entry point runs on the card: its world comes from
``distributed.start_world`` (``torchrun``'s environment or the
plugin's env contract; one host alone starts a one-rank group), one
rank a card under NCCL.
``--device cpu`` spawns ``--n-devices`` gloo ranks on the CPU instead,
and only when asked.
"""

import argparse
import datetime
import functools
import json
import multiprocessing
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import convert
from ..models.moe import with_router_loss
from ..models.resnet import resnet
from ..models.transformer import next_token_loss_fn
from . import distributed
from .collectives import _gather_dim
from .context import CONTEXT_AXIS, ring_attention
from .data import SyntheticLoader, SyntheticTokenLoader
from .expert import EXPERT_AXIS
from .mesh import (
    DATA_AXIS,
    HOST_AXES,
    MeshSpec,
    axis_group,
    axis_index,
    axis_size,
    build_mesh,
    host_grid_mesh,
    mesh_shape,
    named_mesh,
)
from .pipeline import (
    PIPELINE_AXIS,
    build_pipeline_mesh,
    pipeline_apply,
    stage_sharding,
)
from .pipeline_lm import (
    PipelinedLM,
    _flax_tree,
    local_batch,
    mean_over_data,
    reduce_grads,
)
from .train import Adam, Sgd, Trainer, cross_entropy_loss

STAGES = ("dp_tp", "fsdp", "dp_sp_ep", "pp", "host_grid")

# Stage 1: the flagship's topology at a tiny width and resolution; at
# width 16 the widest kernels have 512 channels, so the model axis
# (and FSDP's data axis) shards them.
RESNET = dict(depth=50, num_classes=16, width=16)
IMAGE_SHAPE = (32, 32, 3)
# Stage 2.
MOE_LM = dict(vocab_size=32, embed_dim=32, num_layers=2, num_heads=4,
              num_experts=4, max_seq_len=16)
MOE_SEQ = 16
# Stage 3.
TOY_DIM = 8
PIPE_LM = dict(vocab_size=32, embed_dim=16, num_heads=4, max_seq_len=16)
PIPE_SEQ = 12
MICROBATCHES = 2
# Stage 4.
GRID_BOUNDS = (2, 2, 1)
GRID_DIM = 8


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _tensor(value, device, dtype=None):
    return torch.as_tensor(np.asarray(value), dtype=dtype, device=device)


def _world(n_devices):
    """Check that the world is ``n_devices`` ranks, one a device."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the dryrun runs on every rank of an "
                           "initialized process group")
    if dist.get_world_size() != n_devices:
        raise ValueError(f"need {n_devices} devices, have a world of "
                         f"{dist.get_world_size()} ranks")


def _trained(loss, step, mesh, **params):
    return dict(loss=float(loss), step=int(step), mesh=mesh_shape(mesh),
                **params)


def stage_dp_tp(n_devices, device, variables=None, batch=None, fsdp=False):
    """Stage 1 (and 1b with ``fsdp``): one step of ResNet-50 on the
    stage's mesh. ``variables``: flax-layout {"params", "batch_stats"}
    (default: ``convert.init_flax_layout_image`` from seed 0);
    ``batch``: global numpy (images NHWC, labels) (default: the
    synthetic loader's first batch of 2n). Returns the loss, the step,
    the mesh and ``variables`` after the step."""
    if fsdp:
        spec = MeshSpec(data=n_devices, model=1)
    else:
        model_par = 2 if n_devices % 2 == 0 else 1
        spec = MeshSpec(data=n_devices // model_par, model=model_par)
    mesh = build_mesh(spec)
    model = resnet(**RESNET, dtype=torch.float32, device="meta")
    if variables is None:
        variables = convert.init_flax_layout_image(model, 0)
    model = convert.load_image_model(model.to_empty(device=device),
                                     variables).train()
    whole = {n: tuple(p.shape) for n, p in model.named_parameters()}
    trainer = Trainer(model, cross_entropy_loss, Sgd(0.1, momentum=0.9),
                      mesh=mesh, fsdp=fsdp, mfu_source="off")
    if fsdp and all(tuple(p.shape) == whole[n]
                    for n, p in model.named_parameters()):
        raise AssertionError("FSDP dryrun sharded nothing")
    state = trainer.init_state()
    if batch is None:
        batch = next(SyntheticLoader(2 * n_devices, IMAGE_SHAPE,
                                     RESNET["num_classes"], device=device,
                                     pool=1))
    else:
        batch = (_tensor(batch[0], device, torch.float32),
                 _tensor(batch[1], device))
    state, loss = trainer.train_step(state, batch)
    if state.step != 1:
        raise AssertionError(f"step {state.step} after one step")
    with trainer.full_state(state):
        out = _numpy(convert.image_variables_to_flax(state.model))
    return _trained(loss, state.step, mesh, params=out)


def combined_mesh(data, context, expert):
    """The dryrun's ("data", "context", "expert") mesh over the world's
    ranks, row-major (the JAX dryrun's ``Mesh(np.array(devices)
    .reshape(d, c, e), ...)``)."""
    return named_mesh((data, context, expert),
                      (DATA_AXIS, CONTEXT_AXIS, EXPERT_AXIS))


def bind_combined(model, mesh):
    """``model`` (a MoETransformerLM) on the combined ``mesh``: every
    block attends through ring attention over "context" with the batch
    over "data", and the routed layers are bound to "expert". Returns
    the model."""
    attn = functools.partial(ring_attention, mesh, axis_name=CONTEXT_AXIS,
                             batch_axis=DATA_AXIS)
    for block in model.blocks:
        block.attn.attention_fn = attn
    return model.bind_mesh(mesh)


def stage_dp_sp_ep(n_devices, device, params=None, batch=None,
                   shape=None):
    """Stage 2: one Adam step of the MoE LM bound to the (n/4, 2, 2)
    ("data", "context", "expert") mesh (``shape`` another (d, c, e)).
    ``params``: the flax MoETransformerLM tree (default:
    ``convert.init_flax_layout_params`` from seed 1); ``batch``: global
    numpy tokens [4 · d, 16] (default: the synthetic loader's first).
    Returns the loss, the step, the mesh, ``params`` after the step and
    the expert rows of the first routed layer's ``w_in`` this rank
    holds."""
    d, c, e = shape or (n_devices // 4, 2, 2)
    mesh = combined_mesh(d, c, e)
    tree = (params if params is not None
            else convert.init_flax_layout_params(MOE_LM, 1))
    model = bind_combined(convert.load_lm(
        MOE_LM, tree, device=device, dtype=torch.float32,
        trainable=True), mesh)
    trainer = Trainer(model, with_router_loss(
        next_token_loss_fn(cross_entropy_loss)), Adam(1e-3), mesh=mesh,
        mfu_source="off")
    experts = model.blocks[1].moe.w_in.shape[0]
    if experts != MOE_LM["num_experts"] // e:
        raise AssertionError(f"block 1 holds {experts} experts on an "
                             f"expert axis of {e}")
    state = trainer.init_state()
    if batch is None:
        batch = next(SyntheticTokenLoader(4 * d, MOE_SEQ,
                                          MOE_LM["vocab_size"],
                                          device=device, pool=1))
    else:
        tokens = _tensor(batch, device)
        batch = (tokens, tokens)
    state, loss = trainer.train_step(state, batch)
    if state.step != 1:
        raise AssertionError(f"step {state.step} after one step")
    with trainer.full_state(state):
        out = _numpy(convert.params_to_flax(state.model, MOE_LM))
    return _trained(loss, state.step, mesh, params=out,
                    local_experts=experts)


def _toy_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sgd(params, lr):
    with torch.no_grad():
        for p in params:
            p -= lr * p.grad


def stage_pp(n_devices, device, toy=None, x=None, y=None, lm_params=None,
             tokens=None):
    """Stage 3: over ``build_pipeline_mesh(n/d, data=d)`` (d = 2 when 4
    divides n, else 1), one step of the GPipe toy and one of the
    circular ``PipelinedLM``. ``toy``: {"w" [P, 8, 8], "b" [P, 8]}
    stacked stages; ``x``/``y``: global [4d, 8]; ``lm_params``: the JAX
    PipelinedLM tree (placement order; default ``PipelinedLM.init(7)``);
    ``tokens``: global [4d, 12]. Defaults are seeded numpy. Returns the
    toy's loss and whole stacked params, the LM's (``lm_loss``,
    ``lm_params``), the step and the mesh."""
    d = 2 if n_devices % 4 == 0 else 1
    stages = n_devices // d
    mesh = build_pipeline_mesh(stages, data=d)
    pipe = axis_index(mesh, PIPELINE_AXIS)
    pipe_group = (axis_group(mesh, PIPELINE_AXIS)
                  if axis_size(mesh, PIPELINE_AXIS) > 1 else None)

    def rows(value):
        r = stage_sharding(mesh, stages)[pipe]
        return np.asarray(value)[r.start:r.stop]

    def whole(t):
        t = t.detach()
        return _gather_dim(t, 0, pipe_group) if pipe_group else t

    if toy is None:
        rng = np.random.default_rng(2)
        toy = {"w": (rng.standard_normal((stages, TOY_DIM, TOY_DIM))
                     * 0.5).astype(np.float32),
               "b": np.zeros((stages, TOY_DIM), np.float32)}
    if x is None:
        x = np.random.default_rng(3).standard_normal(
            (4 * d, TOY_DIM)).astype(np.float32)
    if y is None:
        y = np.random.default_rng(4).standard_normal(
            (4 * d, TOY_DIM)).astype(np.float32)
    local = torch.nn.ParameterDict({
        k: torch.nn.Parameter(_tensor(rows(v), device, torch.float32))
        for k, v in toy.items()})
    out = pipeline_apply(mesh, _toy_stage, dict(local),
                         local_batch(mesh, _tensor(x, device)),
                         num_microbatches=MICROBATCHES)
    loss = torch.mean((out - local_batch(mesh, _tensor(y, device))) ** 2)
    loss.backward()
    reduce_grads(local, mesh)
    _sgd(local.parameters(), 0.1)
    toy_out = {k: whole(v).cpu().numpy() for k, v in local.items()}

    plm = PipelinedLM(**PIPE_LM, num_layers=2 * stages, pipe=stages,
                      dtype=torch.float32, stage=pipe, device=device)
    plm.load(lm_params if lm_params is not None else plm.init(7))
    if tokens is None:
        tokens = np.random.default_rng(8).integers(
            0, PIPE_LM["vocab_size"], (4 * d, PIPE_SEQ))
    tok = local_batch(mesh, _tensor(tokens, device, torch.long))
    logits = plm.apply(tok, mesh=mesh, num_microbatches=MICROBATCHES)
    logp = F.log_softmax(logits[:, :-1], dim=-1)
    lm_loss = -torch.mean(logp.gather(-1, tok[:, 1:, None]))
    lm_loss.backward()
    reduce_grads(plm, mesh)
    _sgd(plm.parameters(), 0.01)
    lm_out = _numpy(_flax_tree(plm, dict(plm.named_parameters()), mesh,
                               whole=True))
    return _trained(mean_over_data(loss, mesh), 1, mesh, params=toy_out,
                    lm_loss=float(mean_over_data(lm_loss, mesh)),
                    lm_params=lm_out)


def stage_host_grid(n_devices, device, x=None, y=None):
    """Stage 4: one gradient step of mean((x w - y)^2) from w = 0 on
    ``host_grid_mesh((2, 2, 1))``, the global batch [2n, 8] split over
    the host axes and "chip" jointly (row-major), w replicated: a
    rank's share of the loss and gradient summed over each axis.
    ``x``/``y``: global numpy (default seeded). Returns the loss, the
    step, the mesh and the new w."""
    mesh = host_grid_mesh(GRID_BOUNDS)
    n = 2 * n_devices
    if x is None:
        x = np.random.default_rng(5).standard_normal(
            (n, GRID_DIM)).astype(np.float32)
    if y is None:
        y = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    shape = tuple(mesh.mesh.shape)
    flat = int(np.ravel_multi_index(tuple(mesh.get_coordinate()), shape))
    per = n // n_devices
    xs = _tensor(x, device)[flat * per:(flat + 1) * per]
    ys = _tensor(y, device)[flat * per:(flat + 1) * per]
    w = torch.zeros(GRID_DIM, device=device, requires_grad=True)
    share = torch.sum((xs @ w - ys) ** 2) / n
    share.backward()
    loss, grad = share.detach().clone(), w.grad
    for axis in HOST_AXES + ("chip",):
        if axis_size(mesh, axis) > 1:
            group = axis_group(mesh, axis)
            dist.all_reduce(loss, group=group)
            dist.all_reduce(grad, group=group)
    new_w = (w.detach() - 0.1 * grad).cpu().numpy()
    return _trained(loss, 1, mesh, params=new_w)


def gates(n_devices):
    """{stage: None (runs) or why it is skipped}: the JAX dryrun's."""
    return {
        "dp_tp": None,
        "fsdp": (None if n_devices > 1 and 512 % n_devices == 0 else
                 "needs n > 1 dividing 512 (the widest kernel)"),
        "dp_sp_ep": (None if n_devices % 4 == 0 else
                     "needs n divisible by 4 ((n/4, 2, 2) mesh)"),
        "pp": None if n_devices >= 2 else "needs n >= 2 (two stages)",
        "host_grid": (None if n_devices % 4 == 0 else
                      "needs n divisible by 4 (2 x 2 x 1 hosts)"),
    }


def dryrun_multichip(n_devices, device=None):
    """One training step of each parallel form the port ships over the
    ``n_devices`` ranks of the initialized world (one rank a device),
    each stage under the JAX dryrun's gate. ``device``: this rank's
    device (default "cuda"). Returns {"n_devices", "device", "stages":
    {stage: {"ran", "loss", "step", "mesh"} or {"ran": False,
    "skipped"}}} (stage 3 adds ``lm_loss``); the same on every rank."""
    device = device or "cuda"
    _world(n_devices)
    fns = {"dp_tp": stage_dp_tp,
           "fsdp": functools.partial(stage_dp_tp, fsdp=True),
           "dp_sp_ep": stage_dp_sp_ep, "pp": stage_pp,
           "host_grid": stage_host_grid}
    stages = {}
    for name, reason in gates(n_devices).items():
        if reason is not None:
            stages[name] = dict(ran=False, skipped=reason)
            continue
        out = fns[name](n_devices, device)
        stages[name] = dict(ran=True, **{k: v for k, v in out.items()
                                         if not k.endswith("params")})
    return dict(n_devices=n_devices, device=str(device), stages=stages)


# -- the entry point ---------------------------------------------------


def _cpu_rank(rank, world, port, queue):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    distributed.start_process_group(
        backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
        world_size=world, rank=rank, timeout=datetime.timedelta(minutes=5),
        device="cpu")
    try:
        summary = dryrun_multichip(world, device="cpu")
        if rank == 0:
            queue.put(("ok", summary))
    except BaseException as e:
        queue.put(("error", f"rank {rank}: {type(e).__name__}: {e}"))
        raise
    finally:
        dist.destroy_process_group()


def run_cpu(n_devices):
    """``dryrun_multichip`` on ``n_devices`` spawned gloo ranks on the
    CPU; rank 0's summary. Raises if a rank fails."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = distributed.free_local_port()
    procs = [ctx.Process(target=_cpu_rank, args=(r, n_devices, port, queue))
             for r in range(n_devices)]
    for proc in procs:
        proc.start()
    try:
        status, value = queue.get(timeout=1800)
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if status != "ok":
        raise RuntimeError(value)
    return value


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda: one rank a card, from torchrun or the "
                        "plugin env contract; cpu: spawn --n-devices "
                        "gloo ranks")
    p.add_argument("--n-devices", type=int, default=None,
                   help="ranks (cpu: default 4; cuda: the world's size)")
    args = p.parse_args(argv)
    if args.device == "cpu":
        summary = run_cpu(args.n_devices or 4)
        print(json.dumps(summary))
        return 0
    device = distributed.start_world("cuda")
    try:
        n = args.n_devices or dist.get_world_size()
        summary = dryrun_multichip(n, device=device)
        if dist.get_rank() == 0:
            print(json.dumps(summary))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

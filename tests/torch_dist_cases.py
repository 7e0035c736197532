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


# -- context parallelism ---------------------------------------------------


def _ctx_coords(mesh):
    from container_engine_accelerators_tpu_torch.parallel.context import (
        CONTEXT_AXIS,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        axis_index,
    )
    return axis_index(mesh, DATA_AXIS), axis_index(mesh, CONTEXT_AXIS)


def ctx_attention(rank, kind, q, k, v, ctx_size, data=1, causal=False,
                  use_flash=None, kv_block=None, grads=False):
    """This rank's shard of ``kind`` ("ring" or "ulysses") attention on a
    (data, context) mesh over the global numpy q/k/v [B, S, H, D]: its
    rows over data and its S/P slice over context. With ``grads`` also
    the gradients of its q/k/v shards under the loss sum(out ** 2)
    summed over the ranks (each rank's own output's part)."""
    from container_engine_accelerators_tpu_torch.parallel import context

    mesh = context.build_context_mesh(context=ctx_size, data=data)
    di, ci = _ctx_coords(mesh)
    b, s = q.shape[0] // data, q.shape[1] // ctx_size

    def take(x):
        return torch.from_numpy(np.ascontiguousarray(
            x[di * b:(di + 1) * b, ci * s:(ci + 1) * s])).requires_grad_(
                grads)

    ql, kl, vl = take(q), take(k), take(v)
    saved = context._KV_BLOCK
    if kv_block:
        context._KV_BLOCK = kv_block
    try:
        fn = (context.ring_attention if kind == "ring"
              else context.ulysses_attention)
        out = fn(mesh, ql, kl, vl, causal=causal, use_flash=use_flash)
        res = {"out": out.detach().numpy(), "coord": (di, ci)}
        if grads:
            (out ** 2).sum().backward()
            res["grads"] = [t.grad.numpy() for t in (ql, kl, vl)]
    finally:
        context._KV_BLOCK = saved
    return res


def ctx_error(rank, context, shape):
    """The error ulysses_attention raises for zeros of ``shape`` on a
    context mesh of ``context`` ranks (type name, message)."""
    from container_engine_accelerators_tpu_torch.parallel import context as c

    mesh = c.build_context_mesh(context=context)
    s = shape[1] // context
    x = torch.zeros((shape[0], s) + tuple(shape[2:]))
    try:
        c.ulysses_attention(mesh, x, x, x)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


def ctx_mesh_facts(rank, context, data=None):
    """(shape, coordinate) of build_context_mesh, or the error's type
    name and message."""
    from container_engine_accelerators_tpu_torch.parallel import context as c

    try:
        mesh = c.build_context_mesh(context=context, data=data)
    except ValueError as e:
        return type(e).__name__, str(e)
    return mesh_shape(mesh), tuple(mesh.get_coordinate())


def train_lm_context(rank, config, tree, batches, context, data=1,
                     attention="ring", use_flash=None, grad_clip=0.0):
    """Train the port's TransformerLM (MoETransformerLM for a config with
    ``num_experts``, on the loss plus the router's) of ``config`` (f32)
    from the flax tree on global token batches as one rank of a (data,
    context) mesh with the ``attention`` schedule bound to it, as the
    driver binds it. Returns the losses, the whole parameters and the
    sequence lengths the first block saw."""
    import functools

    from container_engine_accelerators_tpu_torch.parallel import context as c

    torch.manual_seed(0)
    net = convert.load_lm(config, tree, device="cpu", dtype=torch.float32,
                          trainable=True)
    mesh = c.build_context_mesh(context=context, data=data)
    schedule = (c.ulysses_attention if attention == "ulysses"
                else c.ring_attention)
    fn = functools.partial(schedule, mesh, axis_name=c.CONTEXT_AXIS,
                           batch_axis=DATA_AXIS, use_flash=use_flash)
    for block in net.blocks:
        block.attn.attention_fn = fn
    seen = []
    net.blocks[0].register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
    loss_fn = next_token_loss_fn(cross_entropy_loss)
    if config.get("num_experts"):
        from container_engine_accelerators_tpu_torch.models.moe import (
            with_router_loss,
        )
        loss_fn = with_router_loss(loss_fn)
    trainer = Trainer(net, loss_fn,
                      Sgd(0.1, momentum=0.9, grad_clip=grad_clip),
                      mesh=mesh, mfu_source="off")
    state = trainer.init_state()
    losses = []
    for tokens in batches:
        tokens = torch.from_numpy(np.asarray(tokens).astype(np.int64))
        state, loss = trainer.train_step(state, (tokens, tokens))
        losses.append(float(loss))
    logits = trainer.eval_step(state, torch.from_numpy(
        np.asarray(batches[0]).astype(np.int64)))
    if isinstance(logits, tuple):
        logits = logits[0]
    with trainer.full_state(state):
        params = {n: p.detach().numpy().copy()
                  for n, p in state.model.named_parameters()}
    return {"losses": losses, "params": params, "seen": seen,
            "eval_logits": logits.numpy()}


# -- expert parallelism ----------------------------------------------------


def _expert_slice(w, mesh):
    from container_engine_accelerators_tpu_torch.parallel.expert import (
        EXPERT_AXIS,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        axis_index,
        axis_size,
    )
    n = w.shape[0] // axis_size(mesh, EXPERT_AXIS)
    g = axis_index(mesh, EXPERT_AXIS)
    return np.ascontiguousarray(w[g * n:(g + 1) * n])


def ep_moe(rank, tokens, gate, w_in, w_out, expert, data=None,
           residual=False, grads=False, whole=False, **kwargs):
    """expert_parallel_moe on a (data, expert) mesh from global numpy
    tensors: with ``residual`` the tokens are the data rank's block
    (token spec ("data",) or ()), else this rank's own group (the
    joint sharding over every axis); the rank passes its E/P experts
    (``whole``: the whole stacks).
    Returns its output, aux and, with ``grads``, the gradients of its
    w_in slice and of the gate under the global loss mean(out ** 2) +
    0.01 aux (each rank's share of it)."""
    from container_engine_accelerators_tpu_torch.parallel import expert as x

    mesh = x.build_expert_mesh(expert=expert, data=data)
    world = dist.get_world_size()
    dp = world // expert
    if residual:
        n = tokens.shape[0] // dp
        di = mesh.get_coordinate()[0]
        toks = tokens[di * n:(di + 1) * n]
        spec = (DATA_AXIS,) if dp > 1 else ()
    else:
        n = tokens.shape[0] // world
        toks = tokens[rank * n:(rank + 1) * n]
        spec = None
    if whole:
        wi, wo = torch.from_numpy(w_in), torch.from_numpy(w_out)
    else:
        wi = torch.from_numpy(_expert_slice(w_in, mesh))
        wo = torch.from_numpy(_expert_slice(w_out, mesh))
    wi.requires_grad_(grads)
    g = torch.from_numpy(gate).requires_grad_(grads)
    out, aux = x.expert_parallel_moe(mesh, torch.from_numpy(toks), g, wi,
                                     wo, token_spec=spec, **kwargs)
    res = {"out": out.detach().numpy(), "aux": float(aux)}
    if grads:
        total = tokens.size
        if residual:
            # The expert peers compute one replicated loss; the data
            # ranks' are separate terms.
            share = (out ** 2).sum() / total + 0.01 * aux / dp
        else:
            share = (out ** 2).sum() / total + 0.01 * aux / world
        share.backward()
        res["w_in_grad"] = wi.grad.numpy()
        res["gate_grad"] = g.grad.numpy()
    return res


def moe_mlp_mesh(rank, x, params, expert, **options):
    """A MoEMlp bound to an expert mesh (whole weights, each rank
    taking its experts at use) on the global [B, S, d] input ``x``
    (every rank the same); returns its output."""
    from container_engine_accelerators_tpu_torch.models.moe import MoEMlp
    from container_engine_accelerators_tpu_torch.parallel import expert as e

    mesh = e.build_expert_mesh(expert=expert)
    layer = MoEMlp(x.shape[-1], params["w_in"].shape[0],
                   dtype=torch.float32, mesh=mesh, **options)
    with torch.no_grad():
        for name, value in params.items():
            getattr(layer, name).copy_(torch.from_numpy(value))
        out, _ = layer(torch.from_numpy(x))
    return out.numpy()


def train_moe(rank, config, tree, batches, expert=1, data=None, model=1):
    """Train the port's MoETransformerLM of ``config`` (f32) on global
    token batches: bound to a (data, expert) mesh with ``expert`` > 1,
    else on a (data, model) mesh. Returns the losses, the whole
    parameters and the layouts' expert dims."""
    from container_engine_accelerators_tpu_torch.models.moe import (
        with_router_loss,
    )
    from container_engine_accelerators_tpu_torch.parallel import expert as e

    torch.manual_seed(0)
    net = convert.load_lm(config, tree, device="cpu", dtype=torch.float32,
                          trainable=True)
    if expert > 1:
        mesh = e.build_expert_mesh(expert=expert, data=data)
        net.bind_mesh(mesh)
    else:
        mesh = build_mesh(MeshSpec(data=data, model=model))
    trainer = Trainer(net, with_router_loss(
        next_token_loss_fn(cross_entropy_loss)), Sgd(0.1, momentum=0.9),
        mesh=mesh, mfu_source="off")
    state = trainer.init_state()
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()
              if n.endswith("moe.w_in")}
    losses = []
    for tokens in batches:
        tokens = torch.from_numpy(np.asarray(tokens).astype(np.int64))
        state, loss = trainer.train_step(state, (tokens, tokens))
        losses.append(float(loss))
    with trainer.full_state(state):
        params = {n: p.detach().numpy().copy()
                  for n, p in state.model.named_parameters()}
    return {"losses": losses, "params": params, "local_shapes": shapes}


# -- tensor-parallel serving -----------------------------------------------


def serve_tp(rank, config, tree, prompts, new, paged=True, weights="native",
             fault_plan=None):
    """A tensor-parallel GenerationServer over every rank (a 1 x N
    mesh): rank 0 serves ``prompts`` greedily over HTTP through its
    lockstep engine while the others follow; ``fault_plan`` is
    installed on every rank first (utils/faults.py). Returns rank 0's
    sequences, the model-sharded parameter names and the engine
    rebuilds."""
    import json
    import os
    import urllib.request

    from container_engine_accelerators_tpu_torch.parallel.spmd import Spmd
    from container_engine_accelerators_tpu_torch.serving import lockstep
    from container_engine_accelerators_tpu_torch.utils import faults
    from container_engine_accelerators_tpu_torch.serving.server import (
        GenerationServer,
    )

    if weights == "int8":
        tree = convert.quantize_lm(config, tree)
    model = convert.load_lm(dict(config, weights=weights), tree,
                            device="cpu", dtype=torch.float32)
    spmd = Spmd(build_mesh(MeshSpec(data=1, model=dist.get_world_size())),
                model)
    sharded = sorted(n for n, lay in spmd.layouts.items()
                     if lay.model_dim is not None)
    channel = lockstep.Channel()
    if fault_plan is not None:
        faults.install(fault_plan)
    saved = os.environ.get("CEA_TPU_PAGED_KV")
    os.environ["CEA_TPU_PAGED_KV"] = "1" if paged else "0"
    try:
        if rank > 0:
            lockstep.follow(channel, model)
            faults.reset()
            return None
        srv = GenerationServer("lm", model, port=0, max_new_tokens=new,
                               max_batch=4, host="127.0.0.1",
                               lockstep=channel)
    finally:
        if saved is None:
            os.environ.pop("CEA_TPU_PAGED_KV", None)
        else:
            os.environ["CEA_TPU_PAGED_KV"] = saved
    srv.start()
    try:
        seqs = []
        for prompt in prompts:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/models/lm:generate",
                data=json.dumps({"prompts": [prompt],
                                 "max_new_tokens": new}).encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                seqs.append(json.loads(resp.read())["sequences"][0])
        paged_engine = srv.engine.paged
        rebuilds = srv.stats()["engine_rebuilds"]
    finally:
        srv.stop()
        channel.stop()
        faults.reset()
    return {"sequences": seqs, "sharded": sharded, "paged": paged_engine,
            "rebuilds": rebuilds}


# -- pipeline parallelism ----------------------------------------------------


def _toy_stage(w, h):
    return torch.tanh(h @ w["w"] + w["b"])


def pipe_toy(rank, kind, params, x, pipe, data, microbatches,
             layout="rows"):
    """The port's ``kind`` schedule ("gpipe" or "circular") over a (data,
    pipe) mesh on the toy stage tanh(h @ w + b), from the whole natural
    stack ``params`` ({"w": [S, D, D], "b": [S, D]}) and the global
    batch ``x``: this rank holds its placement rows (``layout`` "rows",
    the circular schedule's ``pre_permuted``) or the whole natural stack
    ("whole"). Under the loss sum(out ** 2) of its data rank's outputs,
    returns the outputs, its coordinate, the rows it holds, the
    gradients of what it holds and of its input rows, and its stage
    calls; a ValueError comes back as (type name, message)."""
    from container_engine_accelerators_tpu_torch.parallel import pipeline

    mesh = pipeline.build_pipeline_mesh(pipe, data=data)
    coord = tuple(mesh.get_coordinate())
    di, d = coord
    n = params["w"].shape[0]
    if layout == "whole":
        rows, held = list(range(n)), params
    else:
        order = pipeline.circular_stage_order(n, pipe)
        span = pipeline.stage_sharding(mesh, n)[d]
        # The natural stage of each held placement row.
        rows = [int(order[k]) for k in span]
        held = {k: v[rows] for k, v in params.items()}
    local = {k: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_()
             for k, v in held.items()}
    b = x.shape[0] // data
    xl = torch.from_numpy(np.ascontiguousarray(
        x[di * b:(di + 1) * b])).requires_grad_()
    calls = []

    def stage_fn(w, h):
        calls.append(1)
        return _toy_stage(w, h)

    try:
        if kind == "gpipe":
            out = pipeline.pipeline_apply(mesh, stage_fn, local, xl,
                                          num_microbatches=microbatches)
        else:
            out = pipeline.circular_pipeline_apply(
                mesh, stage_fn, local, xl, num_microbatches=microbatches,
                pre_permuted=layout != "whole")
    except ValueError as e:
        return type(e).__name__, str(e)
    (out ** 2).sum().backward()
    return {"coord": coord, "rows": rows, "out": out.detach().numpy(),
            "grads": {k: t.grad.numpy() for k, t in local.items()},
            "x_grad": xl.grad.numpy(), "calls": len(calls)}


def _pipe_lm(config, tree, pipe, stage, remat=False):
    from container_engine_accelerators_tpu_torch.parallel.pipeline_lm import (
        PipelinedLM,
    )
    lm = PipelinedLM(**config, pipe=pipe, stage=stage, remat=remat,
                     dtype=torch.float32, device="cpu")
    return lm.load(tree).train()


def pipe_lm(rank, config, tree, tokens, pipe, data, microbatches,
            remat=False, model_pipe=None):
    """The port's PipelinedLM (f32) of ``config`` loaded with this
    rank's rows of the JAX-layout ``tree`` on a (data, pipe) mesh:
    its data rank's logits and next-token loss on the global
    ``tokens``, the gradients (averaged over the data axis) as this
    rank's rows in the JAX layout and their global norm (the clip's,
    over every stage), the reference_apply logits of a
    model holding every row, and the launches a step would count (the
    blocks' forwards). ``model_pipe`` builds the model for another pipe
    size: a ValueError comes back as (type name, message)."""
    from container_engine_accelerators_tpu_torch.parallel import (
        pipeline,
        pipeline_lm,
    )

    mesh = pipeline.build_pipeline_mesh(pipe, data=data)
    di, d = mesh.get_coordinate()
    stage = d if model_pipe is None else 0
    lm = _pipe_lm(config, tree, model_pipe or pipe, stage, remat)
    calls = []
    for block in lm.blocks:
        block.register_forward_pre_hook(lambda *a: calls.append(1))
    tok = torch.from_numpy(pipeline_lm.local_batch(
        mesh, np.asarray(tokens)).astype(np.int64))
    try:
        logits = lm.apply(tok, mesh=mesh, num_microbatches=microbatches)
    except ValueError as e:
        return type(e).__name__, str(e)
    loss = next_token_loss_fn(cross_entropy_loss)(logits, tok)
    loss.backward()
    pipeline_lm.reduce_grads(lm, mesh)
    norm = pipeline_lm.grad_norm(lm, mesh)
    grads = convert.pipeline_params_to_flax(
        {n: p.grad for n, p in lm.named_parameters()}, lm.config())
    ref = _pipe_lm(config, tree, pipe, None)
    with torch.no_grad():
        ref_logits = ref.reference_apply(tok)
    return {"coord": (di, d), "rows": list(lm.rows),
            "logits": logits.detach().numpy(),
            "loss": float(pipeline_lm.mean_over_data(loss, mesh)),
            "grads": _numpy(grads), "ref_logits": ref_logits.numpy(),
            "norm": None if norm is None else float(norm),
            "calls": len(calls)}


def pipe_driver(rank, argv):
    """The port's driver main(argv) on this rank of the pool's world (a
    caller's group: the driver keeps it). Returns the result and each
    step's loss."""
    from container_engine_accelerators_tpu_torch import train as port_train

    losses = []
    result = port_train.main(
        argv, on_step=lambda step, loss: losses.append(float(loss)))
    return {"result": result, "losses": losses}


# -- elastic training ------------------------------------------------------


def _step_batch(step, batch=24):
    from container_engine_accelerators_tpu_torch.parallel.data import (
        synthetic_step_batch,
    )
    images, labels = synthetic_step_batch(step, batch, (28, 28, 1), 10,
                                          seed=7)
    return torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64))


def _elastic_trainer(tree, hidden, mesh):
    return Trainer(_mlp(tree, hidden).train(), cross_entropy_loss,
                   Sgd(0.1, momentum=0.9), mesh=mesh, mfu_source="off")


def _whole(trainer, state):
    """(params, momentum) of ``state`` as whole numpy leaves by name
    (collective over the trainer's mesh)."""
    with trainer.full_state(state):
        params = {n: p.detach().numpy().copy()
                  for n, p in state.model.named_parameters()}
        moms = {n: state.optimizer.state[p]["momentum_buffer"].numpy().copy()
                for n, p in state.model.named_parameters()}
    return params, moms


def elastic_restore(rank, tree, hidden, directory, targets):
    """Train the MLP 2 steps on a 2 x 2 (data, model) mesh and checkpoint
    it (rank 0 writes whole leaves); then, for each (data, model) in
    ``targets`` over the leading ranks, restore it into a fresh Trainer
    through ``restore_state(shardings=)``. Returns the saved whole
    params and momentum, and for each target this rank's coordinate,
    the restored ones made whole again, the local shapes of the sharded
    leaves, the restored step and a next step's loss (None on a rank
    the target mesh leaves out)."""
    from container_engine_accelerators_tpu_torch.parallel import (
        CheckpointManager,
        restore_state,
        state_payload,
    )

    torch.manual_seed(0)
    trainer = _elastic_trainer(tree, hidden,
                               build_mesh(MeshSpec(data=2, model=2)))
    state = trainer.init_state()
    for step in range(2):
        state, _ = trainer.train_step(state, _step_batch(step))
    mgr = CheckpointManager(directory, primary=rank == 0)
    with trainer.full_state(state):
        mgr.save(state_payload(state), step=state.step, blocking=True)
    dist.barrier()
    saved = _whole(trainer, state)
    out = {"saved": saved, "targets": []}
    for data, model in targets:
        n = data * model
        mesh = build_mesh(MeshSpec(data=data, model=model),
                          devices=list(range(n)))
        if mesh.get_coordinate() is None:
            out["targets"].append(None)
            continue
        mesh_trainer = _elastic_trainer(tree, hidden, mesh)
        template = mesh_trainer.init_state()
        restored = restore_state(
            mgr, template, shardings=mesh_trainer.state_shardings(template))
        shapes = {name: tuple(p.shape)
                  for name, p in restored.model.named_parameters()}
        whole, step = _whole(mesh_trainer, restored), restored.step
        _, loss = mesh_trainer.train_step(restored, _step_batch(2))
        out["targets"].append({
            "coord": tuple(mesh_trainer.mesh.get_coordinate()),
            "step": step, "whole": whole, "shapes": shapes,
            "loss": float(loss)})
    return out


def elastic_rebuild(rank, tree, hidden, directory, hosts, model, evict,
                    checkpoint=True):
    """The in-process recovery: the MLP on a (len(hosts) x ranks a host /
    model, model) mesh, 3 steps, a checkpoint (skipped without
    ``checkpoint``), 3 more steps uninterrupted; then the supervisor
    evicts ``evict`` (health down), every rank calls rebuild, and the
    survivors resume from the checkpoint on the reshaped mesh and run
    the same 3 steps (from the init without a checkpoint). Returns the
    uninterrupted losses (the first 3 and the 3 after the checkpoint),
    the survivors' losses, the new mesh's shape, the resume step and
    the restart bucket (None for the rebuilt values on a departed
    rank)."""
    from container_engine_accelerators_tpu_torch import obs
    from container_engine_accelerators_tpu_torch.parallel import (
        CheckpointManager,
        ElasticSupervisor,
        state_payload,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        mesh_shape,
    )

    torch.manual_seed(0)
    per_host = dist.get_world_size() // len(hosts)
    trainer = _elastic_trainer(tree, hidden, build_mesh(MeshSpec(
        data=dist.get_world_size() // model, model=model)))
    state = trainer.init_state()
    mgr = CheckpointManager(directory, goodput=trainer.goodput,
                            primary=rank == 0)
    first = []
    for step in range(3):
        state, loss = trainer.train_step(state, _step_batch(step))
        first.append(float(loss))
    if checkpoint:
        with trainer.full_state(state):
            mgr.save(state_payload(state), step=state.step)
    ref = []
    for step in range(3, 6):
        state, loss = trainer.train_step(state, _step_batch(step))
        ref.append(float(loss))
    sup = ElasticSupervisor(
        hosts=hosts, chips_per_host=per_host, model_parallel=model,
        goodput=trainer.goodput, tracer=obs.Tracer(enabled=False),
        host_devices={h: list(range(i * per_host, (i + 1) * per_host))
                      for i, h in enumerate(hosts)})
    plan = sup.observe(down=[evict])
    mgr.wait_until_finished()
    dist.barrier()
    whole = convert.image_variables_from_flax(_mlp(tree, hidden), tree)
    new_trainer, new_state, new_mesh = sup.rebuild(
        plan, trainer, mgr, init_state=lambda t: t.init_state(whole))
    out = {"first": first, "ref": ref, "mesh": mesh_shape(new_mesh),
           "plan": (plan.mesh_spec.data, plan.mesh_spec.model),
           "survivors": plan.survivors, "losses": None}
    if new_trainer is None:
        return out
    out["resume_step"] = plan.resume_step
    out["state_step"] = new_state.step
    losses = []
    for step in range(new_state.step, new_state.step + 3):
        new_state, loss = new_trainer.train_step(new_state,
                                                 _step_batch(step))
        losses.append(float(loss))
    out["losses"] = losses
    out["restart_s"] = trainer.goodput.publish()["buckets"]["restart"]
    out["same_ledger"] = new_trainer.goodput is trainer.goodput
    return out


def hybrid_mesh(rank, model, granules):
    """(shape, the mesh's rank grid) of build_hybrid_mesh over the world,
    or the error's (type name, message)."""
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        build_hybrid_mesh,
    )
    try:
        mesh = build_hybrid_mesh(model=model, num_granules=granules)
    except ValueError as e:
        return type(e).__name__, str(e)
    return mesh_shape(mesh), mesh.mesh.tolist()


# -- the multichip dryrun ----------------------------------------------------


def named_mesh_facts(rank, shape, names):
    """(shape dict, coordinate or None, each axis' peers in group-rank
    order, axis_size/axis_index of every axis) of named_mesh(shape,
    names) over the world, or the error's (type name, message)."""
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        axis_index,
        axis_size,
        named_mesh,
    )
    try:
        mesh = named_mesh(shape, names)
    except ValueError as e:
        return type(e).__name__, str(e)
    coord = mesh.get_coordinate()
    if coord is None:
        return mesh_shape(mesh), None, None, None
    peers = {a: dist.get_process_group_ranks(axis_group(mesh, a))
             for a in names}
    return (mesh_shape(mesh), tuple(coord), peers,
            {a: (axis_size(mesh, a), axis_index(mesh, a)) for a in names})


def dryrun_stage(rank, name, **inputs):
    """One stage of the port's dryrun on the pool's world (f32 on the
    CPU) from numpy ``inputs`` (the JAX init and batch); its output."""
    import functools

    from container_engine_accelerators_tpu_torch.parallel import dryrun

    fns = {"dp_tp": dryrun.stage_dp_tp,
           "fsdp": functools.partial(dryrun.stage_dp_tp, fsdp=True),
           "dp_sp_ep": dryrun.stage_dp_sp_ep, "pp": dryrun.stage_pp,
           "host_grid": dryrun.stage_host_grid}
    torch.manual_seed(0)
    return fns[name](dist.get_world_size(), "cpu", **inputs)


def dryrun_all(rank, n):
    """``dryrun_multichip(n, device="cpu")`` on this rank."""
    from container_engine_accelerators_tpu_torch.parallel import dryrun

    return dryrun.dryrun_multichip(n, device="cpu")


def combined_grads(rank, tree, tokens, shape, aux_only=False):
    """The dryrun's MoE LM (f32) from the flax ``tree`` bound to the
    ``shape`` (data, context, expert) mesh, through the Trainer's
    sequence-sharded forward and loss on the global ``tokens`` (the
    next-token loss plus the router's aux; ``aux_only``: 0.01 aux
    alone), the backward and the gradient reductions of one step,
    without its update. Returns the reported loss, the whole gradients
    in the flax layout, the clip's global norm, and the all-reduces the
    reduction issued as (group's ranks, elements)."""
    from container_engine_accelerators_tpu_torch.models.moe import (
        with_router_loss,
    )
    from container_engine_accelerators_tpu_torch.parallel import dryrun

    mesh = dryrun.combined_mesh(*shape)
    model = dryrun.bind_combined(convert.load_lm(
        dryrun.MOE_LM, tree, device="cpu", dtype=torch.float32,
        trainable=True), mesh)
    loss_fn = ((lambda outputs, labels: 0.01 * outputs[1]) if aux_only
               else with_router_loss(next_token_loss_fn(cross_entropy_loss)))
    trainer = Trainer(model, loss_fn, Sgd(0.1), mesh=mesh,
                      mfu_source="off")
    spmd = trainer._spmd
    t = torch.from_numpy(np.asarray(tokens).astype(np.int64))
    loss = trainer._loss_of(t, t, 0)
    loss.backward()
    calls, real = [], dist.all_reduce

    def counted(tensor, *args, group=None, **kwargs):
        calls.append((dist.get_process_group_ranks(group), tensor.numel()))
        return real(tensor, *args, group=group, **kwargs)

    dist.all_reduce = counted
    try:
        spmd.reduce_grads(model)
    finally:
        dist.all_reduce = real
    norm = spmd.grad_norm(model)
    reported = spmd.mean_over_data(loss)
    grads = {}
    for name, param in model.named_parameters():
        layout = spmd.layouts.get(name)
        # No gradient reaches w_out through the aux alone: zero, as
        # jax.grad gives it.
        g = torch.zeros_like(param) if param.grad is None else param.grad
        if layout is not None and layout.sharded:
            g = spmd._whole(g, layout)
        grads[name] = g
    local = sum(p.numel() for p in model.parameters())
    return {"loss": float(reported),
            "grads": _numpy(convert.params_to_flax(grads, dryrun.MOE_LM)),
            "norm": None if norm is None else float(norm),
            "all_reduces": calls, "local_numel": local}

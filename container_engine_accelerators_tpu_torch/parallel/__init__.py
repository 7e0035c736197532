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


"""Training for the port: the Trainer (on one device or as one rank
of a ("data", "model"), ("data", "context"), ("data", "expert") or
("data", "context", "expert") mesh, with FSDP; SGD or Adam), its
losses, its synthetic and real data, checkpoints, the mesh (with DCN
granules), the sharding rules, the collectives, context parallelism
(ring and Ulysses attention), expert parallelism, pipeline parallelism
(GPipe and circular schedules, the PipelinedLM), elastic training
(eviction supervisor, resharded restore), the multi-host start-up and
the multichip dryrun (``dryrun.dryrun_multichip``). Counterpart of
container_engine_accelerators_tpu/parallel/."""

from .checkpoint import CheckpointManager, restore_state, state_payload
from .data import (
    NpzShardDataset,
    PrefetchLoader,
    SyntheticLoader,
    SyntheticTokenLoader,
)
from .context import (
    build_context_mesh,
    dot_product_attention,
    ring_attention,
    ulysses_attention,
)
from .data import reassign_shards, shard_assignment
from .elastic import (
    ElasticSupervisor,
    EvictionPolicy,
    FleetExhausted,
    ReshapePlan,
)
from .expert import build_expert_mesh, dense_moe, expert_parallel_moe
from .mesh import (
    MeshSpec,
    build_hybrid_mesh,
    build_mesh,
    chips_from_env,
    reshape_spec,
)
from .pipeline import (
    PIPELINE_AXIS,
    build_pipeline_mesh,
    circular_pipeline_apply,
    circular_stage_order,
    pipeline_apply,
    stack_stage_params,
    stage_sharding,
)
from .pipeline_lm import PipelinedLM
from .sharding import batch_sharding, param_shardings, replicated
from .train import Adam, Sgd, TrainState, Trainer, cross_entropy_loss

__all__ = ["Adam", "CheckpointManager", "ElasticSupervisor",
           "EvictionPolicy", "FleetExhausted", "MeshSpec", "NpzShardDataset",
           "PIPELINE_AXIS", "PipelinedLM", "PrefetchLoader",
           "ReshapePlan", "Sgd", "SyntheticLoader",
           "SyntheticTokenLoader", "TrainState", "Trainer",
           "batch_sharding", "build_context_mesh", "build_expert_mesh",
           "build_hybrid_mesh", "build_mesh", "build_pipeline_mesh",
           "chips_from_env", "circular_pipeline_apply",
           "circular_stage_order", "cross_entropy_loss", "dense_moe",
           "dot_product_attention", "expert_parallel_moe",
           "param_shardings", "pipeline_apply", "reassign_shards",
           "replicated", "reshape_spec", "restore_state",
           "ring_attention", "shard_assignment", "stack_stage_params",
           "stage_sharding", "state_payload", "ulysses_attention"]

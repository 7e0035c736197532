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

"""The registry of the metric names the port publishes.

The port's own copy of the serving, fleet, router, training, memory
and profiler part of the JAX package's obs/metric_names.py: the same
tpu_* names, so the fleet
collector, the HPA and a dashboard read a PyTorch engine and a JAX
engine alike. Every publisher imports its name from here; a literal that
drifted between the Prometheus, varz and /stats surfaces would split
one series in two.
"""

SERVING_SLOT_OCCUPANCY = "tpu_serving_slot_occupancy"
SERVING_TTFT = "tpu_serving_ttft_seconds"
SERVING_TPOT = "tpu_serving_tpot_seconds"
SERVING_SLO_VIOLATIONS = "tpu_serving_slo_violations_total"
SERVING_SLOTS_ACTIVE = "tpu_serving_slots_active"
SERVING_SLOTS_FREE = "tpu_serving_slots_free"
SERVING_KV_BLOCKS_TOTAL = "tpu_serving_kv_blocks_total"
SERVING_KV_BLOCKS_FREE = "tpu_serving_kv_blocks_free"
SERVING_KV_BLOCKS_SHARED = "tpu_serving_kv_blocks_shared"
SERVING_KV_SPILL_BLOCKS = "tpu_serving_kv_spill_blocks"
SERVING_KV_SPILL_HITS = "tpu_serving_kv_spill_hits_total"
SERVING_KV_REHYDRATE = "tpu_serving_kv_rehydrate_seconds"
SERVING_LATENCY_ATTRIBUTION = (
    "tpu_serving_latency_attribution_seconds")
SERVING_SATURATION = "tpu_serving_saturation"
SERVING_SATURATION_CAUSE = "tpu_serving_saturation_cause"
SERVING_ENGINE_REBUILDS = "tpu_serving_engine_rebuilds_total"

# -- fleet (the multi-engine collector, obs/fleet.py) ------------------
FLEET_ENGINES = "tpu_fleet_engines"
FLEET_SATURATION = "tpu_fleet_saturation"
FLEET_TTFT = "tpu_fleet_ttft_seconds"
FLEET_TPOT = "tpu_fleet_tpot_seconds"
FLEET_SLO_BURN = "tpu_fleet_slo_burn_rate"
FLEET_DESIRED_REPLICAS = "tpu_fleet_desired_replicas"
FLEET_POLLS = "tpu_fleet_polls_total"
FLEET_POLL_ERRORS = "tpu_fleet_poll_errors_total"

# -- router (the fleet front door, serving/router.py) ------------------
ROUTER_ROUTED = "tpu_router_routed_total"
ROUTER_SHED = "tpu_router_shed_total"
ROUTER_FAILOVER = "tpu_router_failover_total"
ROUTER_AFFINITY_HIT_RATE = "tpu_router_affinity_hit_rate"
ROUTER_LATENCY_ATTRIBUTION = (
    "tpu_router_latency_attribution_seconds")
ROUTER_E2E_LATENCY = "tpu_router_e2e_seconds"
ROUTER_UPSTREAM_TTFB = "tpu_router_upstream_ttfb_seconds"
ROUTER_SLO_VIOLATIONS = "tpu_router_slo_violations_total"

# -- training ---------------------------------------------------------
TRAIN_MFU = "tpu_train_mfu"
DECODE_MFU = "tpu_decode_mfu"
TRAIN_GOODPUT_RATIO = "tpu_train_goodput_ratio"
TRAIN_BADPUT_SECONDS = "tpu_train_badput_seconds"
TRAIN_STEP_SKEW = "tpu_train_step_skew_ratio"
TRAIN_RECOVERY = "tpu_train_recovery_total"
TRAIN_CHECKPOINT_BLOCK = "tpu_train_checkpoint_block_seconds"
PERF_LEDGER_APPENDS = "tpu_perf_ledger_appends"

# -- memory / profiler ------------------------------------------------
HBM_BYTES_IN_USE = "tpu_hbm_bytes_in_use"
HBM_PEAK_BYTES = "tpu_hbm_peak_bytes"
HBM_BYTES_LIMIT = "tpu_hbm_bytes_limit"
PROFILE_CAPTURES = "tpu_profile_captures_total"

METRICS = {
    TRAIN_MFU: "model FLOP utilization of the train step",
    DECODE_MFU: "model FLOP utilization of the serving decode loop",
    TRAIN_GOODPUT_RATIO: "productive fraction of train wall time",
    TRAIN_BADPUT_SECONDS: "non-productive wall seconds by bucket",
    TRAIN_STEP_SKEW: "per-host step-time skew vs fleet median",
    HBM_BYTES_IN_USE: "allocator bytes in use per device",
    HBM_PEAK_BYTES: "allocator peak bytes per device",
    HBM_BYTES_LIMIT: "allocator byte limit per device",
    PROFILE_CAPTURES: "completed /debug/profile captures",
    SERVING_SLOT_OCCUPANCY: "active/total slot fraction per step",
    SERVING_TTFT: "admission-to-first-token latency",
    SERVING_TPOT: "per-token gap of in-flight rows",
    SERVING_SLO_VIOLATIONS: "TTFT/TPOT SLO threshold burns",
    SERVING_SLOTS_ACTIVE: "engine slots decoding this step",
    SERVING_SLOTS_FREE: "engine slots free this step",
    SERVING_KV_BLOCKS_TOTAL: "paged KV arena size in blocks",
    SERVING_KV_BLOCKS_FREE: "paged KV blocks on the free list",
    SERVING_KV_BLOCKS_SHARED: "paged KV blocks with refcount > 1",
    SERVING_KV_SPILL_BLOCKS: "prefix blocks parked in the host tier",
    SERVING_KV_SPILL_HITS: "admissions served from the spill tier",
    SERVING_KV_REHYDRATE: "spill-tier rehydrate upload latency",
    SERVING_LATENCY_ATTRIBUTION:
        "per-request latency by attribution bucket",
    SERVING_SATURATION: "max cause-wise serving saturation (0..1)",
    SERVING_SATURATION_CAUSE: "per-cause serving saturation (0..1)",
    SERVING_ENGINE_REBUILDS:
        "engine quarantine-and-rebuild episodes by fault reason",
    FLEET_ENGINES: "engines by liveness state (up/down/unready)",
    FLEET_SATURATION:
        "cause-wise fleet saturation, max and mean over engines",
    FLEET_TTFT: "fleet-merged TTFT distribution (exact bucket merge)",
    FLEET_TPOT: "fleet-merged TPOT distribution (exact bucket merge)",
    FLEET_SLO_BURN:
        "SLO error-budget burn rate per (slo, fast/slow window)",
    FLEET_DESIRED_REPLICAS:
        "HPA-shaped replica target from sustained fleet saturation",
    FLEET_POLLS: "completed fleet poll cycles",
    FLEET_POLL_ERRORS: "engine poll attempts that failed, by engine",
    ROUTER_ROUTED:
        "requests placed, by reason "
        "(affinity/least_loaded/hedge/spill)",
    ROUTER_SHED: "requests shed at the router door, by reason",
    ROUTER_FAILOVER: "streams resumed on a sibling engine, by kind",
    ROUTER_AFFINITY_HIT_RATE:
        "fraction of keyed requests landing on their affinity engine",
    ROUTER_LATENCY_ATTRIBUTION:
        "per-request router-side latency by journey bucket",
    ROUTER_E2E_LATENCY:
        "router receipt to final byte, end to end per request",
    ROUTER_UPSTREAM_TTFB:
        "router placement to first upstream body line",
    ROUTER_SLO_VIOLATIONS:
        "router-measured end-to-end SLO burns per (slo, tenant)",
    TRAIN_RECOVERY: "elastic-training recovery actions by reason",
    TRAIN_CHECKPOINT_BLOCK: "train-thread-blocking checkpoint time",
    PERF_LEDGER_APPENDS: "perf-ledger rows appended, by source",
}

# tpu_-prefixed tokens that are NOT metric names (label keys, module
# prefixes), as the JAX package's registry lists them.
NON_METRIC_TOKENS = frozenset({
    "tpu_device",           # label key on the plugin gauge set
    "tpu_metrics_bridge",   # sidecar module name (cmd/)
    "tpu_diagnose_bundle",  # diagnostics bundle format tag
})

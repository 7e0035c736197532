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

"""The registry of the serving metric names the port publishes.

The port's own copy of the serving part of the JAX package's
obs/metric_names.py: the same tpu_* names, so the fleet
collector and a dashboard read a PyTorch engine and a JAX engine
alike. Every publisher imports its name from here; a literal that
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

METRICS = {
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
}

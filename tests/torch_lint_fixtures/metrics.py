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

# Seeded violations of the port lint's metric-registry rule.
from container_engine_accelerators_tpu_torch import obs

NAMES = (
    "tpu_train_mfu",
    "tpu_serving_ttft_seconds_bucket",
    "tpu_train_recovery_total",
    "tpu_device",
    "tpu_made_up_metric",  # EXPECT: metric-registry
    "tpu_train_mfu_ratio",  # EXPECT: metric-registry
)


def publish():
    obs.gauge("tpu_not_declared_anywhere", 1.0)  # EXPECT: metric-registry

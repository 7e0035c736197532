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


"""Single-device training for the port: the Trainer, its losses and
its synthetic data. Counterpart of
container_engine_accelerators_tpu/parallel/ (mesh, sharding and the
distributed forms are not ported yet)."""

from .data import SyntheticLoader, SyntheticTokenLoader
from .train import Sgd, TrainState, Trainer, cross_entropy_loss

__all__ = ["Sgd", "SyntheticLoader", "SyntheticTokenLoader", "TrainState",
           "Trainer", "cross_entropy_loss"]

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

# Seeded violations of the port lint's jax-import rule.
import importlib

import jax  # EXPECT: jax-import
from container_engine_accelerators_tpu.models import resnet  # EXPECT: jax-import
from container_engine_accelerators_tpu_torch import obs


def lazy():
    import flax.linen  # EXPECT: jax-import
    numpy = importlib.import_module("jax.numpy")  # EXPECT: jax-import
    return numpy, obs, resnet, jax

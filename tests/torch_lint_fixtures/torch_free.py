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

# lint: torch-free
# Seeded violations of the port lint's torch-free-import rule: this file
# opts in with the marker above.
import json
import torch  # EXPECT: torch-free-import

if json:
    import triton  # EXPECT: torch-free-import


def lazy():
    import torch
    return torch

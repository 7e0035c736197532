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

# Seeded violations of the port lint's bare-env-read rule (parsed, never
# imported). Each finding line carries an EXPECT comment.
import os

from container_engine_accelerators_tpu_torch.utils import env_number, env_str

KNOB = "CEA_TPU_FIXTURE_KNOB"


def reads():
    a = os.environ.get("CEA_TPU_FIXTURE_A")  # EXPECT: bare-env-read
    b = os.getenv(KNOB)  # EXPECT: bare-env-read
    c = os.environ["CEA_TPU_FIXTURE_C"]  # EXPECT: bare-env-read
    d = env_str("CEA_TPU_FIXTURE_D")
    e = env_number(KNOB, 1)
    f = os.environ.get("HOME")
    g = os.environ.get("CEA_TPU_FIXTURE_G")  # lint: disable=bare-env-read
    os.environ["CEA_TPU_FIXTURE_H"] = "1"
    return a, b, c, d, e, f, g

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

"""The generation and predict servers, their launcher, and the fleet
front door (router, launcher, observer).

Lazy exports (PEP 562): ``serving.affinity``, ``serving.router``,
``serving.serve_fleet`` and ``serving.fleet_observer`` are torch-free
(the front door runs in a process with no torch at all), so this
package must not drag ``serving.server`` (and through it torch) in at
import time. ``GenerationServer`` / ``InferenceServer`` resolve on
first attribute access instead.
"""

import importlib

_SERVER_EXPORTS = ("GenerationServer", "InferenceServer")

__all__ = list(_SERVER_EXPORTS)


def __getattr__(name):
    if name in _SERVER_EXPORTS:
        server = importlib.import_module(".server", __name__)
        return getattr(server, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SERVER_EXPORTS))

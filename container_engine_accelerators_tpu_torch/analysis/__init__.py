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
"""Dynamic analysis for the port: the lock-order sanitizer
(``analysis.tsan``, the JAX package's ``analysis/tsan.py`` in the
port's own copy). Stdlib only; nothing here imports torch or the rest
of the package, so models, serving and parallel import it without
cycles."""

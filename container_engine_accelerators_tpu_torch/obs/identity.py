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

"""Process identity stamp: (host, pid, role).

The port's own copy of the JAX package's ``obs/identity.py``. Every
journal snapshot and every /stats ``engine_id`` carries this stamp.
``role`` names what this process is ("serving", ...): entry points
call set_role(); CEA_TPU_ROLE overrides for processes launched by an
operator.
"""

import os
import socket
import threading

from ..utils import env_str

_lock = threading.Lock()
_role = None


def set_role(role):
    """Name this process's role for the identity stamp. First caller
    wins against later library-level defaults, but an explicit env
    override (CEA_TPU_ROLE) beats everything."""
    global _role
    with _lock:
        if _role is None:
            _role = str(role)


def identity():
    """The (host, pid, role) stamp as a dict — JSON-ready."""
    with _lock:
        role = env_str("CEA_TPU_ROLE") or _role or "unknown"
    return {
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "role": role,
    }


def process_label(ident=None):
    """One display string for a Perfetto process track:
    ``role@host[pid]``."""
    ident = ident or identity()
    return "%s@%s[%d]" % (ident.get("role", "unknown"),
                          ident.get("host", "?"),
                          ident.get("pid", 0))

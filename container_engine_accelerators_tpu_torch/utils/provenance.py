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
"""Provenance stamps for measurement artifacts (counterpart of the JAX
package's ``utils/provenance.py``): when a number was taken, at which
commit, from how clean a tree and on which devices, so a committed
measurement can be audited and reproduced.

``stamp(devices=...)`` describes torch devices: each CUDA device's name
and compute capability, with the torch and CUDA versions. torch is
imported only inside ``stamp`` and only when devices are given.
"""

import datetime
import os
import subprocess
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def git_sha(short=False):
    """Current HEAD sha, or "unknown" outside a git checkout."""
    cmd = ["git", "-C", _REPO_ROOT, "rev-parse"]
    if short:
        cmd.append("--short")
    cmd.append("HEAD")
    try:
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, timeout=10)
        if out.returncode == 0:
            return out.stdout.decode().strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


def git_dirty():
    """True when the working tree differs from HEAD, None outside a
    git checkout (a measurement from a dirty tree is not reproducible
    from the sha alone)."""
    try:
        out = subprocess.run(
            ["git", "-C", _REPO_ROOT, "status", "--porcelain"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, timeout=10)
        if out.returncode == 0:
            return bool(out.stdout.strip())
    except (OSError, subprocess.TimeoutExpired):
        pass
    return None


def describe_device(device):
    """A JSON-safe description of one torch device (or device string):
    its name, and for a CUDA device the card's name and compute
    capability."""
    import torch

    device = torch.device(device)
    info = {"device": str(device), "type": device.type}
    if device.type == "cuda":
        index = device.index if device.index is not None else 0
        info["name"] = torch.cuda.get_device_name(index)
        info["capability"] = ".".join(
            map(str, torch.cuda.get_device_capability(index)))
    return info


def stamp(devices=None, step_log=None):
    """A provenance dict for a measurement artifact.

    Args:
      devices: iterable of torch devices (or device strings) the
        measurement ran on; each is described by ``describe_device``,
        and the torch and CUDA versions are recorded beside them.
      step_log: repo-relative path of the committed per-step log
        backing the number, if one exists.
    """
    info = {
        "generated_utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "git_sha": git_sha(),
        "git_dirty": git_dirty(),
        "python": sys.version.split()[0],
    }
    if devices is not None:
        import torch

        info["torch_version"] = torch.__version__
        info["cuda_version"] = torch.version.cuda
        info["devices"] = [describe_device(d) for d in devices]
    if step_log is not None:
        info["step_log"] = step_log
    return info

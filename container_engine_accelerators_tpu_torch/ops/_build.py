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

"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into a shared
library with a plain C interface under ``build/torch_kernels/`` (git
ignores it). The file name carries a digest of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited kernel rebuilds
and an unchanged one loads from the last build. Nothing here runs at
import: the CPU tests import every module on a machine with no
``nvcc``. ``Kernel`` is the common
launcher of the wrappers in ``ops/attention.py`` and ``ops/xent.py``.
"""

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded = {}


def sources():
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME/bin or PATH): the port's CUDA "
            "kernels build on a machine with the CUDA toolkit")
    return found


def library_path(name):
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns (library path, compiler output; empty when it was
    already built). Raises RuntimeError with the compiler's output
    when nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def build_all(names=None):
    """Build every kernel source at once, one nvcc per source, all
    started together. Returns {name: compiler output}."""
    names = sources() if names is None else list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names) or 1) as pool:
        futures = {name: pool.submit(build, name) for name in names}
        return {name: fut.result()[1] for name, fut in futures.items()}


def load(name):
    """The ctypes handle of kernel library ``name``, built on first
    use. The caller declares argtypes/restype."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


class Kernel:
    """One kernel's launcher: loads entry point ``symbol`` of
    ``csrc/<library>.cu`` at first launch and counts launches
    (``launches``, incremented once per successful launch and nowhere
    else). Subclasses check and allocate, then call ``_launch``."""

    name = None      # the kernel's name in reports
    library = None   # csrc/<library>.cu
    symbol = None    # its extern "C" entry point
    argtypes = ()    # ctypes types; every entry point returns cudaError_t

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    fn = getattr(load(self.library), self.symbol)
                    fn.argtypes = list(self.argtypes)
                    fn.restype = ctypes.c_int
                    self._fn = fn
        return self._fn

    def _launch(self, device, *args, what=""):
        """Call the entry point with ``args`` and the current stream of
        ``device`` (every entry point takes the stream last); raise on
        a nonzero cudaError_t."""
        fn = self._kernel()
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} launch failed: cudaError {err} ({what})")
        with self._lock:
            self.launches += 1

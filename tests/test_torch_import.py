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

"""The PyTorch port stands alone: it imports neither JAX nor anything
of the JAX package (it keeps its own copies of what it needs)."""

import ast
import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "container_engine_accelerators_tpu_torch"
JAX_PACKAGE = "container_engine_accelerators_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", JAX_PACKAGE)


def _port_files():
    out = [os.path.join(REPO_ROOT, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO_ROOT, PORT)):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _module_name(path):
    rel = os.path.relpath(path, REPO_ROOT)[:-len(".py")]
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


PORT_FILES = _port_files()


def test_port_has_the_slice_modules():
    names = {_module_name(p) for p in PORT_FILES}
    for mod in ("utils", "ops", "ops.attention", "ops.xent", "ops._build",
                "models.transformer", "models.convert", "models.decode",
                "serving.server", "serving.serve", "parallel",
                "parallel.data", "parallel.train", "train",
                "train_profile", "bench", "models.layers", "models.resnet",
                "models.mlp", "models.inception", "ops.augment"):
        assert f"{PORT}.{mod}" in names
    for source in ("flash_fwd.cu", "flash_bwd.cu", "xent.cu"):
        assert os.path.isfile(os.path.join(REPO_ROOT, PORT, "ops", "csrc",
                                           source))


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[_module_name(p) for p in PORT_FILES])
def test_no_jax_import_in_source(path):
    """AST scan of every import statement, module level or inside a
    function."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, (
                f"{os.path.relpath(path, REPO_ROOT)}:{node.lineno} "
                f"imports {name}")


def test_importing_the_port_loads_no_jax():
    """Import every module of the port and chip_smoke in a fresh
    interpreter: neither jax nor any module of the JAX package may end
    up in sys.modules."""
    modules = [_module_name(p) for p in PORT_FILES]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax')\n"
        f"             or m.split('.')[0] == {JAX_PACKAGE!r})\n"
        "print('LOADED', len(sys.modules))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH",)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED" in proc.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """On a machine without CUDA the smoke script exits nonzero and
    prints no result line; alone in a directory it fails too."""
    import torch
    if not torch.cuda.is_available():
        proc = subprocess.run([sys.executable, "chip_smoke.py"],
                              cwd=REPO_ROOT, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 2, proc.stderr
        assert '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO_ROOT, "chip_smoke.py")) as f:
        lone.write_text(f.read())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

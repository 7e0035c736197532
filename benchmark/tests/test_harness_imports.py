"""Nothing the benchmark runs loads JAX or the JAX package, judged by
whole top-level module names (the port's name begins with the
package's); the reference imports nothing of the port."""

import ast
import subprocess
import sys

from benchmark import run as bench_run

from .conftest import ROOT

HARNESS = ROOT / "benchmark"
PORT = "container_engine_accelerators_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_top_level_names():
    assert bench_run.forbidden_modules([PORT, PORT + ".ops"]) == []
    assert bench_run.forbidden_modules(
        ["container_engine_accelerators_tpu.ops", "numpy"]) == [
            "container_engine_accelerators_tpu"]
    assert bench_run.forbidden_modules(["jaxlib.xla", "jaxtyping"]) == [
        "jaxlib"]


def test_no_harness_file_imports_jax():
    for path in HARNESS.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in bench_run.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "weights.py", "traffic.py", "flops.py",
                 "judge.py", "stats.py", "loadgen.py"):
        for mod in _imports(HARNESS / "lib" / name):
            assert mod.split(".")[0] != PORT, (name, mod)


def test_what_a_run_loads():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark.lib import serve, train, spec, devtrace, readers\n"
        "import %s.serving.server, %s.parallel.train, %s.ops.xent\n"
        "import %s.models.transformer\n"
        "for m in spec.load_benchmark()['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "print(benchmark.run.forbidden_modules())\n"
        % (str(ROOT), PORT, PORT, PORT, PORT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card(tmp_path):
    """Without CUDA the run exits non-zero and prints no result line."""
    out = subprocess.run(
        [sys.executable, str(HARNESS / "run.py"), "--workload",
         "sc2-7b.codegen", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""

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

"""The port's three tools that read the tree rather than run it: the
convention lint (analysis/lint.py) clean over the port and firing
exactly on its seeded fixtures (tests/torch_lint_fixtures/, the
``# EXPECT:`` grammar of the JAX lint's fixture suite); the program
guard (analysis/programs.py) holding a tiny engine to buckets + insert
+ step on mixed traffic on both pools and tripping on fixtures that
always make a new shape; and the perf-ledger writer (perf_ledger.py)
whose rows round-trip through its own validation, keep the JAX
writer's row schema and refuse the repo's ledgers."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu_torch import perf_ledger
from container_engine_accelerators_tpu_torch.analysis import lint, programs
from container_engine_accelerators_tpu_torch.models import convert, decode

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join("tests", "torch_lint_fixtures")

# -- the lint -----------------------------------------------------------------


def test_lint_is_clean_over_the_port():
    findings = lint.run_lint(root=REPO_ROOT)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_lint_fires_exactly_on_the_seeded_fixtures():
    missing, unexpected = lint.verify_fixtures(FIXTURES, root=REPO_ROOT)
    assert missing == [] and unexpected == [], (missing, unexpected)
    rules = {f.rule for f in lint.run_lint([FIXTURES], root=REPO_ROOT)}
    assert rules == set(lint.rule_ids())


def _tree(root, files):
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


def test_registry_names_are_declared_once(tmp_path):
    """Inside the registry a name assigned twice, or declared without a
    METRICS entry, is a finding; elsewhere a registered name, its
    exposition and a non-metric token pass."""
    pkg = lint.PACKAGE_NAME
    _tree(tmp_path, {
        f"{pkg}/__init__.py": "",
        f"{pkg}/obs/__init__.py": "",
        f"{pkg}/obs/metric_names.py": (
            'A = "tpu_alpha_total"\n'
            'B = "tpu_beta"\n'
            'C = "tpu_alpha_total"  # EXPECT: metric-registry\n'
            'D = "tpu_gamma"  # EXPECT: metric-registry\n'
            'METRICS = {A: "a", B: "b"}\n'
            'NON_METRIC_TOKENS = frozenset({"tpu_device"})\n'),
        f"{pkg}/user.py": (
            'NAMES = ("tpu_beta", "tpu_beta_bucket", "tpu_device",\n'
            '         "tpu_delta")  # EXPECT: metric-registry\n'),
    })
    missing, unexpected = lint.verify_fixtures(pkg, root=str(tmp_path))
    assert missing == [] and unexpected == [], (missing, unexpected)


def test_torch_reaching_a_pinned_module_through_a_chain(tmp_path):
    """obs/a.py imports nothing of torch itself, but its module-scope
    import of models/b.py, which imports torch, reaches it: the finding
    lands on obs/a.py's import line; a function-body import does not
    count."""
    pkg = lint.PACKAGE_NAME
    _tree(tmp_path, {
        f"{pkg}/__init__.py": "",
        f"{pkg}/obs/__init__.py": "",
        f"{pkg}/obs/metric_names.py": "METRICS = {}\n",
        f"{pkg}/models/__init__.py": "",
        f"{pkg}/models/b.py": "import torch\n",
        f"{pkg}/obs/a.py": (
            "import json\n"
            "from ..models import b  # EXPECT: torch-free-import\n"),
        f"{pkg}/obs/lazy.py": (
            "def f():\n"
            "    from ..models import b\n"
            "    return b\n"),
    })
    missing, unexpected = lint.verify_fixtures(pkg, root=str(tmp_path))
    assert missing == [] and unexpected == [], (missing, unexpected)
    finding = [f for f in lint.run_lint([pkg], root=str(tmp_path))
               if f.rule == "torch-free-import"][0]
    assert "models.b -> torch" in finding.message


def test_escapes_and_unknown_expectations(tmp_path):
    _tree(tmp_path, {
        "lint_case/x.py": (
            "# lint: disable-file=jax-import\n"
            "import jax\n"
            "import os\n"
            "A = os.getenv('CEA_TPU_Q')  # lint: disable=bare-env-read\n"
            "B = os.getenv('CEA_TPU_R')  # EXPECT: bare-env-read\n"),
        "lint_case/metric_names_stub.py": "",
    })
    pkg = lint.PACKAGE_NAME
    _tree(tmp_path, {f"{pkg}/obs/metric_names.py": "METRICS = {}\n"})
    missing, unexpected = lint.verify_fixtures("lint_case",
                                               root=str(tmp_path))
    assert missing == [] and unexpected == []
    _tree(tmp_path, {"lint_case/y.py": "X = 1  # EXPECT: no-such-rule\n"})
    with pytest.raises(ValueError, match="unknown rule"):
        lint.verify_fixtures("lint_case", root=str(tmp_path))


def test_lint_command_line():
    def run(*args):
        return subprocess.run(
            [sys.executable, "-m",
             "container_engine_accelerators_tpu_torch.analysis.lint", *args],
            cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    clean = run()
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert run("--fixtures", FIXTURES).returncode == 0
    dirty = run(FIXTURES)
    assert dirty.returncode == 1
    assert "[jax-import]" in dirty.stdout and "[bare-env-read]" in dirty.stdout


# -- the program guard ---------------------------------------------------------

CONFIG = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=4,
              num_kv_heads=2, pos_embedding="rope", max_seq_len=48)
BUCKETS = (8, 16, 32)


@pytest.fixture(scope="module")
def port_lm():
    torch.set_num_threads(2)
    tree = convert.init_flax_layout_params(CONFIG, 5)
    return convert.load_lm(CONFIG, tree, device="cpu", dtype=torch.float32)


def _engine(model, paged, buckets=BUCKETS):
    return decode.SlotDecodeEngine(model, slots=3, slot_len=48, paged=paged,
                                   kv_block_size=4, buckets=buckets)


def _mixed_traffic(engine, rng, pad):
    """Admissions of 3-30 tokens (a shared 12-token prefix on half of
    them, so the paged pool hits its prefix index and forks a boundary
    block), interleaved with steps and releases; dense rows padded to
    their bucket."""
    prefix = rng.integers(0, CONFIG["vocab_size"], 12)
    live = []
    for i, n in enumerate((3, 9, 17, 30, 5, 14, 20, 8, 27, 12)):
        tail = rng.integers(0, CONFIG["vocab_size"], n)
        prompt = np.concatenate([prefix, tail])[:n] if i % 2 else tail
        row = prompt
        if pad:
            width = next(b for b in BUCKETS if b >= n)
            row = np.zeros(width, np.int64)
            row[:n] = prompt
        if not engine.free_slots():
            engine.release(live.pop(0))
        slot = engine.admit(row, n, max_new=8)[0]
        live.append(slot)
        for _ in range(1 + i % 3):
            engine.step()
    for slot in live:
        engine.release(slot)


@pytest.mark.parametrize("paged", [True, False])
def test_guard_holds_the_engine_to_its_bound(port_lm, paged):
    engine = _engine(port_lm, paged)
    # The dense pool prefills what its caller pads: the caller's
    # bucket count is the budget.
    guard = programs.engine_guard(
        engine, prefill_budget=None if paged else len(BUCKETS))
    with guard:
        _mixed_traffic(engine, np.random.default_rng(0), pad=not paged)
    counts = guard.programs()
    want = {"engine.prefill": len(BUCKETS), "engine.step": 1,
            "cuda_graph.capture": 0}
    if paged:
        want["engine.insert"] = 1
    assert counts == want
    assert guard.budgets()["engine.prefill"] == len(BUCKETS)
    # The region is over: the engine and the decode module are as they
    # were.
    assert "step" not in vars(engine)
    assert decode._paged_prefill_impl.__name__ == "_paged_prefill_impl"
    assert decode._slot_prefill.__name__ == "_slot_prefill"


def test_guard_trips_on_an_engine_that_leaks_prompt_widths(port_lm):
    """Without buckets every prompt length is its own admission shape:
    the guard fails naming the prefill and its overshoot."""
    engine = _engine(port_lm, paged=True, buckets=None)
    with pytest.raises(programs.ProgramBoundError,
                       match=r"engine.prefill: \d+ distinct launch shapes "
                             r"\(budget 3, over by \d+\)"):
        with programs.engine_guard(engine, prefill_budget=3):
            _mixed_traffic(engine, np.random.default_rng(1), pad=False)
    assert "step" not in vars(engine)


def _fixture_kernel(x):
    """A seeded fixture that always makes a new shape."""
    return x.sum()


def test_guard_trips_on_a_fixture_that_always_makes_a_new_shape():
    guard = programs.ProgramGuard().watch(
        "fixture.kernel", sys.modules[__name__], "_fixture_kernel")
    with pytest.raises(programs.ProgramBoundError,
                       match=r"fixture.kernel: 4 distinct launch shapes "
                             r"\(budget 1, over by 3\)"):
        with guard:
            for n in range(1, 5):
                _fixture_kernel(torch.ones(n))
    assert _fixture_kernel.__name__ == "_fixture_kernel"
    same = programs.ProgramGuard().watch(
        "fixture.kernel", sys.modules[__name__], "_fixture_kernel")
    with same:
        for _ in range(4):
            _fixture_kernel(torch.ones(3))
    assert same.programs() == {"fixture.kernel": 1}


def test_guard_does_not_mask_the_region_s_own_error():
    guard = programs.ProgramGuard().watch(
        "fixture.kernel", sys.modules[__name__], "_fixture_kernel")
    with pytest.raises(KeyError):
        with guard:
            for n in range(1, 5):
                _fixture_kernel(torch.ones(n))
            raise KeyError("the region's failure")
    assert _fixture_kernel.__name__ == "_fixture_kernel"


# -- the perf-ledger writer -----------------------------------------------------


def test_ledger_rows_round_trip(tmp_path):
    path = str(tmp_path / "ledger.json")
    row = perf_ledger.append_row(
        path, "torch_flash_bench:s2048",
        {"kernel_ms": 0.1178, "tokens_per_sec": 130000.0, "ignored": None},
        config={"seq": 2048}, note="a note")
    skipped = perf_ledger.append_row(
        path, "torch_router_check", {},
        status=perf_ledger.STATUS_SKIPPED)
    with open(path) as f:
        doc = json.load(f)
    assert perf_ledger.validate_doc(doc) == []
    assert doc["rows"] == [row, skipped]
    fp = row["fingerprint"]
    assert fp == {"platform": "cpu", "device_kind": "cpu",
                  "device_count": 1, "torch_version": torch.__version__,
                  "cuda_version": str(torch.version.cuda or "none"),
                  "knobs": fp["knobs"]}
    assert row["provenance"]["torch_version"] == torch.__version__
    assert row["provenance"]["devices"] == [{"device": "cpu",
                                             "type": "cpu"}]
    assert "ignored" not in row["metrics"]
    assert perf_ledger.main(["validate", "--ledger", path]) == 0


def test_ledger_rejects_rows_field_by_field(tmp_path):
    path = str(tmp_path / "ledger.json")
    good = perf_ledger.append_row(path, "torch_x", {"step_ms": 1.0})
    cases = {
        "source": dict(good, source="bench_decode"),
        "status": dict(good, status="maybe"),
        "metrics.step_ms": dict(good, metrics={"step_ms": float("nan")}),
        "metrics.widgets": dict(good, metrics={"widgets": 1.0}),
        "fingerprint.torch_version": dict(
            good, fingerprint=dict(good["fingerprint"], torch_version="")),
        "provenance.git_sha": dict(
            good, provenance=dict(good["provenance"], git_sha="")),
        "extra": dict(good, extra=1),
    }
    for field, row in cases.items():
        problems = perf_ledger.validate_row(row)
        assert any(f"row.{field}" in p for p in problems), (field, problems)
    skipped = dict(good, status=perf_ledger.STATUS_SKIPPED)
    assert any("must be empty" in p
               for p in perf_ledger.validate_row(skipped))
    with pytest.raises(perf_ledger.LedgerError, match="non-conforming row"):
        perf_ledger.append_row(path, "torch_x", {"widgets": 1.0})
    with open(path) as f:
        assert len(json.load(f)["rows"]) == 1


def test_ledger_refuses_the_repo_ledgers(tmp_path):
    for name in ("PERF_LEDGER.json", "PERF_LEDGER.jsonl"):
        with pytest.raises(perf_ledger.LedgerError, match="refusing"):
            perf_ledger.append_row(str(tmp_path / name), "torch_x",
                                   {"step_ms": 1.0})
        assert not (tmp_path / name).exists()
    with pytest.raises(perf_ledger.LedgerError):
        perf_ledger.append_row("", "torch_x", {"step_ms": 1.0})


def test_ledger_row_schema_is_the_jax_writers(tmp_path):
    """A port row carries the JAX writer's row keys and statuses, and
    every metric direction the two tables share agrees; only the
    fingerprint's version keys differ (torch and CUDA for jax)."""
    sys.path.insert(0, os.path.join(REPO_ROOT, "tools"))
    try:
        import perf_ledger as jax_ledger
    finally:
        sys.path.remove(os.path.join(REPO_ROOT, "tools"))
    row = perf_ledger.append_row(str(tmp_path / "l.json"), "torch_x",
                                 {"p50_ms": 1.0, "mfu": 0.5})
    assert set(row) <= jax_ledger._ROW_KEYS
    assert perf_ledger._ROW_KEYS == jax_ledger._ROW_KEYS
    assert perf_ledger._STATUSES == jax_ledger._STATUSES
    for name, direction in jax_ledger.METRIC_DIRECTIONS.items():
        assert perf_ledger.METRIC_DIRECTIONS[name] == direction
    jax_problems = jax_ledger.validate_row(row)
    assert jax_problems == [
        "row.fingerprint.jax_version: want a non-empty string, got None"]

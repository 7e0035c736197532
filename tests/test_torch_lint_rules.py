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

"""The port lint's ``lock-with`` and ``ledger-writer`` rules
(analysis/lint.py) against the JAX lint's (analysis/rules/lock_rules.py,
ledger_rules.py): each fires exactly on its seeded fixture's EXPECT
lines (tests/torch_lint_fixtures/locks.py, ledger.py), on the same
lines as the JAX rule on that fixture and on the JAX suite's own
fixture (tests/fixtures/analysis/), with the JAX rule's message and
hint in the port's words; the port's writer is exempt and the port's
tree is clean."""

import os
import re

import pytest

from container_engine_accelerators_tpu.analysis import lint as jax_lint
from container_engine_accelerators_tpu.analysis.rules.ledger_rules import (
    LedgerWriterRule as JaxLedgerWriterRule,
)
from container_engine_accelerators_tpu.analysis.rules.lock_rules import (
    LockWithRule as JaxLockWithRule,
)
from container_engine_accelerators_tpu_torch.analysis import lint

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FIXTURES = os.path.join("tests", "torch_lint_fixtures")
JAX_FIXTURES = os.path.join("tests", "fixtures", "analysis")

RULES = {
    "lock-with": (lint.LockWithRule, JaxLockWithRule, "locks.py",
                  "lock_fixture.py"),
    "ledger-writer": (lint.LedgerWriterRule, JaxLedgerWriterRule,
                      "ledger.py", "ledger_fixture.py"),
}


def _expected(path):
    with open(os.path.join(REPO_ROOT, path)) as f:
        return {n for n, line in enumerate(f, start=1)
                if re.search(r"#\s*EXPECT:\s*\S", line)}


def _port_lines(rule_id, path, root=REPO_ROOT):
    return {f.line for f in lint.run_lint([path], root=root)
            if f.rule == rule_id}


def _jax_lines(jax_rule, path):
    return {f.line for f in jax_lint.run_lint([path], root=REPO_ROOT,
                                              rules=[jax_rule()])}


@pytest.mark.parametrize("rule_id", sorted(RULES))
def test_rule_fires_exactly_on_its_fixture(rule_id):
    _, _, port_fixture, _ = RULES[rule_id]
    path = os.path.join(PORT_FIXTURES, port_fixture)
    want = _expected(path)
    assert want and _port_lines(rule_id, path) == want
    # Nothing else fires there.
    assert {f.rule for f in lint.run_lint([path], root=REPO_ROOT)} == {
        rule_id}


@pytest.mark.parametrize("rule_id", sorted(RULES))
@pytest.mark.parametrize("suite", ["port", "jax"])
def test_rule_fires_where_the_jax_rule_fires(rule_id, suite):
    """The port's rule and the JAX rule on the port's fixture and on
    the JAX suite's: the same lines."""
    _, jax_rule, port_fixture, jax_fixture = RULES[rule_id]
    path = (os.path.join(PORT_FIXTURES, port_fixture) if suite == "port"
            else os.path.join(JAX_FIXTURES, jax_fixture))
    got = _port_lines(rule_id, path)
    assert got and got == _jax_lines(jax_rule, path)
    if suite == "jax":
        assert got == _expected(path)


@pytest.mark.parametrize("rule_id", sorted(RULES))
def test_message_and_hint_follow_the_jax_rule(rule_id):
    port_rule, jax_rule, port_fixture, _ = RULES[rule_id]
    assert port_rule.id == jax_rule.id == rule_id
    findings = [f for f in lint.run_lint(
        [os.path.join(PORT_FIXTURES, port_fixture)], root=REPO_ROOT)]
    assert all(f.hint == port_rule.hint for f in findings)
    if rule_id == "lock-with":
        assert port_rule.hint == jax_rule.hint
        assert {f.message for f in findings} == {
            "bare blocking .acquire() call"}
    else:
        assert "perf_ledger.append_row" in port_rule.hint
        assert "tools/perf_ledger" not in port_rule.hint


def _tree(root, files):
    for rel, text in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


def test_the_port_writer_is_exempt(tmp_path):
    """The same write in the port's perf_ledger.py passes and anywhere
    else fires; the JAX writer's path (tools/perf_ledger.py) is not the
    port's."""
    pkg = lint.PACKAGE_NAME
    body = ('LEDGER = "PERF_LEDGER.jsonl"\n'
            'def write(row):\n'
            '    with open(LEDGER, "a") as f:\n'
            '        f.write(row)\n')
    _tree(tmp_path, {f"{pkg}/__init__.py": "",
                     f"{pkg}/obs/__init__.py": "",
                     f"{pkg}/obs/metric_names.py": "METRICS = {}\n",
                     f"{pkg}/perf_ledger.py": body,
                     f"{pkg}/bench.py": body,
                     "tools/perf_ledger.py": body})
    got = {(f.path, f.line) for f in lint.run_lint(
        [pkg, "tools"], root=str(tmp_path)) if f.rule == "ledger-writer"}
    assert got == {(f"{pkg}/bench.py", 3), ("tools/perf_ledger.py", 3)}


def test_the_port_tree_is_clean_under_both_rules():
    findings = [f for f in lint.run_lint(root=REPO_ROOT)
                if f.rule in RULES]
    assert findings == [], "\n".join(f.format() for f in findings)
    # The sanitizer's lock proxy acquires inside __enter__, escaped as
    # the JAX sanitizer escapes it.
    path = os.path.join(REPO_ROOT, lint.PACKAGE_NAME, "analysis", "tsan.py")
    with open(path) as f:
        assert "# lint: disable=lock-with (IS the `with` impl)" in f.read()

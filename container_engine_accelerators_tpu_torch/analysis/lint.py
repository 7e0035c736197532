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

"""AST lint of the port's conventions (modelled on the JAX package's
analysis/lint.py and its env, metric and import rules; it lints the
port package, not the JAX one).

    python -m container_engine_accelerators_tpu_torch.analysis.lint
    python -m container_engine_accelerators_tpu_torch.analysis.lint \\
        --fixtures tests/torch_lint_fixtures

Rules:

- ``bare-env-read``: a ``CEA_TPU_*`` knob is read only through
  ``utils.env_number`` / ``utils.env_str``, never ``os.environ`` or
  ``os.getenv`` (the ``utils`` package, where the helpers live, is
  exempt; writes are out of scope);
- ``metric-registry``: every ``tpu_*`` literal is declared exactly once
  in the port's ``obs/metric_names.py``: a literal elsewhere must be a
  declared name (or its ``_total``/``_bucket``/``_sum``/``_count``
  exposition, or a registered non-metric token), and inside the
  registry no name is assigned twice and every declared name has a
  ``METRICS`` entry;
- ``torch-free-import``: the modules pinned torch-free (``obs``,
  ``analysis``, ``utils/__init__.py`` and the fleet front door:
  ``serving/__init__.py``, ``router.py``, ``affinity.py``,
  ``serve_fleet.py``, ``fleet_observer.py``, ``router_check.py``)
  import no torch or triton at module scope, directly or through a
  chain of the package's module-scope imports (function-body imports
  are the sanctioned lazy pattern); another file opts in with a
  ``# lint: torch-free`` comment;
- ``jax-import``: no module imports ``jax``, ``jaxlib``, ``flax``,
  ``optax``, ``orbax`` or the JAX package
  (``container_engine_accelerators_tpu``) at any scope,
  or names one to ``importlib.import_module`` / ``__import__``.
- ``lock-with``: no bare blocking ``.acquire()`` (argument-less); a
  lock is held by ``with`` (a checked non-blocking probe is fine);
- ``ledger-writer``: no write-mode ``open`` and no ``replace``/
  ``rename`` of a path that names ``PERF_LEDGER`` statically outside
  the port's writer, ``perf_ledger.py`` (its ``append_row``).

Escapes, as the JAX lint's grammar: ``# lint: disable=rule-a,rule-b``
trailing a line suppresses those rules on that line; ``# lint:
disable-file=rule`` anywhere suppresses a rule for the file.
``verify_fixtures`` lints a seeded-violation tree and diffs the
findings against its ``# EXPECT: rule`` comments.

Stdlib only: it runs where torch is not installed.
"""

import argparse
import ast
import os
import re
import sys
import tokenize

PACKAGE_NAME = "container_engine_accelerators_tpu_torch"
JAX_PACKAGE = "container_engine_accelerators_tpu"

_DISABLE_LINE_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,-]+)")
_DISABLE_FILE_RE = re.compile(r"#\s*lint:\s*disable-file=([A-Za-z0-9_,-]+)")
_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([A-Za-z0-9_,-]+)")

PROJECT_ENV_RE = re.compile(r"^CEA_TPU_[A-Z0-9_]*[A-Z0-9]$")
METRIC_NAME_RE = re.compile(r"^tpu_[a-z0-9_]*[a-z0-9]$")
_EXPOSITION = ("total", "bucket", "sum", "count")

TORCH_FREE_PACKAGES = ("obs", "analysis")
TORCH_FREE_MODULES = ("utils/__init__.py", "serving/__init__.py",
                      "serving/router.py", "serving/affinity.py",
                      "serving/serve_fleet.py",
                      "serving/fleet_observer.py", "router_check.py")
TORCH_ROOTS = ("torch", "triton")
JAX_ROOTS = ("jax", "jaxlib", "flax", "optax", "orbax", JAX_PACKAGE)
_TORCH_FREE_MARKER = "# lint: torch-free"
_REGISTRY_REL = f"{PACKAGE_NAME}/obs/metric_names.py"
_LEDGER_WRITER_REL = f"{PACKAGE_NAME}/perf_ledger.py"
LEDGER_TOKEN = "PERF_LEDGER"


class Finding:
    """One lint hit: where, which rule, what, and how to fix it."""

    __slots__ = ("path", "line", "rule", "message", "hint")

    def __init__(self, path, line, rule, message, hint=""):
        self.path, self.line, self.rule = path, int(line), rule
        self.message, self.hint = message, hint

    def format(self):
        text = f"{self.path}:{self.line}: [{self.rule}] {self.message}"
        return text + (f"  (fix: {self.hint})" if self.hint else "")

    def __repr__(self):
        return f"Finding({self.format()!r})"

    def key(self):
        return (self.path, self.line, self.rule)


class FileContext:
    """One parsed file, its escape comments and its module-level string
    constants (rules resolve ``env_str(SOME_ENV)`` through them)."""

    def __init__(self, path, rel, source):
        self.path, self.rel, self.source = path, rel, source
        self.tree = ast.parse(source, filename=path)
        self.line_disables, self.file_disables = {}, set()
        lines = iter(source.splitlines(True))
        try:
            for tok in tokenize.generate_tokens(lambda: next(lines, "")):
                if tok.type != tokenize.COMMENT:
                    continue
                m = _DISABLE_FILE_RE.search(tok.string)
                if m:
                    self.file_disables.update(
                        r.strip() for r in m.group(1).split(","))
                    continue
                m = _DISABLE_LINE_RE.search(tok.string)
                if m:
                    self.line_disables.setdefault(tok.start[0], set()).update(
                        r.strip() for r in m.group(1).split(","))
        except tokenize.TokenError:
            pass
        self.constants = {}
        for node in self.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                self.constants[node.targets[0].id] = node.value.value

    def disabled(self, rule, line):
        return (rule in self.file_disables
                or rule in self.line_disables.get(line, ()))

    def resolve_str(self, node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return self.constants.get(node.id)
        return None


def _repo_root():
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def module_scope_imports(tree):
    """Import nodes run at import time: the module body, class bodies,
    top-level if/try/with blocks; not function bodies, not ``if
    TYPE_CHECKING:``."""
    def is_type_checking(test):
        return ((isinstance(test, ast.Name) and test.id == "TYPE_CHECKING")
                or (isinstance(test, ast.Attribute)
                    and test.attr == "TYPE_CHECKING"))

    def walk(body):
        for node in body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                yield node
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body)
            elif isinstance(node, ast.If):
                if not is_type_checking(node.test):
                    yield from walk(node.body)
                    yield from walk(node.orelse)
            elif isinstance(node, (ast.Try, ast.With)):
                for blk in (getattr(node, "body", []),
                            getattr(node, "orelse", []),
                            getattr(node, "finalbody", [])):
                    yield from walk(blk)
                for handler in getattr(node, "handlers", []):
                    yield from walk(handler.body)

    yield from walk(tree.body)


def _resolve_imports(nodes, dotted, is_package, known):
    """[(dotted name, lineno)] of import nodes; package-relative
    imports resolve against ``known`` (the package's module map)."""
    parts = dotted.split(".")
    pkg_parts = parts if is_package else parts[:-1]
    edges = []
    for node in nodes:
        if isinstance(node, ast.Import):
            edges.extend((alias.name, node.lineno) for alias in node.names)
            continue
        if node.level == 0:
            base = node.module or ""
        else:
            anchor = pkg_parts[:len(pkg_parts) - (node.level - 1)]
            base = ".".join(anchor + (node.module.split(".")
                                      if node.module else []))
        for alias in node.names:
            sub = f"{base}.{alias.name}"
            edges.append((sub if sub in known else base, node.lineno))
    return edges


class Project:
    """Cross-file facts: the port's metric registry and the package's
    module-scope import graph."""

    def __init__(self, root=None):
        self.root = os.path.abspath(root or _repo_root())
        self._registry = None
        self._graph = None

    @property
    def registry(self):
        """(declared {tpu_* name: constant}, METRICS keys, non-metric
        tokens), read from the port's obs/metric_names.py by AST."""
        if self._registry is None:
            path = os.path.join(self.root, _REGISTRY_REL)
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
            declared, metrics, tokens, consts = {}, set(), set(), {}
            for node in tree.body:
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                name, value = node.targets[0].id, node.value
                if (isinstance(value, ast.Constant)
                        and isinstance(value.value, str)):
                    consts[name] = value.value
                    if METRIC_NAME_RE.match(value.value):
                        declared.setdefault(value.value, name)
                elif name == "METRICS" and isinstance(value, ast.Dict):
                    for key in value.keys:
                        if isinstance(key, ast.Name) and key.id in consts:
                            metrics.add(consts[key.id])
                        elif isinstance(key, ast.Constant):
                            metrics.add(key.value)
                elif name == "NON_METRIC_TOKENS":
                    tokens.update(
                        n.value for n in ast.walk(value)
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str))
            self._registry = (declared, metrics, tokens)
        return self._registry

    @property
    def import_graph(self):
        """module dotted name -> [(imported dotted name, lineno)] over
        the package's module-scope imports."""
        if self._graph is None:
            pkg_dir = os.path.join(self.root, PACKAGE_NAME)
            modules = {}
            for dirpath, dirnames, files in os.walk(pkg_dir):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for name in files:
                    if name.endswith(".py"):
                        path = os.path.join(dirpath, name)
                        dotted = os.path.relpath(path, self.root)[:-3] \
                            .replace(os.sep, ".")
                        if dotted.endswith(".__init__"):
                            dotted = dotted[:-len(".__init__")]
                        modules[dotted] = path
            graph = {}
            for dotted, path in modules.items():
                try:
                    with open(path) as f:
                        tree = ast.parse(f.read(), filename=path)
                except (OSError, SyntaxError):
                    graph[dotted] = []
                    continue
                graph[dotted] = _resolve_imports(
                    module_scope_imports(tree), dotted,
                    path.endswith("__init__.py"), modules)
            self._graph = graph
        return self._graph


def _call_name(node):
    parts, cur = [], node.func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts))


def _rel(ctx):
    return ctx.rel.replace("\\", "/")


class BareEnvReadRule:
    id = "bare-env-read"
    hint = "read it through utils.env_number / utils.env_str"

    def check(self, ctx, project):
        if _rel(ctx).startswith(f"{PACKAGE_NAME}/utils/"):
            return
        for node in ast.walk(ctx.tree):
            name = None
            if isinstance(node, ast.Call) and node.args and _call_name(
                    node) in ("os.environ.get", "environ.get", "os.getenv",
                              "getenv"):
                name = ctx.resolve_str(node.args[0])
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.ctx, ast.Load)
                  and _call_name(ast.Call(func=node.value, args=[],
                                          keywords=[]))
                  in ("os.environ", "environ")):
                name = ctx.resolve_str(node.slice)
            if name and PROJECT_ENV_RE.match(name):
                yield Finding(ctx.rel, node.lineno, self.id,
                              f"raw os.environ read of {name}", self.hint)


class MetricRegistryRule:
    id = "metric-registry"
    hint = "declare the name once in obs/metric_names.py and import it"

    def check(self, ctx, project):
        declared, metrics, tokens = project.registry
        if _rel(ctx) == _REGISTRY_REL:
            seen = {}
            for node in ctx.tree.body:
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)
                        and METRIC_NAME_RE.match(node.value.value)):
                    continue
                value = node.value.value
                if value in seen:
                    yield Finding(ctx.rel, node.lineno, self.id,
                                  f"{value} is declared twice (first as "
                                  f"{seen[value]})", self.hint)
                    continue
                seen[value] = node.targets[0].id
                if value not in metrics:
                    yield Finding(ctx.rel, node.lineno, self.id,
                                  f"{value} is declared without a METRICS "
                                  f"entry", "describe it in METRICS")
            return
        known = set(declared) | tokens
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and METRIC_NAME_RE.match(node.value)):
                continue
            name = node.value
            base, _, suffix = name.rpartition("_")
            if name in known or (suffix in _EXPOSITION and base in known):
                continue
            yield Finding(ctx.rel, node.lineno, self.id,
                          f"tpu_* literal {name!r} is not declared in "
                          "obs/metric_names.py", self.hint)


def _root(name, roots):
    for root in roots:
        if name == root or name.startswith(root + "."):
            return root
    return None


class TorchFreeImportRule:
    id = "torch-free-import"
    hint = ("import torch lazily inside the call that needs it, or move "
            "the torch-bound code out of the torch-free module")

    def _pinned(self, ctx):
        rel = _rel(ctx)
        if rel.startswith(PACKAGE_NAME + "/"):
            inner = rel[len(PACKAGE_NAME) + 1:]
            if inner in TORCH_FREE_MODULES or any(
                    inner.startswith(pkg + "/")
                    for pkg in TORCH_FREE_PACKAGES):
                return True
        return _TORCH_FREE_MARKER in ctx.source

    def check(self, ctx, project):
        if not self._pinned(ctx):
            return
        reported = set()
        for node in module_scope_imports(ctx.tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = _root(name, TORCH_ROOTS)
                if root and root not in reported:
                    reported.add(root)
                    yield Finding(ctx.rel, node.lineno, self.id,
                                  f"module-scope import of {root} in a "
                                  f"torch-free module", self.hint)
        rel = _rel(ctx)
        if not rel.startswith(PACKAGE_NAME + "/"):
            return
        dotted = rel[:-3].replace("/", ".")
        if dotted.endswith(".__init__"):
            dotted = dotted[:-len(".__init__")]
        graph = project.import_graph
        queue, seen = [(dotted, [dotted], None)], {dotted}
        while queue:
            mod, chain, entry = queue.pop(0)
            for dep, lineno in graph.get(mod, ()):
                first = entry if entry is not None else lineno
                root = _root(dep, TORCH_ROOTS)
                if root and mod != dotted:
                    yield Finding(
                        ctx.rel, first, self.id,
                        "torch reaches this torch-free module at import "
                        f"time via {' -> '.join(chain + [root])}",
                        self.hint)
                    return
                if (dep.startswith(PACKAGE_NAME) and dep in graph
                        and dep not in seen):
                    seen.add(dep)
                    queue.append((dep, chain + [dep], first))


class JaxImportRule:
    id = "jax-import"
    hint = ("the port keeps its own copy of what it needs; only tests "
            "import both packages")

    def check(self, ctx, project):
        for node in ast.walk(ctx.tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and node.args
                  and _call_name(node) in ("importlib.import_module",
                                           "import_module", "__import__")):
                target = ctx.resolve_str(node.args[0])
                names = [target] if target else []
            for name in names:
                root = _root(name, JAX_ROOTS)
                if root:
                    yield Finding(ctx.rel, node.lineno, self.id,
                                  f"imports {name} (the JAX side)",
                                  self.hint)
                    break


class LockWithRule:
    """``lock-with``: a lock is held by ``with``, never by a bare
    blocking ``.acquire()`` whose ``release()`` an early return or an
    exception can skip (every later waiter wedges, far from the bug).
    A checked non-blocking probe (``acquire(blocking=False)``,
    ``acquire(timeout=...)``) is fine: only an argument-less
    ``.acquire()`` fires."""

    id = "lock-with"
    hint = ("hold the lock with `with lock:` (or use a checked "
            "non-blocking acquire, released in try/finally)")

    def check(self, ctx, project):
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"
                    and not node.args and not node.keywords):
                yield Finding(ctx.rel, node.lineno, self.id,
                              "bare blocking .acquire() call", self.hint)


def _open_mode(ctx, call):
    for kw in call.keywords:
        if kw.arg == "mode":
            return ctx.resolve_str(kw.value) or ""
    if len(call.args) >= 2:
        return ctx.resolve_str(call.args[1]) or ""
    return "r"


def _mentions_ledger(ctx, call):
    """Whether an argument expression names the ledger statically: a
    string literal holding ``PERF_LEDGER``, or a name bound to one at
    module level."""
    for arg in list(call.args) + [kw.value for kw in call.keywords]:
        for node in ast.walk(arg):
            value = None
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                value = node.value
            elif isinstance(node, ast.Name):
                value = ctx.constants.get(node.id)
            if value and LEDGER_TOKEN in value:
                return True
    return False


class LedgerWriterRule:
    """``ledger-writer``: the port's ledger rows go through its one
    writer, ``perf_ledger.append_row`` (the row schema, the rig
    fingerprint, the ``tpu_perf_ledger_appends`` count). A write-mode
    ``open`` ('w', 'a', 'x', '+'), or a ``replace``/``rename``/
    ``renames``, whose arguments name ``PERF_LEDGER`` statically fires;
    read-only opens are fine, and paths assembled at run time from
    non-literal parts are the rule's blind spot. The writer itself is
    exempt."""

    id = "ledger-writer"
    hint = ("append through perf_ledger.append_row, the one writer that "
            "validates the row schema, stamps the rig fingerprint and "
            "counts the append")

    def check(self, ctx, project):
        if _rel(ctx) == _LEDGER_WRITER_REL:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            tail = (func.id if isinstance(func, ast.Name) else
                    func.attr if isinstance(func, ast.Attribute) else None)
            if tail == "open":
                if not any(c in _open_mode(ctx, node) for c in "wax+"):
                    continue
                if _mentions_ledger(ctx, node):
                    yield Finding(ctx.rel, node.lineno, self.id,
                                  "perf ledger opened for writing outside "
                                  "the shared writer", self.hint)
            elif tail in ("replace", "rename", "renames"):
                if _mentions_ledger(ctx, node):
                    yield Finding(ctx.rel, node.lineno, self.id,
                                  f"{tail}() targets the perf ledger: "
                                  "staged files must land through the "
                                  "shared writer", self.hint)


_RULES = (BareEnvReadRule, MetricRegistryRule, TorchFreeImportRule,
          JaxImportRule, LockWithRule, LedgerWriterRule)


def rule_ids():
    return [cls.id for cls in _RULES]


def iter_source_files(root, paths=None):
    """Sorted .py files of ``paths`` (default: the port package)."""
    out = []
    for p in paths or [PACKAGE_NAME]:
        p = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isdir(p):
            for dirpath, dirnames, files in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                out.extend(os.path.join(dirpath, f) for f in files
                           if f.endswith(".py"))
        elif p.endswith(".py") and os.path.exists(p):
            out.append(p)
    return sorted(set(out))


def run_lint(paths=None, root=None, project=None):
    """Findings over ``paths`` (default: the port package), sorted, the
    escapes applied; a file that does not parse is one
    ``syntax-error`` finding."""
    root = os.path.abspath(root or _repo_root())
    project = project or Project(root)
    rules = [cls() for cls in _RULES]
    findings = []
    for path in iter_source_files(root, paths):
        rel = os.path.relpath(path, root)
        try:
            with open(path) as f:
                ctx = FileContext(path, rel, f.read())
        except (OSError, SyntaxError, ValueError) as e:
            findings.append(Finding(rel, getattr(e, "lineno", 1) or 1,
                                    "syntax-error", str(e)))
            continue
        for rule in rules:
            findings.extend(f for f in rule.check(ctx, project)
                            if not ctx.disabled(f.rule, f.line))
    findings.sort(key=Finding.key)
    return findings


def verify_fixtures(fixture_dir, root=None, project=None):
    """Lint a seeded-violation tree and diff the findings against its
    ``# EXPECT: rule`` comments: (missing, unexpected), both empty when
    every rule fires exactly where the fixtures say. An EXPECT naming
    an unknown rule raises."""
    root = os.path.abspath(root or _repo_root())
    known = set(rule_ids()) | {"syntax-error"}
    expected = set()
    for path in iter_source_files(root, [fixture_dir]):
        rel = os.path.relpath(path, root)
        with open(path) as f:
            for lineno, line in enumerate(f, start=1):
                m = _EXPECT_RE.search(line)
                if m:
                    expected.update((rel, lineno, r.strip())
                                    for r in m.group(1).split(","))
    unknown = sorted(k for k in expected if k[2] not in known)
    if unknown:
        raise ValueError(f"fixture EXPECT names unknown rule(s): {unknown}")
    got = {f.key() for f in run_lint([fixture_dir], root, project)}
    return sorted(expected - got), sorted(got - expected)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("paths", nargs="*",
                   help="files or directories (default: the port package)")
    p.add_argument("--fixtures", default="",
                   help="verify a seeded-violation tree instead")
    args = p.parse_args(argv)
    if args.fixtures:
        missing, unexpected = verify_fixtures(args.fixtures)
        for key in missing:
            print(f"missing: {key}")
        for key in unexpected:
            print(f"unexpected: {key}")
        return 1 if missing or unexpected else 0
    findings = run_lint(args.paths or None)
    for finding in findings:
        print(finding.format())
    print(f"{len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

"""BENCHMARK.json against the format's rules that a file can show:
names, units, the files each entry names, what each metric moves."""

import json
import re

import pytest

from benchmark.lib import spec

from .conftest import ROOT, bench

# Names: a letter, digit or _ first, at most 64 of letters, digits,
# _, . and -; units: 1 to 16 of those, / and %.
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|(_dim|_rank)$|expansion|experts_per_tok")


def valid_name(name):
    return isinstance(name, str) and bool(NAME_RE.match(name))


def valid_unit(unit):
    return isinstance(unit, str) and bool(UNIT_RE.match(unit))


def test_names_and_units():
    b = bench()
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert valid_name(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert valid_unit(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert valid_name(w["traffic"]) and valid_name(w["config"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("name,ok", [
    ("sc2-7b.codegen", True), ("_x", True), ("9a", True),
    ("a b", False), ("a,b", False), ("a/b", False), ("-a", False),
    ("a" * 65, False), ("µs", False), ("", False)])
def test_name_rule(name, ok):
    assert valid_name(name) is ok


@pytest.mark.parametrize("unit,ok", [
    ("tokens/s", True), ("%", True), ("ms", True), ("us", True),
    ("tokens per second", False), ("µs", False), ("a" * 17, False)])
def test_unit_rule(unit, ok):
    assert valid_unit(unit) is ok


def test_every_named_file_exists():
    b = bench()
    assert b["paths"] == ["benchmark"]
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["name"] == c["name"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.limits and cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])


def test_bounds_and_run_length():
    b = bench()
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, cells // 4)

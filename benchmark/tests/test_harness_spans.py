"""The readers of the program's nested spans on hand-built span lists:
device time under each decode step, the live-key share, the admission's
wall time, and the training window's last steps (``lib/spans.py``)."""

import itertools

import pytest

from benchmark.lib import spans, spec

_ids = itertools.count(1)


def _span(name, parent=None, device_s=None, duration_s=0.1, **attrs):
    return {"name": name, "span_id": next(_ids),
            "parent_id": parent["span_id"] if parent else None,
            "start_unix": 0.0, "duration_s": duration_s,
            "device_s": device_s, "attrs": attrs}


def _decode_window():
    out = []
    for layer_s in ((0.01, 0.02), (0.03, 0.04)):
        step = _span("serving.engine_step")
        fwd = _span("engine.forward", step, 0.2, keys_attended=1000,
                    keys_live=100)
        out += [step, fwd] + [_span("model.attention", fwd, s)
                              for s in layer_s]
    # An admission's attention, and a span not yet resolved, count for
    # no step.
    pre = _span("serving.prefill", phase="engine_admission",
                duration_s=0.2)
    chunk = _span("engine.prefill_forward", pre, 0.15, keys_attended=300,
                  keys_live=30)
    out += [pre, chunk, _span("model.attention", chunk, 0.5),
            _span("model.attention", out[1], None),
            _span("serving.prefill", phase="engine_replay", duration_s=9.0),
            _span("serving.prefill", phase="engine_admission",
                  duration_s=0.4)]
    return out


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_serving_readers_on_hand_built_spans():
    ctx = {"window": {"spans": _decode_window()}}
    # (0.01 + 0.02 + 0.03 + 0.04) s over two steps.
    assert _read("attention_ms.codegen", ctx) == pytest.approx(50.0)
    # engine.forward only: the admission's chunk is not a decode step.
    assert _read("live_key_share.codegen", ctx) == pytest.approx(10.0)
    # Admissions only, replays left out.
    assert _read("prefill_ms.codegen", ctx) == pytest.approx(300.0)


def test_serving_readers_find_nothing_in_a_program_without_them():
    """A program whose spans carry no device time or counts (the
    parent's: ``serving.engine_step`` and ``serving.prefill`` only)."""
    old = [{"name": "serving.engine_step", "span_id": 1, "parent_id": None,
            "start_unix": 0.0, "duration_s": 0.2, "attrs": {}}]
    ctx = {"window": {"spans": old}}
    assert _read("attention_ms.codegen", ctx) is None
    assert _read("live_key_share.codegen", ctx) is None
    assert _read("prefill_ms.codegen", ctx) is None
    assert _read("attention_ms.codegen", {}) is None


class _Tracer:
    def __init__(self, records):
        self.records = records

    def snapshot(self):
        return {"spans": list(self.records)}


def _train_steps(forward_s):
    out = []
    for f in forward_s:
        step = _span("train.step_run", duration_s=0.3)
        out += [step, _span("train.forward", step, f),
                _span("train.backward", step, 2 * f),
                # A second micro-batch's pair adds to the step.
                _span("train.forward", step, f),
                _span("train.backward", step, 2 * f),
                _span("train.update", step, 0.03)]
    return out


def test_training_readers_take_the_last_steps(monkeypatch):
    from container_engine_accelerators_tpu_torch import obs
    # Two set-up steps, far slower, then the window's three.
    records = _train_steps([1.0, 1.0, 0.05, 0.06, 0.07])
    records.append(_span("train.step_compile"))
    monkeypatch.setattr(obs, "TRACER", _Tracer(records))
    ctx = {"steps": 3}
    found = spans.training_spans(ctx)
    steps = [s for s in found if s["name"] == "train.step_run"]
    assert steps == [s for s in records
                     if s["name"] == "train.step_run"][-3:]
    assert len(found) == 3 + 3 * 5
    assert _read("forward_ms.train", ctx) == pytest.approx(120.0)
    assert _read("backward_ms.train", ctx) == pytest.approx(240.0)
    assert _read("update_ms.train", ctx) == pytest.approx(30.0)
    # More steps asked than the tracer holds, or none: nothing to read.
    for ctx in ({"steps": 6}, {"steps": 0}, {}):
        assert spans.training_spans(ctx) is None
        assert _read("update_ms.train", ctx) is None


def test_training_readers_find_nothing_without_child_spans(monkeypatch):
    """The parent's trainer: ``train.step_run`` with no children."""
    from container_engine_accelerators_tpu_torch import obs
    records = [_span("train.step_run") for _ in range(4)]
    monkeypatch.setattr(obs, "TRACER", _Tracer(records))
    for name in ("forward_ms.train", "backward_ms.train", "update_ms.train"):
        assert _read(name, {"steps": 4}) is None

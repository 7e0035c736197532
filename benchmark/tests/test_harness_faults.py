"""The rest of a run, with the look for a card skipped, on the CPU at a
tiny size: a sound program comes out correct, and each fault the cells
can have, planted in the timed path, comes out not correct under the
cells' own limits."""

import numpy as np
import pytest

from benchmark import run as bench_run

PORT = "container_engine_accelerators_tpu_torch"


def _execute(cell, args):
    result, _ = bench_run.execute(cell, args, "cpu")
    return result


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_sound_serving_run_is_correct(tiny_cell, run_args, loop):
    result = _execute(tiny_cell("serve", loop), run_args())
    assert result["correct"], result["compared"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"output_tokens_per_s", "setup_s"}


def test_slots_span_the_whole_context(tiny_cell):
    """The server's slots hold the configuration's whole context, not
    only the traffic's longest request."""
    from benchmark.lib import serve
    cell = tiny_cell("serve")
    session = serve.Session(cell, 11, "cpu", trace=False)
    try:
        assert session.server.engine.slot_len == (
            cell.config["max_position_embeddings"])
    finally:
        session.stop()


def _break_serving(monkeypatch, fault):
    from container_engine_accelerators_tpu_torch.models import (
        decode, transformer)
    if fault == "token":
        step = decode.SlotDecodeEngine.step

        def altered(self):
            out = step(self)
            if out is not None:
                out[0][:] = (out[0] + 1) % self._model.vocab_size
            return out
        monkeypatch.setattr(decode.SlotDecodeEngine, "step", altered)
    elif fault == "state":
        monkeypatch.setattr(transformer, "_paged_write",
                            lambda *a, **k: None)
    else:
        logits_of = decode.logits_of

        def half(outputs):
            raw = logits_of(outputs).clone()
            rows = raw.shape[0]
            if rows > 1:
                raw[rows // 2:] = raw[:rows - rows // 2]
            return raw
        monkeypatch.setattr(decode, "logits_of", half)


@pytest.mark.parametrize("fault", ["token", "state", "half"])
def test_serving_faults_are_not_correct(tiny_cell, run_args, monkeypatch,
                                        fault):
    _break_serving(monkeypatch, fault)
    result = _execute(tiny_cell("serve"), run_args())
    assert not result["correct"], (fault, result["compared"])


def test_sound_training_run_is_correct(tiny_cell, run_args):
    result = _execute(tiny_cell("train"), run_args())
    assert result["correct"], result["compared"]
    assert result["failed"] == 0
    assert result["metrics"]["train_tokens_per_s"]["value"] > 0


def _break_training(monkeypatch, fault):
    from container_engine_accelerators_tpu_torch.models import transformer
    from container_engine_accelerators_tpu_torch.parallel import train
    if fault == "frozen":
        monkeypatch.setattr(train.Sgd, "update", lambda *a, **k: None)
    else:
        make = transformer.next_token_loss_fn

        def half_batch(loss):
            inner = make(loss)

            def loss_fn(logits, tokens):
                keep = max(1, tokens.shape[0] // 2)
                return inner(logits[:keep], tokens[:keep])
            return loss_fn
        monkeypatch.setattr(transformer, "next_token_loss_fn", half_batch)


@pytest.mark.parametrize("fault", ["frozen", "half"])
def test_training_faults_are_not_correct(tiny_cell, run_args, monkeypatch,
                                         fault):
    _break_training(monkeypatch, fault)
    result = _execute(tiny_cell("train"), run_args())
    assert not result["correct"], (fault, result["compared"])
    numbers = {k: v["value"] for k, v in result["compared"].items()}
    if fault == "frozen":
        assert np.isclose(numbers["change_gap"], 1.0)

"""The per-layer readers on a window's context (the CPU run has no
device trace: the device readers find nothing and return nothing,
never 0)."""

import pytest

from benchmark.lib import serve, spec, train

from .conftest import bench

DEVICE = ("device_idle_share", "attention_roofline", "xent_roofline")


def _readers(cell_name):
    return {m["name"]: spec.metric_reader(m["name"])
            for m in bench()["per_layer"] if cell_name in m["workloads"]}


def test_serving_readers(tiny_cell, run_args):
    out = serve.run(tiny_cell("serve"), run_args(), "cpu")
    for name, read in _readers("sc2-7b.codegen").items():
        value = read(out["ctx"])
        if name.startswith(DEVICE):
            assert value is None, name
        else:
            assert value is not None and value > 0, name
    assert out["ctx"]["window"]["spans"]


def test_training_readers(tiny_cell, run_args):
    out = train.run(tiny_cell("train"), run_args(), "cpu")
    for name, read in _readers("sc2-3b.pretrain-4k").items():
        value = read(out["ctx"])
        if name.startswith(DEVICE):
            assert value is None, name
        else:
            assert 0 < value < 100, name


def test_lost_captures_are_dropped():
    from benchmark.lib import devtrace
    kept = {"busy_s": 1.5, "window_s": 2.0, "kernels": {"k": [1.5, 3]},
            "gaps": {"engine / launch": 0.5}}
    out = devtrace.summarize([None, kept, dict(kept, busy_s=0.5)])
    assert out["captures"] == [2, 3]
    assert out["busy_s"] == 2.0 and out["window_s"] == 4.0
    assert out["device_ops"] == [["k", 3.0]]
    assert out["idle_gaps"] == [["engine / launch", 1.0]]
    # No capture kept must not read as an idle card.
    with pytest.raises(RuntimeError):
        devtrace.summarize([None, None])


def test_traced_readers_read_what_follows_the_capture():
    """A traced window's per-layer readers see the spans and requests
    after the capture's end, over that part's own seconds."""
    win = {"open": 100.0, "close": 150.0, "seconds": 50.0,
           "read_from": 108.5, "unix": 1000.0,
           "spans": [{"name": "serving.engine_step", "start_unix": t,
                      "duration_s": d}
                     for t, d in ((1101.0, 0.5), (1109.0, 0.1),
                                  (1140.0, 0.3))],
           "records": [], "requests": []}
    part = serve.untraced_part(win)
    assert part["open"] == 108.5 and part["seconds"] == 41.5
    assert [s["start_unix"] for s in part["spans"]] == [1109.0, 1140.0]
    ctx = {"window": part}
    assert spec.metric_reader("engine_step_ms.codegen")(ctx) == (
        pytest.approx(200.0))
    # An untraced window is read whole.
    assert serve.untraced_part(dict(win, read_from=100.0)) == dict(
        win, read_from=100.0)


@pytest.mark.parametrize("name,module", [
    ("device_idle_share.codegen", "device_idle_share"),
    ("device_idle_share.train", "device_idle_share"),
    ("train_mfu", "train_mfu"),
    ("attention_roofline.train", "attention_roofline")])
def test_a_cell_suffix_shares_one_reader(name, module):
    read = spec.metric_reader(name)
    assert read.__module__ == "benchmark_metric_" + name.replace(".", "_")
    assert read.__code__.co_filename.endswith(f"metrics/{module}.py")


def test_engine_timeline_finds_the_longest_pause():
    spans = [{"name": "serving.engine_step", "start_unix": t,
              "duration_s": 0.2} for t in (10.0, 10.2, 10.4, 13.0)]
    spans.append({"name": "serving.prefill", "start_unix": 10.6,
                  "duration_s": 0.4})
    spans.append({"name": "serving.request", "start_unix": 11.0,
                  "duration_s": 5.0})
    out = serve.engine_timeline({"spans": spans})
    assert out["steps"] == 4 and out["prefills"] == 1
    assert out["steps_s"] == pytest.approx(0.8)
    assert out["prefills_s"] == pytest.approx(0.4)
    assert out["longest_pause_s"] == pytest.approx(2.0)

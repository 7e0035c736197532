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

"""The port's fleet front door as a deployment runs it: the router,
collector, launcher, observer and router_check import without torch
(the front door keeps routing while every backend is wedged); the
launcher spawns port engines, routes a stream through them and stops
on SIGTERM; the observer serves the fleet view the HPA scales on; and
chip_smoke.py registers its fleet phase with kernel #1 on its path."""

import importlib.util
import inspect
import json
import os
import signal
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from container_engine_accelerators_tpu_torch.obs.trace import Tracer
from container_engine_accelerators_tpu_torch.serving import (
    fleet_observer,
    serve_fleet,
)
from tests.test_torch_fleet_collector import FakeFleet, make_collector

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "container_engine_accelerators_tpu_torch"
FRONT_DOOR = ("serving.router", "obs.fleet", "serving.serve_fleet",
              "serving.fleet_observer", "router_check")


def test_front_door_imports_without_torch():
    """A fresh interpreter imports the front door's modules; neither
    torch, jax nor any module of the JAX package is loaded."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO_ROOT!r})\n"
        f"for m in {FRONT_DOOR!r}:\n"
        f"    importlib.import_module({PORT!r} + '.' + m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'jax', 'jaxlib', 'flax',\n"
        "              'container_engine_accelerators_tpu'))\n"
        "assert not bad, bad\n"
        "print('TORCH-FREE')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "TORCH-FREE" in proc.stdout


def test_launchers_default_to_the_card():
    assert serve_fleet.build_parser().parse_args(
        ["--spawn", "2"]).device == "cuda"
    args = fleet_observer.build_parser().parse_args(["http://e0"])
    assert args.port == 8570 and not args.once
    with pytest.raises(SystemExit):
        serve_fleet.main(["--spawn", "1", "http://e0"])   # not both


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_serve_fleet_spawns_routes_and_stops():
    """``serve_fleet --spawn 2 --device cpu``: two fleet_worker engines
    from one seed behind the router; a stream through the front door,
    /fleet/stats with both engines steerable, and SIGTERM stops the
    router and its workers."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{PORT}.serving.serve_fleet", "--spawn",
         "2", "--device", "cpu", "--port", "0", "--poll-ms", "200"],
        cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        hello = json.loads(proc.stdout.readline())
        assert set(hello) == {"port", "engines", "poll_ms"}
        assert len(hello["engines"]) == 2 and hello["poll_ms"] == 200.0
        base = f"http://127.0.0.1:{hello['port']}"
        req = urllib.request.Request(
            base + "/v1/models/lm:generate",
            data=json.dumps({"prompts": [[1, 2, 3, 4, 5]],
                             "max_new_tokens": 6,
                             "stream": True}).encode())
        with urllib.request.urlopen(req, timeout=60) as resp:
            lines = [json.loads(x) for x in resp.read().splitlines()]
        assert lines[-1] == {"done": True}
        assert sum(len(x.get("tokens", [])) for x in lines) == 6
        status, body = _get(base + "/fleet/stats")
        assert status == 200
        assert sorted(json.loads(body)["steer_set"]) \
            == sorted(hello["engines"])
        assert _get(base + "/readyz")[0] == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        for url in hello["engines"]:
            with pytest.raises(OSError):
                urllib.request.urlopen(url + "/healthz", timeout=5)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_observer_serves_the_fleet_view():
    fleet = FakeFleet()
    fleet.hist(fleet.urls[0]).observe(0.05)
    fleet.engines[fleet.urls[1]]["ready"] = False
    collector = make_collector(fleet, Tracer(enabled=True))
    server = fleet_observer.ObserverServer(collector, port=0)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert _get(base + fleet_observer.FLEET_STATS_PATH)[0] == 503
        collector.poll_once()
        status, body = _get(base + fleet_observer.FLEET_STATS_PATH)
        view = json.loads(body)
        assert status == 200
        assert view["steer_set"] == [fleet.urls[0], fleet.urls[2]]
        assert view["counts"] == {"up": 3, "down": 0, "unready": 1}
        assert view["desired_replicas"] == 1
        health = json.loads(_get(base + "/healthz")[1])
        assert health["engines"] == fleet.urls and health["polls"] == 1
        assert _get(base + "/nope")[0] == 404
    finally:
        server.stop()


def test_observer_once_prints_the_rollup(capsys):
    """``--once`` against engines that refuse: one poll cycle, the
    rollup on stdout, every engine failing its poll."""
    assert fleet_observer.main(["--once", "http://127.0.0.1:9",
                                "--poll-ms", "100"]) == 0
    view = json.loads(capsys.readouterr().out)
    assert view["steer_set"] == [] and view["polls"] == 1
    assert view["engines"][0]["failures"] == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO_ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_registers_the_fleet_phase():
    """Phase 12 is driven from main, its launch record is the "fleet"
    path, and that path must launch kernel #1 (flash_fwd, the dense
    engine's admission prefill)."""
    cs = _chip_smoke()
    assert cs.PATH_KERNELS["fleet"] == ("flash_fwd",)
    main = inspect.getsource(cs.main)
    assert "start_fleet_engines()" in main and "drive_fleet(" in main
    assert "fleet_launches.items()" in main
    drive = inspect.getsource(cs.drive_fleet)
    assert 'return report, {"fleet": {"flash_fwd": b_launches}}' in drive
    # A on the paged pool as deploy/fleet/engine.yaml runs it, B dense.
    start = inspect.getsource(cs.start_fleet_engines)
    assert '("B", {"CEA_TPU_PAGED_KV": "0"})' in start
    assert "--warm" in start
    # The flash kernel's wrapper is the counted name the record uses.
    from container_engine_accelerators_tpu_torch.ops import attention
    assert attention.flash_fwd.name == "flash_fwd"

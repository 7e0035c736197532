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

"""Fleet front door: router + collector over N engine servers.

    # Front EXISTING engines (the production shape, deploy/fleet/
    # router.yaml; torch is never imported in this process):
    python -m container_engine_accelerators_tpu_torch.serving.serve_fleet \\
        --port 8600 http://engine-a:8500 http://engine-b:8500

    # Or spawn a local fleet of N tiny-model engines (serving.fleet_worker
    # processes, all from one model seed; torch only in the workers):
    python -m container_engine_accelerators_tpu_torch.serving.serve_fleet \\
        --port 8600 --spawn 2 --device cpu

One process runs the torch-free pair: an ``obs.fleet.FleetCollector``
polling the engines' /stats /metrics /readyz surfaces, and a
``serving.router.RouterServer`` placing requests by prefix affinity
with least-loaded fallback, tenant token-rate fairness, fleet-wide
shedding with saturation-derived Retry-After, and mid-stream failover
splicing. Once serving it prints ``{"port", "engines", "poll_ms"}`` as
one JSON line on stdout; SIGTERM or SIGINT stops it (and the workers
it spawned).

Front-door surfaces: the engines' ``POST /v1/models/<m>:generate``
contract (proxied), plus /healthz /readyz /stats /metrics
/fleet/stats, /debug/requests and the obs debug pages. Router knobs:
``CEA_TPU_ROUTER_*``; the affinity block size follows the engines'
``CEA_TPU_KV_BLOCK``.
"""

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

from .. import obs
from ..obs.fleet import FleetCollector
from .router import RouterCore, RouterServer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER = "container_engine_accelerators_tpu_torch.serving.fleet_worker"


def spawn_workers(count, seed, device, tmpdir, timeout_s=600.0):
    """``count`` fleet_worker engines, ALL from one model seed (shared
    weights are what make a cross-engine failover splice
    token-identical); returns (processes, base URLs) once every worker
    has written its port file."""
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    procs = []
    for i in range(count):
        port_file = os.path.join(tmpdir, f"engine{i}.port")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", WORKER, "--port-file", port_file,
             "--seed", str(seed), "--device", device],
            cwd=REPO_ROOT, env=env), port_file))
    urls = []
    deadline = time.monotonic() + timeout_s
    try:
        for proc, port_file in procs:
            while not os.path.exists(port_file):
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"engine worker exited rc {proc.returncode} "
                        f"before serving")
                if time.monotonic() > deadline:
                    raise RuntimeError("timed out warming engine fleet")
                time.sleep(0.2)
            with open(port_file) as f:
                urls.append(f"http://127.0.0.1:{int(f.read().strip())}")
    except BaseException:
        stop_workers([p for p, _ in procs])
        raise
    return [p for p, _ in procs], urls


def stop_workers(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("urls", nargs="*", metavar="ENGINE_URL",
                   help="existing engine base URLs to front")
    p.add_argument("--spawn", type=int, default=0, metavar="N",
                   help="spawn N local fleet_worker engines instead of "
                        "fronting existing URLs")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the spawned workers' device")
    p.add_argument("--port", type=int, default=8600,
                   help="router listen port (0 = ephemeral; the "
                        "chosen port is printed as JSON on stdout)")
    p.add_argument("--poll-ms", type=float, default=None,
                   help="collector poll interval (default "
                        "CEA_TPU_FLEET_POLL_MS or 1000)")
    p.add_argument("--model-seed", type=int, default=0,
                   help="the spawned fleet's model seed (one seed for "
                        "ALL engines: failover replay depends on "
                        "shared weights)")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if bool(args.urls) == bool(args.spawn):
        p.error("give engine URLs or --spawn N (exactly one)")

    obs.set_role("router")
    procs, urls = [], args.urls
    if args.spawn:
        procs, urls = spawn_workers(
            args.spawn, args.model_seed, args.device,
            tempfile.mkdtemp(prefix="serve_fleet_"))
    try:
        collector = FleetCollector(urls, poll_ms=args.poll_ms)
        core = RouterCore(collector)
        server = RouterServer(core, collector, port=args.port)
        collector.start()
        server.start()
        print(json.dumps({"port": server.port, "engines": urls,
                          "poll_ms": collector.poll_ms}), flush=True)
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        stop.wait()
        server.stop()
        collector.stop()
    finally:
        stop_workers(procs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

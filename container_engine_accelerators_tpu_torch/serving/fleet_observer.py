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

"""Fleet observer daemon: one process watching N engine servers.

    python -m container_engine_accelerators_tpu_torch.serving.fleet_observer \\
        http://engine-a:8500 http://engine-b:8500 --port 8570

Runs obs.fleet.FleetCollector's poll loop over the engines' surfaces
(/stats, /metrics, /readyz, /debug/requests) and serves the fleet view
back out:

  /metrics       Prometheus exposition: every ``tpu_fleet_*`` series
                 (liveness counts, cause-wise saturation, burn rates,
                 desired_replicas, the exact-merged TTFT/TPOT
                 histograms); the scrape target the HPA of
                 deploy/fleet/hpa.yaml scales on;
  /fleet/stats   the JSON rollup: per-engine snapshots, steer_set /
                 least_loaded (the router contract), merged p50/p99s,
                 slo_burn windows, desired_replicas;
  /healthz       observer liveness (+ poll/engine counts);
  /debug/trace, /debug/varz
                 the observer's own journal: fleet.engine_down /
                 fleet.engine_recovered / fleet.slo_burn episode
                 events live here.

Torch-free: watching a fleet must not wedge on a backend. ``--once``
runs a single poll cycle and prints the rollup. Knobs:
CEA_TPU_FLEET_POLL_MS, CEA_TPU_FLEET_STALE_MS and the burn/scale envs
(obs/fleet.py).
"""

import argparse
import json
import signal
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import obs
from ..obs.fleet import FleetCollector

FLEET_STATS_PATH = "/fleet/stats"


class ObserverServer:
    """HTTP read surface over a FleetCollector."""

    def __init__(self, collector, port=0):
        self._collector = collector

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, status, ctype, body):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                debug = obs.debug_response(obs.get_tracer(), path,
                                           query)
                if debug is not None:
                    ctype, body = debug
                    self._send(200, ctype, body)
                elif path == "/metrics":
                    self._send(
                        200, "text/plain; version=0.0.4",
                        obs.prometheus_text(
                            obs.get_tracer()).encode())
                elif path == FLEET_STATS_PATH:
                    view = collector.view()
                    if view is None:
                        self._send(503, "application/json",
                                   b'{"error": "no poll cycle '
                                   b'completed yet"}')
                    else:
                        self._send(200, "application/json",
                                   obs.dump_json(view.to_dict()))
                elif path == "/healthz":
                    overhead = collector.overhead()
                    self._send(200, "application/json", obs.dump_json(
                        {"status": "ok",
                         "engines": list(collector.urls),
                         "polls": overhead["polls"]}))
                else:
                    self._send(404, "application/json",
                               b'{"error": "not found"}')

        self._httpd = ThreadingHTTPServer(("", port), Handler)
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-http",
            daemon=True)
        self._thread.start()

    def stop(self):
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread = None
        self._httpd.server_close()


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("urls", nargs="+", metavar="ENGINE_URL",
                   help="engine base URLs (http://host:port)")
    p.add_argument("--port", type=int, default=8570,
                   help="observer listen port (0 = ephemeral; the "
                        "chosen port is printed as JSON on stdout)")
    p.add_argument("--poll-ms", type=float, default=None,
                   help="poll interval (default CEA_TPU_FLEET_POLL_MS"
                        " or 1000)")
    p.add_argument("--once", action="store_true",
                   help="one poll cycle, print the /fleet/stats "
                        "rollup, exit")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    obs.set_role("fleet")
    collector = FleetCollector(args.urls, poll_ms=args.poll_ms)
    if args.once:
        view = collector.poll_once()
        print(json.dumps(view.to_dict()))
        return 0

    server = ObserverServer(collector, port=args.port)
    collector.start()
    server.start()
    print(json.dumps({"port": server.port,
                      "engines": collector.urls,
                      "poll_ms": collector.poll_ms}), flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    server.stop()
    collector.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

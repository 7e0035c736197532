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

"""A JAX engine for tests/test_torch_fleet.py: the JAX package's
GenerationServer ("lm", warmed up, on the CPU) on the weights the
port's fleet worker serves (``init_flax_layout_params(config,
--seed)``, a numpy tree in the flax layout), with the port worker's
flags and port-file and signal behaviour (tools/serve_fleet.py's worker
makes its weights with flax's own init, so it cannot serve the same
tokens).

    python tests/torch_fleet_worker.py --port-file F --seed 0 ...
"""

import os
import signal
import sys
import threading

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)


def main(argv=None):
    import jax.numpy as jnp

    from container_engine_accelerators_tpu.models import TransformerLM
    from container_engine_accelerators_tpu.serving import (
        GenerationServer,
    )
    from container_engine_accelerators_tpu_torch.models.convert import (
        init_flax_layout_params,
    )
    from container_engine_accelerators_tpu_torch.serving import (
        fleet_worker,
    )

    args = fleet_worker.build_parser().parse_args(argv)
    config = fleet_worker.config_of(args)
    model = TransformerLM(dtype=jnp.float32, **config)
    srv = GenerationServer("lm", model,
                           init_flax_layout_params(config, args.seed),
                           port=0, max_new_tokens=args.max_new_tokens,
                           max_batch=args.max_batch, warm=True)
    srv.start()
    stop = threading.Event()
    signal.signal(signal.SIGUSR1, lambda *_: srv.begin_drain())
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    tmp = args.port_file + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(srv.port))
    os.replace(tmp, args.port_file)
    stop.wait()
    srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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

"""Times the bf16 flash forward, dQ and dK/dV of a checkout of the port
on the card, so two checkouts can be compared inside one run:

    python3 container_engine_accelerators_tpu_torch/flash_bench.py \\
        --root DIR --label NAME

imports the package found in DIR (default: the checkout this file is
in), builds its kernels, and prints one JSON line a shape: each
kernel's device time by CUDA-graph replay (``*_graph_ms``), its time
launched back to back (``*_launch_ms``, which the host's launch cost
bounds at small shapes), SDPA's forward by graph and SDPA's whole
backward (dQ, dK and dV together; no PyTorch call computes dQ alone)
by graph where the card's torch captures it, else by events over 50
calls (``sdpa_bwd_timing`` says which). SDPA takes the causal flag,
or the window band as a boolean mask. Run it by path, one process per
checkout (the packages share one name): for example the parent
unpacked by ``git archive`` into a git-ignored directory, then this
checkout, in turns.
"""

import argparse
import json
import os
import sys

# (shape, window) at the paths' shapes: the training slice causal and
# with the W 512 band, the serving prefill's buckets, the demo draft's
# D 16, D 128, and GPT-J-6B's attention at D 256 causal and with the
# W 512 band.
SHAPES = [((8, 2048, 8, 64), 0), ((8, 2048, 8, 64), 512),
          ((1, 1920, 8, 64), 0), ((1, 128, 8, 64), 0), ((1, 16, 8, 64), 0),
          ((1, 1920, 8, 16), 0), ((4, 1024, 8, 128), 0),
          ((4, 2048, 16, 256), 0), ((4, 2048, 16, 256), 512)]


def main(argv=None):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=here)
    parser.add_argument("--label", default="")
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.ops import _build
    from container_engine_accelerators_tpu_torch.ops import attention as attn
    if not _build.__file__.startswith(root + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all(["flash_fwd", "flash_bwd"])

    def launch_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def graph_ms(fn, iters=20, reps=5):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    def sdpa_bwd(q, k, v, do, mask):
        """(ms, timing) of SDPA's backward: by graph, else by events
        over 50 calls."""
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, **mask)
        grad = do.transpose(1, 2)

        def bwd():
            return torch.autograd.grad(out, (qt, kt, vt), grad,
                                       retain_graph=True)
        # torch 2.11 cannot capture it at [8, 2048, 8, 64] causal (the
        # capture is invalidated); it can at the other shapes.
        try:
            return graph_ms(bwd), "graph"
        except RuntimeError as err:
            print(f"flash_bench: SDPA backward not captured ({err}); "
                  "timed by events", file=sys.stderr)
            torch.cuda.synchronize()
            return launch_ms(bwd, 50), "events"

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, window in SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        o, lse = attn.flash_fwd(q, k, v, True, window)
        delta = (do.float() * o.float()).sum(-1)
        mask = (dict(attn_mask=attn._keep_mask(shape[1], window, "cuda"))
                if window else dict(is_causal=True))

        def fwd():
            return attn.flash_fwd.launch(q, k, v, True, window)

        def dq():
            return attn.flash_bwd_dq.launch(q, k, v, do, lse, delta, True,
                                            window)

        def dkv():
            return attn.flash_bwd_dkv.launch(q, k, v, do, lse, delta, True,
                                             window)

        row = dict(label=args.label, shape=list(shape), window=window)
        for name, fn in (("fwd", fwd), ("dq", dq), ("dkv", dkv)):
            row[f"{name}_graph_ms"] = graph_ms(fn)
            row[f"{name}_launch_ms"] = launch_ms(fn)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_graph_ms"] = graph_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, **mask))
        row["sdpa_bwd_ms"], row["sdpa_bwd_timing"] = sdpa_bwd(q, k, v, do,
                                                              mask)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

"""HTTP LM generation server on the dense slot engine.

Counterpart of the JAX package's ``GenerationServer`` for its
non-streaming JSON contract:

  POST /v1/models/<name>:generate
    {"prompts": [[ids...], ...], "max_new_tokens": N,
     "temperature": T, "top_k": K, "top_p": P, "min_p": M,
     "repetition_penalty": R, "eos_id": E, "logprobs": bool}
    -> {"sequences": [[...], ...][, "logprobs": [[...], ...]]}
  GET /healthz, GET /stats, GET /v1/models/<name>

Prompts of one request share a length and are right-padded into a
fixed set of length buckets. One loop thread owns the engine: at every
step boundary it retires rows at EOS or their token budget, admits
queued rows into free slots (each admission is one batch-1 prefill
through the flash kernel) and runs one decode step over all slots.
Streaming, drain and quarantine, tracing, the tokenizer, prefix serving
and speculation are not ported yet; a request asking for streaming or
text gets a 400 that says so.
"""

import collections
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..models.decode import EngineCapacityError, SlotDecodeEngine
from ..ops.attention import flash_fwd

log = logging.getLogger(__name__)


class _Work:
    """One request row through the engine: queued -> admitted (first
    token from the admission prefill) -> stepped -> retired."""

    __slots__ = ("row", "p_len", "new", "temperature", "top_k", "top_p",
                 "min_p", "rep_pen", "eos_id", "want_lp", "seed", "done",
                 "slot", "tokens", "lps", "score_only", "submit_t")

    def __init__(self, row, p_len, new, temperature, top_k, top_p,
                 min_p, rep_pen, eos_id, want_lp, seed):
        self.row = row
        self.p_len = p_len
        self.new = new
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_p = min_p
        self.rep_pen = rep_pen
        self.eos_id = eos_id
        self.want_lp = want_lp
        self.seed = seed
        self.done = queue.Queue(maxsize=1)
        self.slot = None
        self.tokens = []
        self.lps = []
        self.score_only = new == 0
        self.submit_t = time.perf_counter()


class _EngineService:
    """The continuous-batching loop: one background thread owns the
    SlotDecodeEngine (single-threaded by contract). ``max_queue``
    bounds submitted-but-unretired rows; past it submissions shed."""

    def __init__(self, engine, max_queue):
        self._engine = engine
        self._max_queue = max_queue
        self._queue = queue.Queue()
        self._pending = []
        self._slot_work = {}
        self._lock = threading.Lock()
        self._inflight = 0
        self._admitted = 0
        self._retired = 0
        self._tokens = 0
        self._ttft_s = collections.deque(maxlen=4096)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="engine-loop", daemon=True)
        self._thread.start()

    def submit_many(self, works):
        """Queue rows; False (nothing queued) when over budget."""
        with self._lock:
            if self._stop.is_set() or (
                    self._inflight + len(works) > self._max_queue):
                return False
            self._inflight += len(works)
        for work in works:
            self._queue.put(work)
        return True

    def stats(self):
        eng = self._engine
        with self._lock:
            ttft = sorted(self._ttft_s)
            return {
                "slots_active": eng.active_count(),
                "slots_free": eng.free_slots(),
                "queue_depth": self._queue.qsize() + len(self._pending),
                "requests_admitted": self._admitted,
                "retired": self._retired,
                "tokens_generated": self._tokens,
                "engine_steps": eng.steps,
                "engine_prefills": eng.prefills,
                "batch_occupancy_avg": eng.occupancy_avg(),
                "ttft_p50_ms": (1e3 * ttft[len(ttft) // 2]
                                if ttft else None),
            }

    def stop(self):
        with self._lock:
            self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            # Its rows still belong to the loop: finishing them here
            # could finish a row twice.
            log.error("engine loop did not stop within 30 s")
            return
        leftovers = self._pending + list(self._slot_work.values())
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                leftovers.append(item)
        for work in leftovers:
            self._finish(work, error="server stopped")
        self._pending.clear()

    def _finish(self, work, error=None):
        if work.slot is not None:
            self._engine.release(work.slot)
            self._slot_work.pop(work.slot, None)
            work.slot = None
        with self._lock:
            self._inflight -= 1
            self._retired += 1
        if error is not None:
            work.done.put(("error", error))
            return
        # The [p_len + new] sequence, EOS-padded past an early stop
        # like the fixed-horizon decode; the logprob row alongside.
        pad = work.new - len(work.tokens)
        fill = work.eos_id if work.eos_id >= 0 else 0
        seq = np.concatenate([np.asarray(work.row[:work.p_len], np.int64),
                              np.asarray(work.tokens + [fill] * pad,
                                         np.int64)])
        lps = np.concatenate([np.asarray(work.lps, np.float32),
                              np.zeros((pad,), np.float32)])
        work.done.put(("ok", (seq, lps)))

    def _deliver(self, work, tok, lp):
        work.tokens.append(tok)
        if work.want_lp:
            work.lps.append(lp)
        if len(work.tokens) == 1:
            ttft = time.perf_counter() - work.submit_t
            with self._lock:
                self._ttft_s.append(ttft)
        with self._lock:
            self._tokens += 1
        if (work.eos_id >= 0 and tok == work.eos_id) or (
                len(work.tokens) >= work.new):
            self._finish(work)

    def _admit(self, work):
        eng = self._engine
        try:
            if work.score_only:
                echo = eng.score(work.row, work.p_len)
                work.lps = list(echo[:work.p_len])
                with self._lock:
                    self._admitted += 1
                self._finish(work)
                return
            slot, first, first_lp, echo = eng.admit(
                work.row, work.p_len, temperature=work.temperature,
                top_k=work.top_k, top_p=work.top_p, min_p=work.min_p,
                repetition_penalty=work.rep_pen, seed=work.seed)
        except EngineCapacityError:
            self._pending.insert(0, work)
            return
        except Exception as e:  # device/runtime failure: fail the row
            log.exception("engine admission failed")
            self._finish(work, error=str(e))
            return
        work.slot = slot
        self._slot_work[slot] = work
        with self._lock:
            self._admitted += 1
        if work.want_lp:
            work.lps = list(echo[:work.p_len])
        self._deliver(work, first, first_lp)

    def _loop(self):
        while not self._stop.is_set():
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._pending.append(item)
            if not self._pending and not self._slot_work:
                try:
                    item = self._queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item is not None:
                    self._pending.append(item)
                continue  # drain any burst before admitting
            # FIFO admission into free slots (scoring rows need none).
            while self._pending and (self._pending[0].score_only
                                     or self._engine.free_slots()):
                self._admit(self._pending.pop(0))
            if not self._slot_work:
                continue
            try:
                out = self._engine.step()
            except Exception as e:  # device/runtime failure
                log.exception("engine step failed")
                for work in list(self._slot_work.values()):
                    self._finish(work, error=str(e))
                continue
            if out is None:
                continue
            toks, lps = out
            for slot, work in list(self._slot_work.items()):
                self._deliver(work, int(toks[slot]), float(lps[slot]))


class GenerationServer:
    """HTTP server for LM generation on the dense slot engine (see the
    module docstring for the contract). The model is the port's
    TransformerLM on its device; the engine's slot_len covers the
    largest bucket plus ``max_new_tokens``."""

    def __init__(self, model_name, model, port=8500, max_new_tokens=64,
                 max_batch=8, buckets=None, max_queue=None, host=""):
        self._name = model_name
        self._model = model
        self._max_new = max_new_tokens
        self._max_batch = max_batch
        max_prompt = model.max_seq_len - max_new_tokens
        if max_prompt < 1:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} leaves no room for a "
                f"prompt within max_seq_len {model.max_seq_len}")
        if buckets is None:
            buckets, b = [], 16
            while b < max_prompt:
                buckets.append(b)
                b *= 2
            buckets.append(max_prompt)
        self._buckets = sorted(
            {b for b in buckets if 1 <= b <= max_prompt})
        if not self._buckets:
            raise ValueError("no valid prompt-length buckets")
        self._engine = SlotDecodeEngine(
            model, max_batch, self._buckets[-1] + max_new_tokens,
            paged=False, buckets=self._buckets)
        self._service = _EngineService(
            self._engine, 8 * max_batch if max_queue is None else max_queue)
        self._seed = 0
        self._requests = 0
        self._shed = 0
        self._stats_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._handler_class())
        self._http_thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def engine(self):
        return self._engine

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok",
                                      "model": server._name})
                elif self.path == "/stats":
                    self._reply(200, server.stats())
                elif self.path == f"/v1/models/{server._name}":
                    self._reply(200, {"model_version_status": [{
                        "version": "1", "state": "AVAILABLE",
                        "status": {"error_code": "OK",
                                   "error_message": ""},
                        "metadata": server._model_metadata()}]})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path != f"/v1/models/{server._name}:generate":
                    self._reply(404, {"error": "unknown model"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    payload = json.loads(self.rfile.read(length))
                except (ValueError, TypeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    code, resp = server._handle_post(payload)
                except (KeyError, TypeError, ValueError) as e:
                    code, resp = 400, {"error": f"bad request: {e}"}
                except Exception as e:  # model/runtime failure
                    log.exception("POST handler failed")
                    code, resp = 500, {"error": str(e)}
                if code == 200:
                    with server._stats_lock:
                        server._requests += 1
                self._reply(code, resp)

        return Handler

    def _model_metadata(self):
        return {"kind": "generate",
                "vocab_size": self._model.vocab_size,
                "max_prompt_len": self._buckets[-1],
                "prompt_buckets": self._buckets,
                "max_new_tokens": self._max_new,
                "max_batch": self._max_batch}

    def stats(self):
        with self._stats_lock:
            out = {"requests": self._requests, "shed": self._shed}
        out.update(self._service.stats())
        out["kv_pool"] = "dense"
        out["flash_fwd_launches"] = flash_fwd.launches
        out["device"] = str(self._engine.device)
        return out

    def _handle_post(self, payload):
        """Validate one request (the JAX server's rules and 400
        messages) and run it on the engine. Returns (code, body)."""
        try:
            if payload.get("text") is not None:
                return 400, {"error": "server has no tokenizer; "
                                      "send token id prompts"}
            prompts = payload["prompts"]
            new = int(payload.get("max_new_tokens", self._max_new))
            temperature = float(payload.get("temperature", 0.0))
            top_k = int(payload.get("top_k", 0))
            top_p = float(payload.get("top_p", 1.0))
            eos_id = int(payload.get("eos_id", -1))
            rep_pen = float(payload.get("repetition_penalty", 1.0))
            min_p = float(payload.get("min_p", 0.0))
            want_lp = bool(payload.get("logprobs", False))
            stream = bool(payload.get("stream", False))
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"error": f"bad request: {e}"}
        if stream:
            return 400, {"error": "stream is not yet ported to the "
                                  "PyTorch server"}
        vocab = self._model.vocab_size
        if not -1 <= eos_id < vocab:
            return 400, {"error": f"eos_id must be -1 (off) or in "
                                  f"0..{vocab - 1}"}
        if not 0 <= top_k <= vocab:
            return 400, {"error": f"top_k must be in 0..{vocab}"}
        if not 0.0 <= temperature <= 1e6:
            return 400, {"error": "temperature must be in [0, 1e6]"}
        if not 0.0 < top_p <= 1.0:
            return 400, {"error": "top_p must be in (0, 1]"}
        if not 0.0 < rep_pen <= 100.0:
            return 400, {"error": "repetition_penalty must be in "
                                  "(0, 100]"}
        if not 0.0 <= min_p < 1.0:
            return 400, {"error": "min_p must be in [0, 1)"}
        if (top_k or top_p < 1.0 or min_p > 0.0) and temperature <= 0.0:
            return 400, {"error": "top_k/top_p/min_p require "
                                  "temperature > 0"}
        if not prompts or len(prompts) > self._max_batch:
            return 400, {"error": f"need 1..{self._max_batch} prompts"}
        if len({len(p) for p in prompts}) != 1:
            return 400, {"error": "prompts must share one length"}
        if new == 0 and not want_lp:
            return 400, {"error": "max_new_tokens 0 (scoring mode) "
                                  "requires logprobs: true"}
        if new < 0 or new > self._max_new:
            return 400, {"error": f"max_new_tokens must be in "
                                  f"0..{self._max_new}"}
        try:
            arr = np.asarray(prompts, dtype=np.int32)
        except (ValueError, TypeError) as e:
            return 400, {"error": f"bad prompt tokens: {e}"}
        if arr.ndim != 2 or arr.shape[1] < 1:
            return 400, {"error": "prompts must be non-empty id lists"}
        if arr.min() < 0 or arr.max() >= vocab:
            return 400, {"error": f"token ids must be in 0..{vocab - 1}"}
        p_len = arr.shape[1]
        bucket = next((b for b in self._buckets if b >= p_len), None)
        if bucket is None:
            return 400, {"error": f"prompt length {p_len} exceeds "
                                  f"max {self._buckets[-1]}"}
        padded = np.zeros((arr.shape[0], bucket), np.int32)
        padded[:, :p_len] = arr
        with self._stats_lock:
            seed = self._seed + 1
            self._seed += len(padded)
        works = [_Work(row, p_len, new, temperature, top_k, top_p, min_p,
                       rep_pen, eos_id, want_lp, seed + i)
                 for i, row in enumerate(padded)]
        if not self._service.submit_many(works):
            with self._stats_lock:
                self._shed += 1
            return 503, {"error": "server overloaded; retry"}
        rows = []
        for work in works:
            try:
                status, out = work.done.get(timeout=600)
            except queue.Empty:
                return 500, {"error": "decode timed out"}
            if status != "ok":
                return 500, {"error": out}
            rows.append(out)
        resp = {"sequences": [seq[:p_len + new].tolist()
                              for seq, _ in rows]}
        if want_lp:
            resp["logprobs"] = [[round(float(x), 6)
                                 for x in lps[:p_len + new]]
                                for _, lps in rows]
        return 200, resp

    def serve_forever(self):
        log.info("serving model %r on :%d", self._name, self.port)
        self._httpd.serve_forever()

    def shutdown(self):
        """End a running ``serve_forever`` (from another thread)."""
        self._httpd.shutdown()

    def start(self):
        """Serve on a background thread (tests, smoke runs)."""
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http",
            daemon=True)
        self._http_thread.start()

    def stop(self):
        if self._http_thread is not None:
            self._httpd.shutdown()
            self._http_thread.join(timeout=30)
        self._httpd.server_close()
        self._service.stop()

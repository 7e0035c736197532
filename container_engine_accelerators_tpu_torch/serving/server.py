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

"""HTTP LM generation server on the slot engine.

Counterpart of the JAX package's engine-mode ``GenerationServer``:

  POST /v1/models/<name>:generate
    {"prompts": [[ids...], ...] | "text": ["...", ...],
     "max_new_tokens": N, "temperature": T, "top_k": K, "top_p": P,
     "min_p": M, "repetition_penalty": R, "eos_id": E,
     "logprobs": bool, "stream": bool}
    -> {"sequences": [[...], ...][, "logprobs": [[...], ...]]
        [, "completions": ["...", ...]]}
    or, with "stream": true, ndjson lines {"tokens": [t]
    (, "completion_delta": "...")} then {"done": true} or the error
    envelope {"error", "retryable", "request_id"}
  GET /healthz (503 {"status": "warming"} until warm-up is done),
  GET /stats, GET /v1/models/<name>

Prompts of one request share a length and are right-padded into a
fixed set of length buckets. One loop thread owns the engine: at every
step boundary it retires rows at EOS or their token budget, admits
queued rows in FIFO order while the engine has room for the head
(``admission_block_cause``: a free slot, and on the paged pool the
blocks of the row's worst-case span), and runs one decode step over
all slots. The engine's pool is the JAX server's: paged unless
``CEA_TPU_PAGED_KV=0`` selects the dense pool, whose admission prefill
runs the flash kernel.

With a ``tokenizer`` requests may carry text (ragged rows, each with
its own prompt length) and responses gain the decoded generated region,
trimmed at ``eos_id``. ``warm=True`` sends one warm row per bucket
through the engine (the admission prefill of each width and the step,
so the first use of every kernel, its build included, and the library
set-up happen before traffic), drops them from the counters and only
then lets /healthz answer 200; a failed warm-up leaves the server
unready. A stream is one prompt whose tokens reach the client as each
step lands; a client that leaves cancels its row, which the loop
retires at the next step boundary.

With a ``draft_model`` and ``speculative_k`` >= 2 the engine speculates
(``models/decode.py``): greedy rows without a repetition penalty draft
k-1 tokens a step and commit 1..k of them, every other row takes the
single-token lane of the same step. A step then delivers
``counts[slot]`` tokens to each row, in order, and stops at the one
that retires it (EOS or budget), for streams too; /stats adds the
speculation counters. ``speculative_k`` 1 proposes nothing, so it
builds the draft-free engine. Drain and quarantine, tracing and
server-level prefix serving (``prefix_tokens``) are not ported yet.
"""

import collections
import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..models.decode import EngineCapacityError, SlotDecodeEngine
from ..models.speculative import check_spec_models
from ..ops.attention import flash_fwd

log = logging.getLogger(__name__)


class _StreamBody:
    """Iterator over a streaming response that owns its row: ``close``
    cancels the row exactly once however far iteration got (a
    generator never iterated runs no ``finally`` on close), and the
    HTTP handler calls it in its own ``finally``."""

    def __init__(self, gen, release, request_id):
        self._gen = gen
        self._release = release
        self._released = False
        self.request_id = request_id

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        try:
            self._gen.close()
        finally:
            if not self._released:
                self._released = True
                self._release()


class _Work:
    """One request row through the engine: queued -> admitted (first
    token from the admission prefill) -> stepped -> retired (EOS,
    budget or cancel). A streamed row reports each token on
    ``stream_q``; a warm row (``account=False``) stays out of the
    latency and token counters, and ``no_prefix`` keeps it out of the
    prefix index."""

    __slots__ = ("row", "p_len", "new", "temperature", "top_k", "top_p",
                 "min_p", "rep_pen", "eos_id", "want_lp", "seed", "done",
                 "slot", "tokens", "lps", "score_only", "submit_t",
                 "stream_q", "cancel", "account", "no_prefix",
                 "request_id")

    def __init__(self, row, p_len, new, temperature, top_k, top_p,
                 min_p, rep_pen, eos_id, want_lp, seed, stream_q=None,
                 account=True, no_prefix=False):
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
        self.stream_q = stream_q
        self.done = queue.Queue(maxsize=1) if stream_q is None else None
        self.cancel = threading.Event()
        self.account = account
        self.no_prefix = no_prefix
        self.request_id = uuid.uuid4().hex[:12]
        self.slot = None
        self.tokens = []
        self.lps = []
        self.score_only = new == 0
        self.submit_t = time.perf_counter()


def _stream_lines(work, decode_text, eos_id):
    """The ndjson lines of a streamed row: {"tokens": [t]} per step
    (with "completion_delta", the token decoded, empty at eos_id, for a
    text request), then {"done": true}, or the error envelope
    {"error", "retryable", "request_id"} in place of the rest."""
    while True:
        try:
            item = work.stream_q.get(timeout=120)
        except queue.Empty:
            yield {"error": "decode timed out", "retryable": True,
                   "request_id": work.request_id}
            return
        if item[0] == "tok":
            tok = item[1]
            line = {"tokens": [tok]}
            if decode_text is not None:
                line["completion_delta"] = decode_text(
                    [] if eos_id >= 0 and tok == eos_id else [tok])
            yield line
        elif item[0] == "end":
            yield {"done": True}
            return
        else:
            yield {"error": item[1], "retryable": bool(item[2]),
                   "request_id": work.request_id}
            return


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
            # The paged pool's block and prefix-sharing counters are
            # host integers the loop thread updates; absent on the
            # dense pool.
            return {
                **(eng.kv_block_stats() or {}),
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
                # Speculation (every engine has the counters; they move
                # only with a draft). The acceptance rate is the share
                # of proposals committed; accepted_tokens_per_step the
                # tokens a drafting row commits a step (>= 1).
                "spec_steps": eng.spec_steps,
                "spec_proposed_tokens": eng.spec_proposed,
                "spec_accepted_tokens": eng.spec_accepted,
                "draft_prefills": eng.draft_prefills,
                "speculative_acceptance_rate": (
                    round(eng.spec_accepted / eng.spec_proposed, 4)
                    if eng.spec_proposed else None),
                "accepted_tokens_per_step": (
                    round((eng.spec_accepted + eng.spec_row_steps)
                          / eng.spec_row_steps, 3)
                    if eng.spec_row_steps else None),
            }

    def reset_counters(self):
        """Drop warm-up's rows from the counters /stats reads: the
        engine's steps, prefills, prefix and speculation counters (warm
        rows draft: their acceptance is not the traffic's), and the
        service's admissions, retirements, tokens and first-token
        latencies."""
        eng = self._engine
        with self._lock:
            eng.steps = 0
            eng.row_steps = 0
            eng.prefills = 0
            eng.spec_steps = 0
            eng.spec_row_steps = 0
            eng.spec_proposed = 0
            eng.spec_accepted = 0
            eng.draft_prefills = 0
            eng.reset_prefix_counters()
            self._admitted = 0
            self._retired = 0
            self._tokens = 0
            self._ttft_s.clear()

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
            self._finish(work, error="server stopped", retryable=True)
        self._pending.clear()

    def _finish(self, work, error=None, retryable=False):
        if work.slot is not None:
            self._engine.release(work.slot)
            self._slot_work.pop(work.slot, None)
            work.slot = None
        with self._lock:
            self._inflight -= 1
            self._retired += 1
        if work.stream_q is not None:
            # A stream ends with its done line or its error envelope,
            # whose retryable flag tells a recovering service from a
            # permanent failure.
            work.stream_q.put(("error", error, retryable) if error
                              else ("end",))
            return
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
        if work.account:
            with self._lock:
                if len(work.tokens) == 1:
                    self._ttft_s.append(time.perf_counter() - work.submit_t)
                self._tokens += 1
        if work.stream_q is not None:
            work.stream_q.put(("tok", tok))
        if (work.eos_id >= 0 and tok == work.eos_id) or (
                len(work.tokens) >= work.new):
            self._finish(work)

    @staticmethod
    def _allow_prefix(work):
        """Whether a row may share and register prompt-prefix blocks:
        not a row that echoes logprobs (a shared span's echo is never
        computed), nor a warm row."""
        return not (work.want_lp or work.no_prefix)

    def _admit(self, work):
        """Admit one row (or score it). False when the engine had no
        room after all: the row goes back to the head of the queue."""
        eng = self._engine
        try:
            if work.score_only:
                echo = eng.score(work.row, work.p_len)
                work.lps = list(echo[:work.p_len])
                with self._lock:
                    self._admitted += 1
                self._finish(work)
                return True
            slot, first, first_lp, echo = eng.admit(
                work.row, work.p_len, temperature=work.temperature,
                top_k=work.top_k, top_p=work.top_p, min_p=work.min_p,
                repetition_penalty=work.rep_pen, seed=work.seed,
                max_new=work.new, allow_prefix=self._allow_prefix(work))
        except EngineCapacityError:
            self._pending.insert(0, work)
            return False
        except Exception as e:  # device/runtime failure: fail the row
            log.exception("engine admission failed")
            self._finish(work, error=str(e))
            return True
        work.slot = slot
        self._slot_work[slot] = work
        with self._lock:
            self._admitted += 1
        if work.want_lp:
            work.lps = list(echo[:work.p_len])
        self._deliver(work, first, first_lp)
        return True

    def _loop(self):
        while not self._stop.is_set():
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._pending.append(item)
            # A client that left while queued gives its place back now
            # and is never prefilled.
            cancelled = [w for w in self._pending if w.cancel.is_set()]
            if cancelled:
                self._pending[:] = [w for w in self._pending
                                    if not w.cancel.is_set()]
                for work in cancelled:
                    self._finish(work, error="cancelled")
            if not self._pending and not self._slot_work:
                try:
                    item = self._queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item is not None:
                    self._pending.append(item)
                continue  # drain any burst before admitting
            # Cancelled streams retire first: their slots admit queued
            # rows at this boundary.
            for work in list(self._slot_work.values()):
                if work.cancel.is_set():
                    self._finish(work, error="cancelled")
            # FIFO admission: the head waits rather than letting later
            # small requests starve a big one. Scoring rows need no slot
            # and no blocks.
            while self._pending:
                head = self._pending[0]
                if not head.score_only and (
                        self._engine.admission_block_cause(
                            head.row, head.p_len, head.new,
                            allow_prefix=self._allow_prefix(head),
                            repetition_penalty=head.rep_pen,
                            temperature=head.temperature) is not None):
                    break
                if not self._admit(self._pending.pop(0)):
                    break
            if not self._slot_work:
                if self._pending:
                    # The head is blocked with nothing active: only a
                    # stop can change that, so wait instead of spinning.
                    self._stop.wait(0.05)
                continue
            try:
                out = self._engine.step()
            except Exception as e:  # device/runtime failure
                log.exception("engine step failed")
                for work in list(self._slot_work.values()):
                    self._finish(work, error=str(e))
                # The failed step may have torn mid-flight (write blocks
                # allocated, positions not advanced): audit the pool
                # and reclaim before serving on, so a torn pool does
                # not shrink every later admission.
                leaks = self._engine.pool_leak_report()
                if leaks:
                    log.error("pool invariants violated after step "
                              "failure: %s; force-reclaiming", leaks)
                    residue = self._engine.force_reclaim()
                    if residue:
                        log.error("force_reclaim residue: %s (arena "
                                  "capacity lost)", residue)
                continue
            if out is None:
                continue
            if len(out) == 2:   # one token a row
                out = (out[0][:, None], out[1][:, None],
                       np.ones(len(out[0]), np.int64))
            # A speculative step commits counts[slot] tokens a row;
            # delivery stops where the row retires (_finish clears
            # work.slot), the engine's surplus dying with the slot.
            toks, lps, counts = out
            for slot, work in list(self._slot_work.items()):
                for j in range(int(counts[slot])):
                    self._deliver(work, int(toks[slot, j]),
                                  float(lps[slot, j]))
                    if work.slot is None:
                        break


class GenerationServer:
    """HTTP server for LM generation on the slot engine (see the module
    docstring for the contract). The model is the port's TransformerLM
    on its device; the engine's slot_len covers the largest bucket plus
    ``max_new_tokens``, and ``CEA_TPU_PAGED_KV`` picks its pool.
    ``tokenizer``: a text codec (``serving.tokenizer``) whose vocab
    fits the model's. ``warm``: warm up before /healthz answers 200, in
    the constructor or, with ``warm_async``, on a background thread;
    ``warm_filters`` (sampling-option dicts) are accepted and ignored
    as in the JAX server, since every sampling variant runs the same
    kernels as the warm rows. ``draft_model`` (the port's TransformerLM,
    with its own weights) and ``speculative_k``: speculation in the
    engine, checked here (``check_spec_models``) so a replica refuses
    to build on a configuration it cannot serve."""

    def __init__(self, model_name, model, port=8500, max_new_tokens=64,
                 max_batch=8, buckets=None, max_queue=None, host="",
                 tokenizer=None, warm=False, warm_async=False,
                 warm_filters=None, draft_model=None, speculative_k=0):
        self._spec_k = int(speculative_k)
        if self._spec_k:
            if self._spec_k < 1:
                raise ValueError(
                    f"speculative_k must be >= 1: {speculative_k}")
            if draft_model is None:
                raise ValueError("speculative_k requires draft_model")
            check_spec_models(model, draft_model)
        if (tokenizer is not None
                and tokenizer.vocab_size > model.vocab_size):
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} exceeds "
                f"model vocab {model.vocab_size}")
        self._tokenizer = tokenizer
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
        # k 1 proposes no token a step: the draft-free engine.
        engine_spec_k = self._spec_k if self._spec_k >= 2 else 0
        self._engine = SlotDecodeEngine(
            model, max_batch, self._buckets[-1] + max_new_tokens,
            buckets=self._buckets,
            draft_model=draft_model if engine_spec_k else None,
            spec_k=engine_spec_k)
        self._service = _EngineService(
            self._engine, 8 * max_batch if max_queue is None else max_queue)
        self._seed = 0
        self._requests = 0
        self._shed = 0
        self._stats_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._handler_class())
        self._http_thread = None
        self._ready = threading.Event()
        self._ready.set()
        del warm_filters  # accepted and ignored, as in the JAX server
        self.warm_seconds = None
        if warm:
            self._ready.clear()
            if warm_async:
                threading.Thread(target=self._warm_in_background,
                                 name="serving-warmup", daemon=True).start()
            else:
                try:
                    self._warm_up()
                except BaseException:
                    self._httpd.server_close()
                    self._service.stop()
                    raise

    def _warm_in_background(self):
        try:
            self._warm_up()
        except Exception:
            # Stay unready: the readiness probe keeps traffic away and
            # the startup probe restarts the replica.
            log.exception("warm-up failed; server stays unready")

    def _warm_up(self):
        """One greedy warm row per bucket (zeros, no prefix sharing,
        two new tokens where max_new_tokens allows, speculative_k with a
        draft so the row's span holds a verify chunk): each width's
        admission prefill (the draft's too) and the decode step (the
        draft step and the verify chunk) run once before traffic. Then
        the counters drop the warm rows and /healthz turns 200."""
        t0 = time.perf_counter()
        warm_new = min(max(2, self._spec_k), self._max_new)
        for b in self._buckets:
            work = _Work(np.zeros((b,), np.int32), b, warm_new, 0.0, 0,
                         1.0, 0.0, 1.0, -1, False, 0, account=False,
                         no_prefix=True)
            if not self._service.submit_many([work]):
                raise RuntimeError("warm-up shed by admission control")
            status, out = work.done.get(timeout=600)
            if status != "ok":
                raise RuntimeError(f"warm-up decode failed: {out}")
        self._service.reset_counters()
        self.warm_seconds = time.perf_counter() - t0
        self._ready.set()
        log.info("warm-up complete: %d buckets in %.2f s",
                 len(self._buckets), self.warm_seconds)

    @property
    def ready(self):
        return self._ready.is_set()

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

            def _stream(self, body):
                """ndjson, one line per item; HTTP/1.0 and the closed
                connection frame the body. A failure of the stream
                machinery itself ends with a final error line; close()
                cancels the row however the stream ended (a client
                that left shows as a failed write)."""
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.end_headers()
                    for item in body:
                        self.wfile.write((json.dumps(item) + "\n").encode())
                        self.wfile.flush()
                except Exception as e:  # client gone or stream broken
                    log.info("stream ended early: %r", e)
                    try:
                        self.wfile.write((json.dumps(
                            {"error": str(e), "retryable": False,
                             "request_id": body.request_id}) + "\n"
                        ).encode())
                    except OSError:
                        pass  # the client went away
                finally:
                    body.close()

            def do_GET(self):
                if self.path == "/healthz":
                    if server._ready.is_set():
                        self._reply(200, {"status": "ok",
                                          "model": server._name})
                    else:
                        self._reply(503, {"status": "warming",
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
                if isinstance(resp, _StreamBody):
                    self._stream(resp)
                else:
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
        out["kv_pool"] = "paged" if self._engine.paged else "dense"
        out["flash_fwd_launches"] = flash_fwd.launches
        out["device"] = str(self._engine.device)
        return out

    def _handle_post(self, payload):
        """Validate one request (the JAX server's rules, order and 400
        messages) and run it on the engine. Returns (code, body); a
        stream's body is a ``_StreamBody``."""
        try:
            texts = payload.get("text")
            if texts is not None:
                if self._tokenizer is None:
                    return 400, {"error": "server has no tokenizer; "
                                          "send token id prompts"}
                if "prompts" in payload:
                    return 400, {"error": "send text or prompts, "
                                          "not both"}
                if (not isinstance(texts, list)
                        or not all(isinstance(t, str) for t in texts)):
                    return 400, {"error": "text must be a list of "
                                          "strings"}
                prompts = [self._tokenizer.encode(t) for t in texts]
                if any(not p for p in prompts):
                    return 400, {"error": "text rows must encode to "
                                          "at least one token"}
                payload = dict(payload, prompts=prompts)
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
        if stream and (want_lp or rep_pen != 1.0):
            return 400, {"error": "stream does not support logprobs "
                                  "or repetition_penalty"}
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
        if texts is None and len({len(p) for p in prompts}) != 1:
            return 400, {"error": "prompts must share one length"}
        if new == 0 and not want_lp:
            return 400, {"error": "max_new_tokens 0 (scoring mode) "
                                  "requires logprobs: true"}
        if new < 0 or new > self._max_new:
            return 400, {"error": f"max_new_tokens must be in "
                                  f"0..{self._max_new}"}
        try:
            if texts is not None:
                # Text rows may be ragged: right-padded to the widest,
                # each with its own prompt length.
                width = max(len(p) for p in prompts)
                arr = np.zeros((len(prompts), width), np.int32)
                for r, p in enumerate(prompts):
                    arr[r, :len(p)] = np.asarray(p, np.int32)
                p_lens = [len(p) for p in prompts]
            else:
                arr = np.asarray(prompts, dtype=np.int32)
                p_lens = [arr.shape[1]] * arr.shape[0]
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
        if stream:
            return self._stream_post(padded[0], p_lens, new, temperature,
                                     top_k, top_p, min_p, eos_id, seed,
                                     texts)
        works = [_Work(row, pl, new, temperature, top_k, top_p, min_p,
                       rep_pen, eos_id, want_lp, seed + i)
                 for i, (row, pl) in enumerate(zip(padded, p_lens))]
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
        resp = {"sequences": [seq[:pl + new].tolist()
                              for (seq, _), pl in zip(rows, p_lens)]}
        if want_lp:
            resp["logprobs"] = [[round(float(x), 6) for x in lps[:pl + new]]
                                for (_, lps), pl in zip(rows, p_lens)]
        if texts is not None:
            # The decoded generated region, trimmed at eos_id.
            comps = []
            for (seq, _), pl in zip(rows, p_lens):
                ids = seq[pl:pl + new].tolist()
                if eos_id >= 0 and eos_id in ids:
                    ids = ids[:ids.index(eos_id)]
                comps.append(self._tokenizer.decode(ids))
            resp["completions"] = comps
        return 200, resp

    def _stream_post(self, row, p_lens, new, temperature, top_k, top_p,
                     min_p, eos_id, seed, texts):
        """One streamed row: queue it and hand back the ndjson body,
        whose close cancels the row."""
        if len(p_lens) != 1:
            return 400, {"error": "stream requires exactly one prompt"}
        if new < 1:
            return 400, {"error": "stream requires max_new_tokens >= 1"}
        work = _Work(row, p_lens[0], new, temperature, top_k, top_p, min_p,
                     1.0, eos_id, False, seed, stream_q=queue.Queue())
        if not self._service.submit_many([work]):
            with self._stats_lock:
                self._shed += 1
            return 503, {"error": "server overloaded; retry"}
        decode_text = self._tokenizer.decode if texts is not None else None
        return 200, _StreamBody(_stream_lines(work, decode_text, eos_id),
                                work.cancel.set, work.request_id)

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

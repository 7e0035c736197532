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

"""Fleet-router gate for the port's front door.

    python -m container_engine_accelerators_tpu_torch.router_check \\
        [--fast] [--device cuda|cpu]

Starts N tiny port engines (``serving.fleet_worker`` processes on
``--device``, ONE model seed so cross-engine replay is
token-identical), fronts them with the port's torch-free
``serving.router`` stack in this process, and holds the scale-out
contracts end to end over real HTTP:

  1. **goodput scales**: one mixed Poisson trace (prefix-heavy plus
     unaffiliated traffic) replayed through the front door against 1
     engine and against N engines must shrink the row-work makespan,
     ``max`` over engines of the ``rows_decoded`` delta, by >= 3.2x at
     N=4 (>= 1.6x at the --fast N=2). Decoded-row work is the
     rig-independent goodput unit: shared-nothing engines decode
     concurrently in a deployment, so the most-loaded engine is the
     finish line.
  2. **affinity holds the hit rate**: the fleet-wide prefix hit rate
     under router placement must stay within 10 points of the
     single-engine baseline on an identical-shape trace, while a
     round-robin control on a third identical-shape trace falls
     below the affinity rate.
  3. **mid-stream failover**: SIGKILL the affinity engine while
     greedy streams are mid-flight; every stream must still deliver
     the EXACT token tail a surviving engine produces for its full
     prompt, and ``tpu_router_failover_total`` must move.
  4. **request journeys hold across the chaos**: every chaos stream
     (sent with its own ``x-cea-request-id``) must retire exactly ONE
     router journey record whose buckets sum to its wall within 1%,
     carrying ONE trace id that the surviving engines' own
     ``serving.request`` spans and ledger records share; a spliced
     journey bills ``splice_resubmit`` time, and the router section
     of :func:`analyze` names a nonzero router tax.
  5. **no leaks on survivors**: after the kill every surviving engine
     quiesces to slots_active=0, queue_depth=0,
     kv_blocks_free=kv_blocks_total, kv_blocks_shared=0.
  6. **fleet-wide shed**: draining every survivor (SIGUSR1) empties
     the steer set; the router must answer new work 503 with a
     Retry-After derived from the engines' own recovery horizons, and
     its /readyz must go 503.

Prints one JSON summary line with ``router_goodput_scale``,
``router_affinity_hit_rate`` and ``router_overhead_ms`` (the mean
router-tax milliseconds a splice-free journey: placement plus
bookkeeping, the cost of fronting), and on the card the
``nvidia-smi`` name and power limit. Exits 0 when every contract
holds, 1 when one fails, 2 when the rig broke.
"""

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request

from . import obs
from .obs.fleet import FleetCollector
from .serving.affinity import affinity_key
from .serving.router import RouterCore, RouterServer

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = "container_engine_accelerators_tpu_torch.serving.fleet_worker"

# The whole gate runs on a tiny block size so 8-token prefixes span
# two FULL blocks: the worker env pins CEA_TPU_KV_BLOCK=4 and the
# harness passes block_size=4 explicitly.
BLOCK = 4
PREFIX_LEN = 2 * BLOCK
STREAM_NEW = 24          # == the workers' max_new_tokens budget

# The router's journey vocabulary and the part of it the router itself
# owns (upstream_ttfb and stream are engine + relay time).
ROUTER_TAX_BUCKETS = ("router_queue", "fairness_wait",
                      "shed_backoff", "splice_resubmit", "other")
SUM_TOLERANCE = 0.01
# Absolute floor under the relative sum-to-wall tolerance: records
# round to microseconds, so a sub-millisecond request's rounding
# residue must not read as a violation.
SUM_ABS_FLOOR_S = 2e-5


# ---------------------------------------------------------------------------
# The router section of the SLO report
# ---------------------------------------------------------------------------


def _is_router_record(record):
    """Router journeys carry the router vocabulary; ``router_queue``
    is its fingerprint (engine records never hold it)."""
    return "router_queue" in (record.get("buckets") or {})


def _ms(seconds):
    return round(seconds * 1e3, 3) if seconds is not None else None


def analyze(records):
    """The router section and the sum-to-wall audit over retired
    records (router journeys and engine records may arrive mixed; the
    audit checks each against its own bucket keys)."""
    out = {"requests": len(records)}
    journeys = [r for r in records if _is_router_record(r)]
    if journeys:
        wall_total = sum(r["wall_s"] for r in journeys)
        tax_buckets = {}
        for b in ROUTER_TAX_BUCKETS:
            total = sum((r["buckets"].get(b) or 0.0) for r in journeys)
            tax_buckets[b] = {
                "total_s": round(total, 6),
                "share_of_wall": (round(total / wall_total, 4)
                                  if wall_total else None),
            }
        tax_total = sum(v["total_s"] for v in tax_buckets.values())
        out["router"] = {"requests": len(journeys), "tax": {
            "total_s": round(tax_total, 6),
            "share_of_wall": (round(tax_total / wall_total, 4)
                              if wall_total else None),
            "mean_ms_per_request": _ms(tax_total / len(journeys)),
            "buckets": tax_buckets,
        }}
    violations = []
    for i, r in enumerate(records):
        total = sum(r["buckets"].get(b) or 0.0 for b in r["buckets"])
        if abs(total - r["wall_s"]) > max(SUM_TOLERANCE * r["wall_s"],
                                          SUM_ABS_FLOOR_S):
            violations.append({"index": i, "wall_s": r["wall_s"],
                               "bucket_sum_s": round(total, 6)})
    out["sum_to_wall"] = {"checked": len(records),
                          "violations": violations}
    return out


# ---------------------------------------------------------------------------
# Harness helpers
# ---------------------------------------------------------------------------


class HarnessError(Exception):
    """The rig broke (worker died, timeout), not the contract."""


def spawn_worker(idx, tmpdir, log, device):
    port_file = os.path.join(tmpdir, f"engine{idx}.port")
    # ONE model seed for every engine: shared weights are what makes
    # cross-engine greedy replay token-identical (leg 3). max_queue 0
    # (unbounded admission): the gate measures the ROUTER's placement
    # and shedding, so the engines must not add their own sheds.
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, CEA_TPU_TRACE="1",
               CEA_TPU_KV_BLOCK=str(BLOCK), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", WORKER, "--port-file", port_file,
         "--seed", "0", "--device", device, "--max-queue", "0",
         "--max-new-tokens", str(STREAM_NEW), "--max-batch", "4"],
        cwd=REPO_ROOT, stdout=log, stderr=log, env=env)
    return proc, port_file


def wait_for_port(proc, port_file, deadline):
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise HarnessError(
                f"engine worker exited rc {proc.returncode} before "
                f"serving (see worker log)")
        if os.path.exists(port_file):
            with open(port_file) as f:
                return int(f.read().strip())
        time.sleep(0.2)
    raise HarnessError("timed out waiting for engine workers to warm")


def http_get(url, timeout=10):
    """(status, headers, body) with HTTP errors as answers."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers or {}), e.read()


def post_json(url, payload, timeout=120):
    """(status, headers, parsed-json-body) with HTTP errors as
    answers."""
    req = urllib.request.Request(
        url + "/v1/models/lm:generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), \
                json.loads(resp.read())
    except urllib.error.HTTPError as e:
        body = e.read()
        try:
            detail = json.loads(body)
        except ValueError:
            detail = {"error": body.decode("replace")}
        return e.code, dict(e.headers or {}), detail


def fetch_json(url):
    status, _, body = http_get(url)
    if status != 200:
        raise HarnessError(f"{url} HTTP {status}")
    return json.loads(body)


def engine_stats(urls):
    return {url: fetch_json(url + "/stats") for url in urls}


def quiesce(url, deadline_s=60.0):
    """Wait for one engine to go fully idle; returns the final /stats
    snapshot and whether it got there."""
    deadline = time.monotonic() + deadline_s
    while True:
        stats = engine_stats([url])[url]
        idle = (stats["slots_active"] == 0
                and stats["queue_depth"] == 0
                and stats["kv_blocks_shared"] == 0
                and stats["kv_blocks_free"] == stats[
                    "kv_blocks_total"])
        if idle or time.monotonic() >= deadline:
            return stats, idle
        time.sleep(0.25)


def smi_line():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise HarnessError(f"nvidia-smi: {e}") from e


# ---------------------------------------------------------------------------
# Leg 1: the mixed Poisson trace and the row-work makespan
# ---------------------------------------------------------------------------


def rng_prefixes(rng, n_prefixes):
    """``n_prefixes`` random 2-full-block prefixes. Every leg draws
    from its OWN rng seed: sequences of 8 draws over 40 symbols never
    collide across legs, so no leg inherits another leg's cached
    blocks."""
    return [[rng.randrange(1, 41) for _ in range(PREFIX_LEN)]
            for _ in range(n_prefixes)]


def build_trace(n_keyed, n_free, n_prefixes, rng):
    """One deterministic mixed trace: ``n_keyed`` requests spread over
    ``n_prefixes`` shared 2-block prefixes (unique suffixes), plus
    ``n_free`` short unaffiliated prompts (under one full block, no
    affinity key, on a disjoint alphabet 41..46 so they never hand the
    affinity legs a partial-block hit), shuffled, with exponential
    inter-arrival gaps."""
    prefixes = rng_prefixes(rng, n_prefixes)
    reqs = []
    for i in range(n_keyed):
        prompt = prefixes[i % n_prefixes] + [
            rng.randrange(1, 41), rng.randrange(1, 41)]
        reqs.append({"prompts": [prompt],
                     "max_new_tokens": 4 + i % 5})
    for i in range(n_free):
        reqs.append({"prompts": [[rng.randrange(41, 47)
                                  for _ in range(3)]],
                     "max_new_tokens": 4})
    rng.shuffle(reqs)
    return [(req, rng.expovariate(1.0 / 0.004)) for req in reqs]


def run_trace(router_url, trace, max_outstanding=24):
    """Replay the trace through the front door; returns the list of
    per-request failures (empty on a clean run)."""
    failures = []
    lock = threading.Lock()
    sem = threading.Semaphore(max_outstanding)
    threads = []

    def fire(payload):
        try:
            status, _, body = post_json(router_url, payload)
            if status != 200:
                with lock:
                    failures.append(
                        f"HTTP {status}: {body.get('error')}")
        except OSError as e:
            with lock:
                failures.append(f"transport: {e}")
        finally:
            sem.release()

    for payload, gap in trace:
        if not sem.acquire(timeout=300):
            with lock:
                failures.append("trace stalled: no slot freed in 300s")
            break
        t = threading.Thread(target=fire, args=(payload,), daemon=True)
        t.start()
        threads.append(t)
        time.sleep(gap)
    for t in threads:
        t.join(timeout=300)
    return failures


def makespan(urls, before, after):
    """Work makespan of one run: the max over engines of the
    ``rows_decoded`` delta (token-rows actually decoded). Rows, not
    engine steps: step counts fold in batch occupancy, which the
    harness's feeding rate sets; rows charge the router for exactly
    what it controls, how evenly the work spread."""
    return max(after[u]["rows_decoded"] - before[u]["rows_decoded"]
               for u in urls)


# ---------------------------------------------------------------------------
# Leg 2: prefix-hit-rate under three placement policies
# ---------------------------------------------------------------------------


def hit_rate_delta(urls, before, after):
    hits = sum(after[u]["prefix_hits"] - before[u]["prefix_hits"]
               for u in urls)
    lookups = sum(
        after[u]["prefix_lookups"] - before[u]["prefix_lookups"]
        for u in urls)
    if lookups <= 0:
        raise HarnessError("affinity leg produced zero prefix "
                           "lookups: traffic never landed")
    return hits / lookups, lookups


def affinity_trace(rng, n_prefixes, per_prefix):
    """Identical-SHAPE traces per policy (per-policy rng seeds so no
    policy inherits another's cached blocks), PREFIX-major: all of a
    prefix's requests are consecutive, so the round-robin control's
    ``i % n_engines`` placement alternates engines WITHIN each
    prefix."""
    prefixes = rng_prefixes(rng, n_prefixes)
    reqs = []
    for prefix in prefixes:
        for _ in range(per_prefix):
            reqs.append(prefix + [rng.randrange(1, 41),
                                  rng.randrange(1, 41)])
    return reqs


def run_affinity_policy(urls_for, prompts):
    """Sequential replay (deterministic hit accounting: no two
    same-prefix admissions race into one batch)."""
    for i, prompt in enumerate(prompts):
        status, _, body = post_json(
            urls_for(i), {"prompts": [prompt], "max_new_tokens": 2})
        if status != 200:
            raise HarnessError(
                f"affinity-leg request {i} HTTP {status}: "
                f"{body.get('error')}")


# ---------------------------------------------------------------------------
# Leg 3: mid-stream failover
# ---------------------------------------------------------------------------


def stream_tokens(router_url, prompt, results, idx, first_token,
                  rid=None):
    """One streaming request through the router; accumulates tokens
    into results[idx] and flags the first delivered token. ``rid``
    rides the ``x-cea-request-id`` carrier so the journey leg finds
    this request's records by a name the harness chose."""
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["x-cea-request-id"] = rid
    req = urllib.request.Request(
        router_url + "/v1/models/lm:generate",
        data=json.dumps({"prompts": [prompt],
                         "max_new_tokens": STREAM_NEW,
                         "stream": True}).encode(),
        headers=headers)
    tokens, err = [], None
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            for raw in resp:
                line = json.loads(raw)
                if "tokens" in line:
                    tokens.extend(int(t) for t in line["tokens"])
                    first_token.set()
                elif line.get("error"):
                    err = line["error"]
                elif line.get("done"):
                    break
    except (OSError, ValueError) as e:
        err = f"{type(e).__name__}: {e}"
    results[idx] = {"tokens": tokens, "error": err}


# ---------------------------------------------------------------------------
# Leg 4: request journeys across the chaos run
# ---------------------------------------------------------------------------


def journey_leg(router_url, survivor_urls, chaos_rids):
    """The one-trace-id / sum-to-wall / router-tax contracts over the
    chaos run. Returns (failures, router_overhead_ms): the mean
    per-request router-tax milliseconds over splice-free journeys
    (hops == 0: placement and bookkeeping, not failover recovery)."""
    failures = []
    chaos = set(chaos_rids)
    records = fetch_json(router_url + "/debug/requests").get(
        "records") or []
    by_rid = {}
    for r in records:
        by_rid.setdefault(r.get("request_id"), []).append(r)

    spliced = 0
    for rid in chaos_rids:
        mine = by_rid.get(rid, [])
        if len(mine) != 1:
            failures.append(f"{rid}: {len(mine)} router journey "
                            f"records, want exactly 1")
            continue
        rec = mine[0]
        if not rec.get("trace_id"):
            failures.append(f"{rid}: journey record has no trace_id")
        total = sum(rec["buckets"].values())
        if abs(total - rec["wall_s"]) > max(
                SUM_TOLERANCE * rec["wall_s"], SUM_ABS_FLOOR_S):
            failures.append(
                f"{rid}: buckets sum {total:.6f}s vs wall "
                f"{rec['wall_s']:.6f}s, past the 1% sum-to-wall "
                f"contract")
        if rec.get("hops", 0) >= 1:
            spliced += 1
            if (rec["buckets"].get("splice_resubmit") or 0) <= 0:
                failures.append(f"{rid}: {rec['hops']} hop(s) but "
                                f"zero splice_resubmit time")
    if spliced < 1:
        failures.append("no chaos journey records a splice (hops >= "
                        "1): the SIGKILL left no journey evidence")

    # One trace id end to end: every surviving engine record with a
    # chaos request id carries the router journey's trace id (the
    # victim's records died with it).
    joins = 0
    for url in survivor_urls:
        for r in fetch_json(url + "/debug/requests").get(
                "records") or []:
            rid = r.get("request_id")
            if rid not in chaos or rid not in by_rid:
                continue
            joins += 1
            want = by_rid[rid][0].get("trace_id")
            if r.get("trace_id") != want:
                failures.append(
                    f"{rid}: engine record trace_id "
                    f"{r.get('trace_id')} != router journey {want}: "
                    f"the splice re-rooted the trace")
    if joins < 1:
        failures.append("no surviving engine record joined a chaos "
                        "request id: the carrier never reached the "
                        "engines")

    # The spans agree: the router's journal and each survivor's
    # /debug/trace put a chaos rid's request spans on ONE trace.
    snapshots = [obs.TRACER.snapshot()]
    for url in survivor_urls:
        snapshots.append(fetch_json(url + "/debug/trace"))
    span_traces, span_procs = {}, {}
    for snap in snapshots:
        seen_here = set()
        for span in snap.get("spans") or []:
            rid = (span.get("attrs") or {}).get("request_id")
            if rid in chaos and span.get("name") in (
                    "router.request", "serving.request"):
                span_traces.setdefault(rid, set()).add(
                    "%x" % span["trace_id"])
                seen_here.add(rid)
        for rid in seen_here:
            span_procs[rid] = span_procs.get(rid, 0) + 1
    for rid, traces in sorted(span_traces.items()):
        if len(traces) != 1:
            failures.append(f"{rid}: request spans carry {len(traces)}"
                            f" trace ids across processes, want 1")
        elif rid in by_rid \
                and by_rid[rid][0].get("trace_id") not in traces:
            failures.append(f"{rid}: span trace id disagrees with the "
                            f"journey record's")
    if not any(n >= 2 for n in span_procs.values()):
        failures.append("no chaos request's spans appear in two or "
                        "more processes")

    report = analyze(records)
    if not ((report.get("router") or {}).get("tax") or {}).get(
            "total_s"):
        failures.append(f"no nonzero router tax over {len(records)} "
                        f"journey records")
    if report["sum_to_wall"]["violations"]:
        failures.append(f"sum-to-wall violations over the journey "
                        f"records: "
                        f"{report['sum_to_wall']['violations'][:3]}")

    overhead_ms = router_overhead_ms(records)[0]
    return failures, (None if overhead_ms is None
                      else round(overhead_ms, 3))


def router_overhead_ms(records):
    """(mean router-tax milliseconds a splice-free journey, the same
    by bucket) over router journey records: placement and bookkeeping,
    the cost of fronting. (None, {}) without such a journey."""
    clean = [r for r in records if not r.get("hops")]
    if not clean:
        return None, {}
    by_bucket = {b: sum(r["buckets"].get(b) or 0.0 for r in clean)
                 / len(clean) * 1e3 for b in ROUTER_TAX_BUCKETS}
    return sum(by_bucket.values()), by_bucket


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fast", action="store_true",
                   help="2 engines and a smaller trace")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the engine workers' device")
    return p


def run(args, failures):
    """Every leg; appends contract failures, returns the summary."""
    n_engines = 2 if args.fast else 4
    n_keyed = 40 if args.fast else 96
    n_free = 16 if args.fast else 32
    scale_floor = 1.6 if args.fast else 3.2
    per_prefix, n_prefixes = 10, 6
    tmpdir = tempfile.mkdtemp(prefix="router_check_")
    log_path = os.path.join(tmpdir, "workers.log")
    procs, servers = [], []
    with open(log_path, "ab") as log:
        try:
            return _legs(args, failures, n_engines, n_keyed, n_free,
                         scale_floor, per_prefix, n_prefixes, tmpdir,
                         log, procs, servers)
        except BaseException:
            log.flush()
            with open(log_path) as f:
                tail = f.read()[-4000:]
            if tail:
                print("[router-check] worker log tail:\n" + tail,
                      file=sys.stderr)
            raise
        finally:
            _teardown(procs, servers)


def _legs(args, failures, n_engines, n_keyed, n_free, scale_floor,
          per_prefix, n_prefixes, tmpdir, log, procs, servers):
    for i in range(n_engines):
        procs.append(spawn_worker(i, tmpdir, log, args.device))
    deadline = time.monotonic() + 600
    ports = [wait_for_port(proc, pf, deadline) for proc, pf in procs]
    urls = [f"http://127.0.0.1:{port}" for port in ports]
    procs_by_url = dict(zip(urls, [pr for pr, _ in procs]))

    def front(url_subset, shed_sat=None):
        collector = FleetCollector(url_subset, poll_ms=250)
        core = RouterCore(collector, block_size=BLOCK,
                          shed_sat=shed_sat)
        server = RouterServer(core, collector, port=0)
        collector.start()
        server.start()
        servers.append((server, collector))
        return core, f"http://127.0.0.1:{server.port}"

    def stop_front():
        while servers:
            server, collector = servers.pop()
            server.stop()
            collector.stop()

    # -- leg 1: goodput scales through the front door ---------------
    # shed_sat above 1.0: a single saturated engine must KEEP
    # absorbing the trace (throughput is under test here; the shed
    # contract gets its own leg).
    trace = build_trace(n_keyed, n_free, n_prefixes=8,
                        rng=random.Random(20260807))
    _, solo_url = front(urls[:1], shed_sat=2.0)
    before = engine_stats(urls)
    errs = run_trace(solo_url, trace)
    solo_rows = makespan(urls, before, engine_stats(urls))
    stop_front()
    if errs:
        failures.append(f"single-engine trace had {len(errs)} failed "
                        f"requests (first: {errs[0]})")
    _, fleet_url = front(urls, shed_sat=2.0)
    before = engine_stats(urls)
    errs = run_trace(fleet_url, trace)
    fleet_rows = makespan(urls, before, engine_stats(urls))
    stop_front()
    if errs:
        failures.append(f"fleet trace had {len(errs)} failed requests "
                        f"(first: {errs[0]})")
    scale = solo_rows / max(1, fleet_rows)
    if scale < scale_floor:
        failures.append(
            f"row-work makespan scaled {scale:.2f}x from 1 to "
            f"{n_engines} engines (solo {solo_rows} vs fleet "
            f"{fleet_rows} decoded rows on the most-loaded engine), "
            f"want >= {scale_floor}x")

    # -- leg 2: affinity preserves the prefix hit rate --------------
    core, router_url = front(urls)
    rates = {}
    for name, seed, urls_for in (
            ("baseline", 100, lambda i: urls[0]),
            ("affinity", 200, lambda i: router_url),
            ("round_robin", 300, lambda i: urls[i % n_engines])):
        before = engine_stats(urls)
        run_affinity_policy(urls_for, affinity_trace(
            random.Random(seed), n_prefixes=n_prefixes,
            per_prefix=per_prefix))
        rates[name], _ = hit_rate_delta(urls, before,
                                        engine_stats(urls))
    if rates["affinity"] < rates["baseline"] - 0.10:
        failures.append(
            f"fleet prefix hit rate {rates['affinity']:.3f} under "
            f"affinity routing fell more than 10 points below the "
            f"single-engine baseline {rates['baseline']:.3f}")
    if rates["round_robin"] > rates["affinity"] - 0.05:
        failures.append(
            f"round-robin control hit rate {rates['round_robin']:.3f} "
            f"did not fall below the affinity rate "
            f"{rates['affinity']:.3f}: the control is not a control")

    # -- leg 3: SIGKILL mid-stream, token-identical splice ----------
    prefix = [(2 + 3 * j) % 40 + 1 for j in range(PREFIX_LEN)]
    prompts = [prefix + [41 + i, 43] for i in range(6)]
    key = affinity_key(prompts[0], BLOCK, core.affinity_blocks)
    status, _, _ = post_json(
        router_url, {"prompts": [prompts[0]], "max_new_tokens": 2})
    if status != 200:
        raise HarnessError(f"affinity probe HTTP {status}")
    victim = core.affinity_snapshot().get(key.hex())
    if victim not in urls:
        raise HarnessError(f"affinity probe did not pin the prefix "
                           f"(map: {core.affinity_snapshot()})")
    ref_url = next(u for u in urls if u != victim)
    references = []
    for prompt in prompts:
        status, _, body = post_json(
            ref_url, {"prompts": [prompt],
                      "max_new_tokens": STREAM_NEW})
        if status != 200:
            raise HarnessError(f"reference generate HTTP {status}")
        references.append(
            [int(t) for t in body["sequences"][0][len(prompt):]])

    results = [None] * len(prompts)
    first_token = threading.Event()
    chaos_rids = [f"chaos{i:02d}" for i in range(len(prompts))]
    threads = [threading.Thread(
        target=stream_tokens,
        args=(router_url, prompt, results, i, first_token,
              chaos_rids[i]), daemon=True)
        for i, prompt in enumerate(prompts)]
    failover_before = core.stats()["failover"]
    for t in threads:
        t.start()
    if not first_token.wait(timeout=120):
        raise HarnessError("no stream delivered a first token "
                           "within 120s")
    procs_by_url[victim].kill()
    procs_by_url[victim].wait(timeout=30)
    for t in threads:
        t.join(timeout=300)
    for i, (res, ref) in enumerate(zip(results, references)):
        if res is None:
            failures.append(f"stream {i} never finished")
        elif res["error"]:
            failures.append(f"stream {i} errored instead of splicing: "
                            f"{res['error']}")
        elif res["tokens"] != ref:
            failures.append(
                f"stream {i} tokens diverged after failover: got "
                f"{res['tokens']} want {ref}")
    if core.stats()["failover"] <= failover_before:
        failures.append("tpu_router_failover_total never moved: the "
                        "kill was not a failover")
    status, _, body = http_get(router_url + "/metrics")
    if status != 200 or b"tpu_router_failover_total" not in body:
        failures.append("router /metrics does not expose "
                        "tpu_router_failover_total")

    # -- leg 4: request journeys across the chaos run ---------------
    survivors = [u for u in urls if u != victim]
    journey_failures, overhead_ms = journey_leg(router_url, survivors,
                                                chaos_rids)
    failures.extend(journey_failures)
    if overhead_ms is None:
        failures.append("no splice-free journey records: the router "
                        "overhead metric has nothing to measure")

    # -- leg 5: survivors quiesce with zero leaks -------------------
    for url in survivors:
        stats, idle = quiesce(url)
        if not idle:
            failures.append(
                f"survivor {url} never quiesced: "
                f"slots_active={stats['slots_active']} "
                f"queue_depth={stats['queue_depth']} "
                f"kv_blocks_free={stats['kv_blocks_free']}/"
                f"{stats['kv_blocks_total']} "
                f"kv_blocks_shared={stats['kv_blocks_shared']}")

    # -- leg 6: empty steer set -> structured fleet-wide shed -------
    for url in survivors:
        os.kill(procs_by_url[url].pid, signal.SIGUSR1)
    deadline = time.monotonic() + 30
    while core.view().steer_set():
        if time.monotonic() > deadline:
            raise HarnessError("steer set never emptied after "
                               "draining every survivor")
        time.sleep(0.25)
    status, headers, _ = post_json(
        router_url, {"prompts": [prompts[0]], "max_new_tokens": 2})
    if status != 503:
        failures.append(f"router answered HTTP {status} with an empty "
                        f"steer set, want 503")
    elif int(headers.get("Retry-After") or 0) < 1:
        failures.append(f"router shed lacks a usable Retry-After "
                        f"header: {headers.get('Retry-After')!r}")
    status, _, _ = http_get(router_url + "/readyz")
    if status != 503:
        failures.append(f"router /readyz HTTP {status} with an empty "
                        f"steer set, want 503")
    if "torch" in sys.modules:
        raise HarnessError("this process imported torch: the router "
                           "stack must stay torch-free")
    return {
        "engines": n_engines,
        "device": args.device,
        "trace_requests": n_keyed + n_free,
        "router_goodput_scale": round(scale, 3),
        "solo_rows": solo_rows,
        "fleet_rows": fleet_rows,
        "hit_rate_baseline": round(rates["baseline"], 4),
        "router_affinity_hit_rate": round(rates["affinity"], 4),
        "hit_rate_round_robin": round(rates["round_robin"], 4),
        "router_overhead_ms": overhead_ms,
    }


def _teardown(procs, servers):
    while servers:
        server, collector = servers.pop()
        server.stop()
        collector.stop()
    for proc, _ in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc, _ in procs:
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def main(argv=None):
    args = build_parser().parse_args(argv)
    obs.set_role("router-check")
    t_start = time.monotonic()
    failures = []
    try:
        smi = smi_line() if args.device == "cuda" else None
        summary = run(args, failures)
    except HarnessError as e:
        print(f"[router-check] HARNESS ERROR: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        print("[router-check] HARNESS ERROR", file=sys.stderr)
        return 2
    summary["wall_s"] = round(time.monotonic() - t_start, 1)
    summary["failures"] = len(failures)
    summary["nvidia_smi"] = smi
    print(json.dumps(summary), flush=True)
    for f in failures:
        print(f"[router-check] FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

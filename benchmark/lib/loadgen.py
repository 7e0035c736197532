"""The load generator: a process of its own (standard library only)
that sends a schedule to the generate endpoint and times every
streamed token on the client.

    python benchmark/lib/loadgen.py SPEC.json

SPEC holds the port, the path, the loop ("closed": ``clients``
threads, each sending its next request when its last one ends, their
starts spread over the ``ramp_s`` before the window; "open": each
request sent at its due time whatever the server is doing), the
window's open and close on the monotonic clock (shared with the
caller: CLOCK_MONOTONIC is system-wide) and the requests. No request
is sent after the close; one in flight is read until its first token
(at most ``drain_s``), then its connection is closed, which cancels it
on the server. Prints one JSON line: every request's record.
"""

import http.client
import json
import sys
import threading
import time


def _sleep_until(t):
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def send(spec, req, rec):
    """One streamed request; fills ``rec`` in place."""
    body = json.dumps({"prompts": [req["prompt"]],
                       "max_new_tokens": req["new"], "stream": True})
    close, drain = spec["close"], spec["close"] + spec["drain_s"]
    conn = http.client.HTTPConnection("127.0.0.1", spec["port"],
                                      timeout=spec["drain_s"] + 120)
    rec["sent"] = time.monotonic()
    try:
        conn.request("POST", spec["path"], body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        rec["status"] = resp.status
        if resp.status != 200:
            rec["error"] = resp.read().decode(errors="replace")[:200]
            return
        while True:
            line = resp.readline()
            if not line:
                rec.setdefault("error", "stream ended without done")
                return
            item = json.loads(line)
            now = time.monotonic()
            if "tokens" in item:
                rec["times"].extend([now] * len(item["tokens"]))
                rec["tokens"].extend(item["tokens"])
            elif item.get("done"):
                rec["done"] = True
                return
            else:
                rec["error"] = str(item.get("error"))[:200]
                return
            if now >= close and (rec["tokens"] or now >= drain):
                rec["cut"] = True
                return
    except (OSError, http.client.HTTPException, ValueError) as e:
        rec["error"] = repr(e)[:200]
    finally:
        conn.close()


def _record(req):
    return {"id": req["id"], "due": req.get("due_abs"), "sent": None,
            "status": None, "times": [], "tokens": [], "done": False,
            "error": None}


def run(spec):
    reqs = spec["requests"]
    records = [_record(r) for r in reqs]
    threads = []
    if spec["loop"] == "closed":
        clients = int(spec["clients"])
        first = {}
        shared = []
        for req, rec in zip(reqs, records):
            if req["client"] is None:
                shared.append((req, rec))
            else:
                first[req["client"]] = (req, rec)
        lock = threading.Lock()

        def next_shared():
            with lock:
                return shared.pop(0) if shared else None

        def client(c):
            _sleep_until(spec["open"] - spec["ramp_s"]
                         + c * spec["ramp_s"] / clients)
            item = first.get(c)
            while item is not None and time.monotonic() < spec["close"]:
                send(spec, *item)
                item = next_shared()

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        for t in threads:
            t.start()
    else:
        for req, rec in zip(reqs, records):
            req["due_abs"] = rec["due"] = spec["open"] + req["due"]
        for req, rec in zip(reqs, records):
            if req["due_abs"] >= spec["close"]:
                continue
            _sleep_until(req["due_abs"])
            t = threading.Thread(target=send, args=(spec, req, rec),
                                 daemon=True)
            t.start()
            threads.append(t)
    deadline = spec["close"] + spec["drain_s"] + 5
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    return records


def main(argv):
    with open(argv[1]) as f:
        spec = json.load(f)
    records = run(spec)
    sys.stdout.write(json.dumps({"records": records}) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main(sys.argv)

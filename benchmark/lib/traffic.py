"""The one traffic generator: a mix's parameters in, a schedule out.

Every size and arrival is drawn from ``--seed`` alone. The sizes are
the mix's distribution read at evenly spaced quantiles and the arrival
gaps the exponential's, so every seed serves the same multiset of
sizes and gaps, in its own order: seeds change which request comes
when, not how much work a window holds.
"""

import hashlib
import math
from statistics import NormalDist

import numpy as np


def derive_seed(seed, *parts):
    """A 63-bit seed for one purpose of one run (``parts`` name it)."""
    key = repr((int(seed),) + tuple(str(p) for p in parts)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def rng(seed, *parts):
    return np.random.Generator(np.random.PCG64(derive_seed(seed, *parts)))


# An order that no seed changes (the pairing of residual shares).
FIXED_ORDER_SEED = 20261018


def _quantiles(n):
    return (np.arange(n) + 0.5) / n


def draw_lengths(spec, n, gen):
    """``n`` integer lengths of ``spec`` ({"dist": "lognormal",
    "median", "sigma", "min", "max"} or {"dist": "fixed", "value"}),
    clipped to [min, max], in the order ``gen`` shuffles them to."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    mu, sigma = math.log(spec["median"]), float(spec["sigma"])
    z = np.array([NormalDist().inv_cdf(q) for q in _quantiles(n)])
    gen.shuffle(z)
    vals = np.exp(mu + sigma * z)
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


def draw_gaps(rate, n, gen):
    """``n`` Poisson inter-arrival gaps (seconds) at ``rate`` a second."""
    u = _quantiles(n)
    gen.shuffle(u)
    return -np.log1p(-u) / float(rate)


def schedule(traffic, seed, seconds, vocab):
    """The requests a run may send: a list of dicts with ``prompt``
    (token ids), ``new`` (tokens to generate) and, in an open loop,
    ``due`` (seconds after the window opens; ramp arrivals are
    negative) or, in a closed loop, ``client``. A closed loop draws
    ``per_client`` requests for each client; an open loop the arrivals
    of the ramp and of the window, at ``rate_per_s``: the window's
    first is due as it opens."""
    if traffic["loop"] == "closed":
        # One round is one request of every client, and each round
        # holds the whole stratified set: the rounds a window reaches
        # are the same work on every seed.
        clients = int(traffic["clients"])
        rounds = [(clients, r) for r in range(int(traffic["per_client"]))]
    else:
        # The ramp's arrivals and the window's are stratified apart, so
        # the window holds the same sizes and gaps on every seed (the
        # stratified gaps sum to a little under the window).
        rate = float(traffic["rate_per_s"])
        ramp = float(traffic.get("ramp_s", 0.0))
        rounds = [(max(1, int(round(rate * ramp))), "ramp"),
                  (max(1, int(round(rate * float(seconds)))), "window")]
    plens = np.concatenate([
        draw_lengths(traffic["prompt_len"], k, rng(seed, "prompt_len", r))
        for k, r in rounds])
    news = np.concatenate([
        draw_lengths(traffic["output_len"], k, rng(seed, "output_len", r))
        for k, r in rounds])
    n = len(plens)
    tok = rng(seed, "prompt_tokens")
    out = []
    for i in range(n):
        out.append({"id": i,
                    "prompt": tok.integers(0, vocab, int(plens[i])).tolist(),
                    "new": int(news[i])})
    if traffic["loop"] == "closed":
        # A client's first request stands for one already under way
        # when the window opens: its length is the residual life of a
        # drawn one, so completions are spread from the start. The
        # residual shares are stratified and paired with the sorted
        # lengths in an order fixed for all seeds, so every seed holds
        # the same first requests; the seed only deals them out.
        first = out[:clients]
        lengths = sorted(r["new"] for r in first)
        fixed = np.random.Generator(np.random.PCG64(FIXED_ORDER_SEED))
        share = _quantiles(clients)[fixed.permutation(clients)]
        residual = [max(2, int(math.ceil(n * u)))
                    for n, u in zip(lengths, share)]
        rng(seed, "first_residual").shuffle(residual)
        for i, (req, n) in enumerate(zip(first, residual)):
            req["client"], req["new"] = i, n
        # Later requests go to whichever client is free next, in the
        # schedule's order (one shared queue).
        for req in out[clients:]:
            req["client"] = None
    else:
        k_ramp = rounds[0][0]
        ramp_due = -np.cumsum(draw_gaps(
            rate, k_ramp, rng(seed, "arrivals", "ramp")))[::-1]
        gaps = draw_gaps(rate, n - k_ramp, rng(seed, "arrivals", "window"))
        win_due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
        for req, t in zip(out, np.concatenate([ramp_due, win_due])):
            req["due"] = float(t)
    return out

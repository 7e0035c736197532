"""What decides ``correct``: the numbers compared, each beside its limit.

Training compares three numbers of the first three steps against the
reference's:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: the worst leaf's gap between the program's and the
  reference's norm of the first gradient, as the optimizer holds it
  after one step, over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
- ``change_gap``: the same for the parameters' change over the three
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (a gradient that is nought to
  rounding moves its leaf by round-off alone).

Serving compares ``served_logit_gap``: the widest gap by which a
served token's reference logit lies below the reference's best.
"""

import statistics

LEAF_FLOOR = 1e-3


def _worst_leaf(prog, ref, names):
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


def training_numbers(prog, ref):
    """``prog``, ``ref``: {"losses": [3], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    loss = max(abs(p - r) / abs(r)
               for p, r in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grad"])
    grad = _worst_leaf(prog["grad"], ref["grad"], names)
    gmed = statistics.median(ref["grad"][n] for n in names)
    moved = [n for n in names if ref["grad"][n] >= LEAF_FLOOR * gmed]
    change = _worst_leaf(prog["change"], ref["change"], moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


def decide(numbers, limits):
    """(correct, lines): every number that has a limit must be present,
    finite and at most its limit."""
    lines, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = (value is not None and value == value
                and value <= float(limit))
        ok = ok and good
        lines.append((name, value, float(limit)))
    return ok and bool(limits), lines

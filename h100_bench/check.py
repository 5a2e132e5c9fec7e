"""How `correct` is decided: the numbers a cell compares with the plain
reference, held against the limits in ``limits/<cell>.json``.

A training cell compares the first three steps (`train_numbers`); a
serving cell compares its served outputs (each system's check).  A
number at or under its limit passes; `correct` is true when every
number the cell's limits name passes.  Counts other than compared
numbers (how many boxes or crops were compared) are printed beside
them, with no limit.
"""

import json
import math
import os
import statistics

HERE = os.path.dirname(os.path.abspath(__file__))
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off under Adam: left out of the change's gap
STILL_LEAF = 1e-3


def load_limits(cell):
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return json.load(f)


def _norm(t):
    return math.sqrt(float(t.double().pow(2).sum()))


def worst_leaf_gap(prog, ref, keep=None):
    """max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, the median
    leaf's ‖ref‖): the gap of the norms, not the norm of the
    difference."""
    p, r = [_norm(t) for t in prog], [_norm(t) for t in ref]
    med = statistics.median(r)
    return max(abs(a - b) / max(b, med)
               for i, (a, b) in enumerate(zip(p, r))
               if keep is None or keep[i])


def train_numbers(prog_losses, prog_grad, prog_delta, ref_losses, ref_grad,
                  ref_delta):
    """The numbers of a training cell: loss_rel, the largest relative
    gap of the three steps' losses, and loss1_rel, the first step's
    alone (steady from seed to seed: later steps move by Adam's
    normalised updates of gradients that are noise to f32); grad_gap, the worst leaf's
    gap of the first gradient's norms (the program's as Adam's state
    holds it after step 1); delta_gap, the worst leaf's gap of the norms
    of the weights' change over the three steps, over the leaves whose
    reference gradient is not nought to rounding (under STILL_LEAF of
    the median leaf's)."""
    g = [_norm(t) for t in ref_grad]
    med = statistics.median(g)
    moving = [v >= STILL_LEAF * med for v in g]
    return {
        "loss1_rel": abs(prog_losses[0] - ref_losses[0]) / abs(ref_losses[0]),
        "loss_rel": max(abs(a - b) / abs(b)
                        for a, b in zip(prog_losses, ref_losses)),
        "grad_gap": worst_leaf_gap(prog_grad, ref_grad),
        "delta_gap": worst_leaf_gap(prog_delta, ref_delta, moving),
        "still_leaves": len(moving) - sum(moving),
    }


def judge(numbers, limits):
    """(correct, checks): each limited number beside its limit, in the
    limits' order, then the unlimited counts.  A number that is not
    finite fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        v = float(numbers[name])
        ok = math.isfinite(v) and v <= limit
        correct &= ok
        checks[name] = {"value": v, "limit": limit}
    for name, v in numbers.items():
        if name not in limits:
            checks[name] = {"value": v, "limit": None}
    return correct, checks

"""The numbers that decide ``correct``: each compared with its limit, and
printed beside it."""
from __future__ import annotations

import math
import sys


def rel_norm(a, ref) -> float:
    """||a - ref|| / ||ref|| (float64 sums)."""
    a, ref = a.double(), ref.double()
    return float((a - ref).norm() / ref.norm().clamp(min=1e-30))


def judge(numbers: dict, limits: dict, failed: int) -> tuple:
    """(correct, {name: {"value", "limit"}}): each number that the cell's
    limits name finite and at most its limit, and no failed request or
    step. A cell with no limits yet is not correct; a number that the
    harness reads and the limits do not name is not compared."""
    table, ok = {}, failed == 0 and bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        table[name] = {"value": value, "limit": limit}
        if not math.isfinite(value) or value > limit:
            ok = False
    return ok, table


def print_limits(table: dict, failed: int) -> None:
    """The compared numbers as the last lines of standard error."""
    for name, t in table.items():
        print(f"check {name} = {t['value']!r} limit {t['limit']!r}", file=sys.stderr)
    print(f"check failed = {failed} limit 0", file=sys.stderr, flush=True)

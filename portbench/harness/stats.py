"""The port's linear-interpolation percentile, copied from
`runtime/batcher.percentile` so that the yardstick does not change with
the program."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (q in [0, 100])."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))

"""The arithmetic of the end-to-end metrics, over all the work of a window."""

from __future__ import annotations

import math
import statistics


class Window:
    """A measured window: units of work are counted as they complete, and the
    window ends at the first completion at or after ``seconds``. Its rate is
    all the units over all the time from its start to that completion."""

    def __init__(self, clock, seconds: float):
        self.clock = clock
        self.seconds = seconds
        self.t0 = clock()
        self.t_end = self.t0
        self.units = 0
        self.events = 0
        self.marks = []  # (time since the start, units so far)

    def done(self, units: int) -> bool:
        """Count ``units`` completed now; True once the window is over."""
        self.t_end = self.clock()
        self.units += units
        self.events += 1
        self.marks.append((self.t_end - self.t0, self.units))
        return self.t_end - self.t0 >= self.seconds

    def thirds(self) -> list:
        """The rate in each third of the window, to tell drift within a run
        from a difference between runs."""
        out, last = [], (0.0, 0)
        for k in (1, 2, 3):
            cut = [m for m in self.marks if m[0] <= self.elapsed * k / 3 + 1e-9][-1:] or [last]
            (t, u), (t0, u0) = cut[0], last
            out.append((u - u0) / (t - t0) if t > t0 else 0.0)
            last = cut[0]
        return out

    @property
    def elapsed(self) -> float:
        return self.t_end - self.t0

    @property
    def rate(self) -> float:
        return self.units / self.elapsed if self.elapsed > 0 else 0.0


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all ``values``, linear between ranks;
    an absent value (None, a failed request) counts as infinitely late."""
    xs = sorted(math.inf if v is None else v for v in values)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2

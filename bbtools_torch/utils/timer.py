"""Phase timing (SURVEY §5.1).

PhaseTimer mirrors the reference's shared/Timer.java usage pattern —
per-phase splits printed in the tool summary ("xtime"/"showtimes"
output of BBDuk/BBMap).
"""

from __future__ import annotations

import contextlib
import sys
import time


class PhaseTimer:
    """Named phase splits; print like the reference's timing block."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.phases: list[tuple[str, float]] = []

    def split(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.phases.append((name, dt))
        self.last = now
        return dt

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.phases.append((name, time.perf_counter() - start))
            self.last = time.perf_counter()

    def total(self) -> float:
        return time.perf_counter() - self.t0

    def report(self, stream=None):
        # resolve sys.stderr at call time so stream redirection
        # (including pytest capture) is honored
        stream = stream if stream is not None else sys.stderr
        for name, dt in self.phases:
            print(f"{name+':':<22s}\t{dt:.3f} seconds.", file=stream)
        print(f"{'Total Time:':<22s}\t{self.total():.3f} seconds.",
              file=stream)

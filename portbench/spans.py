"""Spans from the benchmark's side: wrappers put around the tool's calls
in a traced run, on the tool's instance or on the module attribute the
tool looks up at call time. The program is not edited.

A span is (name, start, end) on the host's perf_counter clock, kept in
memory; the traced job puts them beside the device's events to say what
the host was doing in each idle gap.
"""

from __future__ import annotations

import contextlib
import functools
import time


class Spans:
    def __init__(self):
        self.events: list[tuple[str, float, float]] = []
        self._restore: list[tuple[object, str, object, bool]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.events.append((name, t0, time.perf_counter()))

    def patch(self, owner, attr: str, new):
        had = attr in vars(owner)
        self._restore.append((owner, attr, getattr(owner, attr), had))
        setattr(owner, attr, new)

    def wrap_method(self, owner, attr: str, name: str):
        """Time each call of owner.attr as a span `name`."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*a, **k):
            with self.span(name):
                return fn(*a, **k)

        self.patch(owner, attr, timed)

    def timed_iter(self, it, name: str):
        """An iterator over `it` that times each step of it as `name`."""
        it = iter(it)
        while True:
            with self.span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    def wrap_iterator_method(self, owner, attr: str, name: str):
        """owner.attr returns an iterator: time each of its steps."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*a, **k):
            return self.timed_iter(fn(*a, **k), name)

        self.patch(owner, attr, timed)

    def restore(self):
        for owner, attr, old, had in reversed(self._restore):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._restore.clear()


def totals(events, t0: float, t1: float) -> dict:
    """Per span name, the seconds inside [t0, t1] that spans of that name
    cover, and their self time: less what spans nested in them cover."""
    inside = [(n, max(a, t0), min(b, t1)) for n, a, b in events if b > t0 and a < t1]
    total: dict[str, float] = {}
    own: dict[str, float] = {}
    for n, a, b in inside:
        total[n] = total.get(n, 0.0) + (b - a)
    for n, a, b in inside:
        child = sum(d - c for m, c, d in inside
                    if (c, d) != (a, b) and c >= a and d <= b and (d - c) < (b - a))
        own[n] = own.get(n, 0.0) + (b - a) - child
    return {"total": total, "self": own}

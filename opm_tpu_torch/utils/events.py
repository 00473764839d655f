"""Minimal signal/slot event system.

Counterpart of opm/core/utility/Event.hpp:25-98
(EventSource/Event with add/signal), used by the legacy simulators for
timestep-completed callbacks."""

from __future__ import annotations

from typing import Callable, Dict, List


class Event:
    """A signal that callbacks can subscribe to."""

    def __init__(self):
        self._handlers: List[Callable] = []

    def add(self, handler: Callable) -> "Event":
        self._handlers.append(handler)
        return self

    def remove(self, handler: Callable):
        self._handlers.remove(handler)

    def signal(self, *args, **kwargs):
        for h in list(self._handlers):
            h(*args, **kwargs)


class EventSource:
    """Named-event registry (EventSource::timestep_completed style)."""

    def __init__(self, *names: str):
        self._events: Dict[str, Event] = {n: Event() for n in names}

    def event(self, name: str) -> Event:
        return self._events.setdefault(name, Event())

    def signal(self, name: str, *args, **kwargs):
        if name in self._events:
            self._events[name].signal(*args, **kwargs)


class DebugTimeReport:
    """RAII-style scope timer (DebugTimeReport.hpp:31-50): prints elapsed
    wall time for a named scope on exit. Use as a context manager."""

    def __init__(self, name: str, *, printer=print):
        self.name = name
        self._printer = printer

    def __enter__(self):
        import time

        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import time

        self._printer(f"{self.name}: "
                      f"{time.perf_counter() - self._t0:.3f} s")
        return False

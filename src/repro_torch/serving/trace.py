"""Spans and counters inside the serving engine.

``SpinEngine`` owns a :class:`Tracer` as ``eng.tracer``, off by default.
While it is on, the engine records a span at each of its layer boundaries:
a name, start and end on ``time.perf_counter_ns()``, the index of the
enclosing span, and a key (the request id on request-scoped spans, the
SSM's index on a draft).  Every blocking transfer between host and device
on the serving path is a ``sync`` span and counts one ``syncs``.  Counters
belong to the root span (``submit`` or ``step``) open when they are added.
Request events (``queued``, ``admitted``) carry the request id.  Everything
stays in memory until :meth:`Tracer.drain` hands it over.  Spans take host
timestamps only: none synchronizes the device.

Off, :meth:`Tracer.span` returns one shared no-op context manager and
nothing is recorded or allocated.

Code below the engine (pools, switching, the model forwards) marks its
blocking transfers with :func:`sync`, which records into the tracer whose
root span is open in this context, if any.
"""

from __future__ import annotations

import contextvars
import time
from typing import Dict, List, Optional

# the tracer whose root span is open in this context
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tracer", default=None)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class Span:
    """One recorded span, and the context manager that records it."""
    __slots__ = ("name", "key", "t0", "t1", "parent", "counts", "_tracer",
                 "_token")

    def __init__(self, tracer: "Tracer", name: str, key):
        self._tracer, self.name, self.key = tracer, name, key

    def __enter__(self):
        tr = self._tracer
        self.parent = tr._open[-1] if tr._open else -1
        self.counts = None
        if self.parent < 0:
            self.counts = {}
            self._token = _ACTIVE.set(tr)
        tr._open.append(len(tr.spans))
        tr.spans.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        self._tracer._open.pop()
        if self.parent < 0:
            _ACTIVE.reset(self._token)
        return False


class Tracer:
    def __init__(self):
        self.on = False
        self.spans: List[Span] = []
        self.events: List[tuple] = []
        self._open: List[int] = []

    def span(self, name: str, key=None):
        """A context manager recording span ``name`` (``key``: the request
        id, or the SSM's index); the shared no-op while off."""
        if not self.on:
            return NO_SPAN
        return Span(self, name, key)

    def count(self, name: str, n: int = 1):
        """Adds ``n`` to counter ``name`` of the open root span (dropped
        where none is open)."""
        if self._open:
            c = self.spans[self._open[0]].counts
            c[name] = c.get(name, 0) + n

    def current(self) -> Optional[str]:
        """The name of the innermost open span, or None."""
        return self.spans[self._open[-1]].name if self._open else None

    def event(self, name: str, key):
        if self.on:
            self.events.append((name, key, time.perf_counter_ns()))

    def drain(self) -> Dict[str, list]:
        """Hands over and clears what was recorded: ``spans`` as dicts
        (``name``, ``key``, ``t0``, ``t1`` in ns, ``parent`` the index in
        this list or -1, ``counts`` on roots) and ``events`` as (name, key,
        ns).  Call it between root spans."""
        if self._open:
            raise RuntimeError("Tracer.drain with spans open")
        spans = [{"name": s.name, "key": s.key, "t0": s.t0, "t1": s.t1,
                  "parent": s.parent, "counts": s.counts}
                 for s in self.spans]
        out = {"spans": spans, "events": self.events}
        self.spans, self.events = [], []
        return out


def active() -> Optional[Tracer]:
    """The tracer recording in this context, or None."""
    tr = _ACTIVE.get()
    return tr if tr is not None and tr.on else None


def count(name: str, n: int = 1):
    """Adds ``n`` to counter ``name`` of the recording tracer's open root
    span; nothing where no tracer is recording."""
    tr = active()
    if tr is not None:
        tr.count(name, n)


def sync():
    """A ``sync`` span around a blocking transfer between host and device,
    counted as one of the open root span's ``syncs``; the shared no-op
    where no tracer is recording."""
    tr = active()
    if tr is None:
        return NO_SPAN
    tr.count("syncs")
    return Span(tr, "sync", None)

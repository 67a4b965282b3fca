"""The port's span recorder: named host intervals at the layer boundaries
of the enhancement path (the ``Enhancer``'s dispatch and collect, the EM
stages, the labels, the serving worker and its queue).

Off by default. While off, :func:`span` returns one shared no-op object
and :func:`record` and :func:`clock` return at once: no allocation and no
clock read. While on (:func:`enable` to :func:`disable`), each span keeps
its name, its start and end on ``time.time_ns()`` (the clock
``torch.profiler`` places its device events on), the thread it ran on, the
name of the span open around it on that thread, and its attributes.
:func:`collect` hands over the spans closed so far and empties the buffer,
which keeps the newest :data:`LIMIT` spans.

A span that opens on one thread and closes on another (a request's wait
in the service's queue) is read with :func:`clock` where it opens and
recorded whole with :func:`record` where it closes.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

#: the most spans the buffer holds; the oldest are dropped beyond it
LIMIT = 1 << 18


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: str | None  # the span open around it on its thread, if any
    attrs: dict


_on = False
_buf: collections.deque = collections.deque(maxlen=LIMIT)
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """What :func:`span` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def end_at(self, end_ns: int) -> None:
        pass


_OFF = _Off()


class _Open:
    __slots__ = ("name", "start", "end", "attrs", "parent")

    def __init__(self, name: str, start_ns: int | None, attrs: dict):
        self.name, self.start, self.end, self.attrs = name, start_ns, None, attrs

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].name if stack else None
        if self.start is None:
            self.start = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns() if self.end is None else self.end
        _stack().pop()
        _buf.append(Span(self.name, self.start, end, threading.get_ident(), self.parent,
                         self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)

    def end_at(self, end_ns: int) -> None:
        """End the span at a clock reading the caller already took."""
        self.end = end_ns


def span(name: str, start_ns: int | None = None, /, **attrs):
    """A context manager timing its block as the span ``name``; it starts
    at ``start_ns`` when the caller has read the clock already."""
    if not _on:
        return _OFF
    return _Open(name, start_ns, attrs)


def clock() -> int:
    """``time.time_ns()`` while the recorder is on, else 0."""
    return time.time_ns() if _on else 0


def record(name: str, start_ns: int, end_ns: int | None = None, /, **attrs) -> None:
    """Record a whole span from ``start_ns`` (a :func:`clock` reading) to
    ``end_ns`` (now when None). Nothing is recorded while the recorder is
    off, or when ``start_ns`` is 0 (read while it was off)."""
    if _on and start_ns:
        _buf.append(Span(name, start_ns, time.time_ns() if end_ns is None else end_ns,
                         threading.get_ident(), None, attrs))


def enable() -> None:
    """Start recording, into a buffer of at most :data:`LIMIT` spans."""
    global _on, _buf
    if _buf.maxlen != LIMIT:
        _buf = collections.deque(_buf, maxlen=LIMIT)
    _on = True


def disable() -> None:
    """Stop recording; spans still open are kept when they close."""
    global _on
    _on = False


def collect() -> list[Span]:
    """The spans closed so far, oldest first; empties the buffer."""
    out = []
    while True:
        try:
            out.append(_buf.popleft())
        except IndexError:
            return out

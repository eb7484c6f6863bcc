"""Spans and counters inside the port, per proof, on the host's
``time.perf_counter`` clock (the clock of the benchmark's spans, so a span
can be placed on a device trace).

A span is one :class:`Span`: its name, start and end, its id, its parent's
id, its proof id, the thread that opened it and its ``counts``, a small
dict of numbers: ``launches`` (kernel launches, ``cuda_curve._count``),
``h2d_bytes`` (bytes handed to the backend's device, ``ops.field.upload``)
and, on an ``ipp.round``, its ``round`` and side ``m``.  Counts land in the innermost
open span of the thread that counts.

Each thread keeps a stack of open spans; a span's parent is the innermost
one.  A span opened with ``root=True`` (``prove``, ``verify`` and the
backend seam's calls) starts a new proof when the stack is empty: its id
is the proof id its descendants inherit.  Other spans are recorded only
inside a recorded parent.  Work handed to another thread carries its
parent explicitly (:func:`begin`, :func:`child`, :func:`adopt`).

Recording is on while a ``torch.profiler`` session is active on the
thread that opens a root, or between :func:`enable` and :func:`disable`.
Off, opening a span costs a check and records nothing.  Spans are kept in
memory: :func:`spans` reads them, :func:`take` reads and clears them.
Only the newest ``KEEP`` spans are kept (about 300 proofs of 2^18), so a
long profiled run that never takes them holds a bounded number.
No ``torch.profiler`` range is opened: the device trace keeps only the
program's own device work.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    start: float
    end: float
    id: int
    parent: int | None
    proof: int
    thread: int
    counts: dict


class _Open:
    __slots__ = ("name", "start", "id", "parent", "proof", "thread",
                 "counts", "phase")

    def __init__(self, name, parent, counts, start=None, phase=False):
        self.name = name
        self.start = time.perf_counter() if start is None else start
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.proof = self.id if parent is None else parent.proof
        self.thread = threading.get_ident()
        self.counts = dict(counts)
        self.phase = phase


_ids = itertools.count(1)
_lock = threading.Lock()
KEEP = 65536
_done: collections.deque[Span] = collections.deque(maxlen=KEEP)
_enabled = False
_local = threading.local()


def enable() -> None:
    """Record every proof from now on (until :func:`disable`), with or
    without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def recording() -> bool:
    return _enabled or torch.autograd._profiler_enabled()


def spans() -> list[Span]:
    with _lock:
        return list(_done)


def take() -> list[Span]:
    """The recorded spans, which are then forgotten."""
    with _lock:
        out = list(_done)
        _done.clear()
    return out


def _stack() -> list[_Open]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _close(o: _Open, end: float) -> None:
    span = Span(o.name, o.start, end, o.id, o.parent, o.proof, o.thread,
                o.counts)
    with _lock:
        _done.append(span)


def _unwind(o: _Open) -> float:
    """Close `o` and every span above it on this thread's stack (phases a
    mark left open), all at one time; returns that time."""
    end = time.perf_counter()
    st = _stack()
    while st:
        top = st.pop()
        _close(top, end)
        if top is o:
            break
    return end


class _Scope:
    __slots__ = ("name", "root", "counts", "open")

    def __init__(self, name, root, counts):
        self.name, self.root, self.counts = name, root, counts
        self.open = None

    def __enter__(self):
        st = _stack()
        if st:
            self.open = _Open(self.name, st[-1], self.counts)
        elif self.root and recording():
            self.open = _Open(self.name, None, self.counts)
        else:
            return None
        st.append(self.open)
        return self.open

    def __exit__(self, *exc):
        if self.open is not None:
            _unwind(self.open)
        return False


def span(name: str, root: bool = False, **counts) -> _Scope:
    """``with span("seam.fetch"): ...``: a child of this thread's innermost
    open span, or with `root` a new proof's top span when none is open."""
    return _Scope(name, root, counts)


def traced(name: str):
    """Decorator: each call is a `root` span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with _Scope(name, True, {}):
                return fn(*args, **kwargs)
        return run
    return wrap


def mark(name: str | None) -> None:
    """Close the phase the last mark opened on this thread (if it is the
    innermost open span) and open phase `name` (none if None) at the same
    instant, so consecutive phases leave no gap.  A phase left open closes
    with its parent."""
    st = getattr(_local, "stack", None)
    if not st:
        return
    now = time.perf_counter()
    if st[-1].phase:
        _close(st.pop(), now)
    if name is not None and st:
        st.append(_Open(name, st[-1], {}, start=now, phase=True))


def begin(name: str, **counts) -> _Open | None:
    """Open a span that no thread's stack holds, for work that moves
    between threads: a child of this thread's innermost open span, or a
    new proof's top span when none is open.  Close it with :func:`end`."""
    st = _stack()
    if st:
        return _Open(name, st[-1], counts)
    return _Open(name, None, counts) if recording() else None


def child(parent: _Open | None, name: str, **counts) -> _Open | None:
    """:func:`begin` under an explicit `parent` (nothing if it is None)."""
    return None if parent is None else _Open(name, parent, counts)


def end(o: _Open | None) -> None:
    if o is not None:
        _close(o, time.perf_counter())


class adopt:
    """``with adopt(parent): ...``: `parent` (a span from :func:`begin` /
    :func:`child`, or None) is this thread's innermost open span for the
    block, as on a pool thread that runs one proof's step; it stays open
    after it."""

    __slots__ = ("parent",)

    def __init__(self, parent: _Open | None):
        self.parent = parent

    def __enter__(self):
        if self.parent is not None:
            _stack().append(self.parent)

    def __exit__(self, *exc):
        if self.parent is not None:
            st = _stack()
            end = time.perf_counter()
            while st:
                top = st.pop()
                if top is self.parent:
                    break
                _close(top, end)
        return False


class shared:
    """``with shared("seam.fetch", parents): ...``: one block that several
    proofs wait for together (a batch's one sync) is a child `name` of
    each of `parents` (spans or None), with one start and end; counts in
    the block land in the first."""

    __slots__ = ("name", "parents", "open")

    def __init__(self, name: str, parents):
        self.name = name
        self.parents = [p for p in parents if p is not None]
        self.open = None

    def __enter__(self):
        if self.parents:
            self.open = _Open(self.name, self.parents[0], {})
            _stack().append(self.open)

    def __exit__(self, *exc):
        first = self.open
        if first is not None:
            end = _unwind(first)
            for p in self.parents[1:]:
                _close(_Open(self.name, p, {}, start=first.start), end)
        return False


def count(key: str, n: int = 1) -> None:
    """Add `n` to `key` in the counts of this thread's innermost open
    span (nothing when none is open)."""
    st = getattr(_local, "stack", None)
    if st:
        c = st[-1].counts
        c[key] = c.get(key, 0) + n

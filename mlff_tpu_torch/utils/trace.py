"""The port's tracer: spans at the layer boundaries of training and
prediction, and counters.

A span has a name, a start and an end on the host's clock
(``time.perf_counter``), the id of the span open around it when it opened
(its parent), the id of its request (the outermost ``request`` span open
around it: one ``Trainer.train`` or ``Predictor.predict`` call), and a few
integer attributes (``set``).

Nothing is kept unless a ``recording()`` is open.  Off, ``span`` returns one
shared object that does nothing: it reads no clock, allocates nothing,
synchronizes nothing and makes no device call.  Two kinds of boundary read
the clock whether recording or not, because their seconds feed a field the
program already reports, and they read it as often as those fields' timers
did: ``timed`` (``cache_build_s``, ``total_time_preconditioner``,
``total_time_cg``, ``total_time_solve``, ``finalize_s``) and ``stages``
(labelled stages back to back, one read per boundary: the Nystrom build's
``info["nystrom"]["stages"]``).

While recording, spans stay in memory, in ``Recorder.spans``, and recording
adds no device synchronization.  The recorder reads ``time.time_ns() - time.perf_counter_ns()``
once when it opens, so ``Recorder.epoch`` places a span on the Unix-epoch
timeline that ``torch.profiler``'s (Kineto's) host and device records share.
No span opens ``record_function`` or any other profiler range: the profiler
mirrors such a range onto the device's timeline, where it would count as
device work.

Recording follows the thread that opened it; spans that other threads open
meanwhile are not kept.  Counters (``count``) add to ``COUNTERS`` at all
times, and a recording snapshots them when it opens and when it closes;
``counted`` and ``add`` carry a CUDA graph's counts from its capture to its
replays, and ``unrecorded`` keeps the spans of its capture out of the
recording.
"""

from __future__ import annotations

import contextlib
import threading
import time

from .timing import union_us

COUNTERS: dict[str, int] = {}
_rec: Recorder | None = None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTERS[name] = COUNTERS.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name`` (0 before its first count)."""
    return COUNTERS.get(name, 0)


def reset(*names: str) -> None:
    """Set the counters ``names`` back to 0."""
    for name in names:
        COUNTERS.pop(name, None)


@contextlib.contextmanager
def counted():
    """The counters' changes across the block: ``with counted() as got``
    fills ``got`` ({name: change}) when the block ends.  A CUDA graph's
    capture counts the kernels it records but runs none, and each replay
    runs them all: its caller takes ``got`` back out once
    (``add(got, -1)``) and adds it once per replay."""
    start = dict(COUNTERS)
    got: dict[str, int] = {}
    try:
        yield got
    finally:
        for name, n in COUNTERS.items():
            if n != start.get(name, 0):
                got[name] = n - start.get(name, 0)


def add(counts: dict, times: int = 1) -> None:
    """Add ``times`` times each of ``counts`` ({name: n}) to its counter."""
    for name, n in counts.items():
        count(name, n * times)


@contextlib.contextmanager
def unrecorded():
    """Keep none of the spans that close inside the block.  A CUDA graph's
    capture opens the spans of the calls it records but runs none of them,
    and its replays open none: the recording keeps the spans of the calls
    that ran."""
    rec = _active()
    kept = None if rec is None else len(rec.spans)
    try:
        yield
    finally:
        if rec is not None:
            del rec.spans[kept:]


def _sync(device) -> None:
    if device is not None and device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


class Span:
    """One span: a context manager while open, a record once closed.  A
    span made off the recording (``timed`` while not recording) only
    reads the clock."""

    __slots__ = ("name", "start", "end", "id", "parent", "request", "attrs",
                 "_rec", "_root")

    def __init__(self, name, rec=None, root=False):
        self.name, self._rec, self._root = name, rec, root
        self.id = self.parent = self.request = self.attrs = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def set(self, key: str, value: int) -> None:
        """Attach an integer attribute (kept only while recording)."""
        if self._rec is not None:
            if self.attrs is None:
                self.attrs = {}
            self.attrs[key] = int(value)

    def __enter__(self):
        self.start = time.perf_counter()
        if self._rec is not None:
            self._rec._open(self, self._root)
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        if self._rec is not None:
            self._rec._close(self)
        return False


class _Null:
    """The span of the off path: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, key, value) -> None:
        pass


NULL = _Null()


def _active():
    rec = _rec
    if rec is None or rec.thread != threading.get_ident():
        return None
    return rec


def span(name: str):
    """A span named ``name``; ``NULL`` when not recording."""
    if _rec is None:
        return NULL
    rec = _active()
    return NULL if rec is None else Span(name, rec)


def request(name: str):
    """A span that is a request's root, unless a request is open already
    (a prediction inside a training is part of the training)."""
    if _rec is None:
        return NULL
    rec = _active()
    return NULL if rec is None else Span(name, rec, root=True)


def timed(name: str) -> Span:
    """A span whose ``seconds`` feed a reported field: it reads the clock at
    both ends whether recording or not, and is recorded while recording."""
    return Span(name, _active())


class stages:
    """Labelled stages back to back, from the ``with`` to each ``mark``:
    ``seconds[label]`` is the stage that ``mark(label)`` ends.  One clock
    read on entry and one per mark, after synchronizing ``sync`` if given;
    while recording, each stage is a span ``<prefix>.<label>``, the parent
    of the spans opened inside it."""

    def __init__(self, prefix: str, sync=None):
        self.prefix, self.sync = prefix, sync
        self.seconds: dict[str, float] = {}
        self._rec = _active()
        self._cur = None

    def __enter__(self):
        self._last = time.perf_counter()
        self._begin(self._last)
        return self

    def _begin(self, start: float) -> None:
        if self._rec is not None:
            self._cur = Span(None, self._rec)
            self._cur.start = start
            self._rec._open(self._cur, False)

    def mark(self, label: str) -> None:
        _sync(self.sync)
        now = time.perf_counter()
        self.seconds[label] = now - self._last
        self._last = now
        if self._rec is not None:
            self._cur.name = f"{self.prefix}.{label}"
            self._cur.end = now
            self._rec._close(self._cur)
            self._begin(now)

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec._drop(self._cur)
        return False


class Recorder:
    """The spans of one recording, in the order they closed, and the
    counters at its start and end (``counted``)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.thread = threading.get_ident()
        self.counters_start = dict(COUNTERS)
        self.counters_end: dict | None = None
        self._stack: list[Span] = []
        self._request = None
        self._next = 0
        self.offset_s = (time.time_ns() - time.perf_counter_ns()) * 1e-9

    def _open(self, s: Span, root: bool) -> None:
        s.id, self._next = self._next, self._next + 1
        s.parent = self._stack[-1].id if self._stack else None
        if root and self._request is None:
            self._request = s.id
        s.request = self._request
        self._stack.append(s)

    def _drop(self, s: Span) -> None:
        while self._stack:
            top = self._stack.pop()
            if top is s:
                break
        if self._request == s.id:
            self._request = None

    def _close(self, s: Span) -> None:
        self._drop(s)
        self.spans.append(s)

    def epoch(self, t: float) -> float:
        """A time of a span as Unix-epoch seconds, the profiler's clock."""
        return t + self.offset_s

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def roots(self) -> list:
        """The request roots."""
        return [s for s in self.spans if s.id == s.request]

    def children(self, s: Span) -> list:
        return [c for c in self.spans if c.parent == s.id]

    def under(self, s: Span, name: str) -> bool:
        """Whether a span named ``name`` encloses ``s``."""
        by_id = {x.id: x for x in self.spans}
        p = by_id.get(s.parent)
        while p is not None:
            if p.name == name:
                return True
            p = by_id.get(p.parent)
        return False

    def self_seconds(self, s: Span) -> float:
        """The span's duration less the part of it its children cover."""
        return self_seconds(s, self.children(s))

    def counted(self, name: str) -> int:
        """What the counter ``name`` added during the recording."""
        end = COUNTERS if self.counters_end is None else self.counters_end
        return end.get(name, 0) - self.counters_start.get(name, 0)


def self_seconds(s: Span, children) -> float:
    """``s``'s duration less the union of its ``children``'s intervals,
    each clipped to ``s``."""
    inside = [(max(c.start, s.start), min(c.end, s.end)) for c in children]
    return s.seconds - union_us((a, b) for a, b in inside if b > a)


@contextlib.contextmanager
def recording():
    """Record spans until the block ends: ``with recording() as rec``."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is open already")
    rec = Recorder()
    _rec = rec
    try:
        yield rec
    finally:
        _rec = None
        rec.counters_end = dict(COUNTERS)

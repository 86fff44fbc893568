"""Spans and set-up records: where a render's host time goes, by layer.

`span(name, **counts)` marks a stretch of host code as a context
manager. Names are `dcrt.<layer>.<what>`, the layer one of the
benchmark's (renderer, integrator, traversal), so a reader maps a span to
its layer by its name. While a `torch.profiler.profile` runs, a span
opens a profiler range of its name, so it lies in `prof.events()` and in
an exported Chrome trace above the kernels it issued, and appends a
`Record` to an in-memory store: its id, its parent's, the id of the
`dcrt.renderer.pass` it belongs to, its start and end on
`time.time_ns()` (the profiler's clock: `prof.events()` times are µs
after `prof.profiler.kineto_results.trace_start_ns()`), and its counts.
With no profiler running a span only reads the profiler's flag, on every
entry: no range, no record, no clock read. A span adds no device op and
no host-device sync; a count is a host number the code already has (a
shape, a total it read back). `add(**counts)` adds to the innermost open
span's counts.

The range is PyTorch's fast record function, not
`torch.profiler.record_function`: the latter's user-scope ranges also
come back as `gpu_user_annotation` events on the CUDA timeline, which a
reader of device ops would count as device work.

The store keeps the newest `MAX_RECORDS` spans (`records()`; `dropped()`
counts those it let go; `reset()` empties it). Set-up records
(`setup(name, **fields)`: the flatten, the LUTs, each library load, each
`Renderer`'s first pass) are always kept, one `perf_counter` pair each,
logged through the `dcrt` logger at info level (`DCRT_LOG=1`) and listed
by `setup_records()`.
"""

import itertools
import threading
import time
from collections import deque
from typing import NamedTuple

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

from .log import logger

MAX_RECORDS = 1 << 16
PASS = "dcrt.renderer.pass"


class Record:
    """One span: name, id, parent (id or None), pass_id (the enclosing
    `dcrt.renderer.pass`'s id, its own for a pass, or None), start_ns and
    end_ns (`time.time_ns()`, end None while open) and counts."""

    __slots__ = ("name", "id", "parent", "pass_id", "start_ns", "end_ns",
                 "counts")

    def __repr__(self):
        return (f"Record({self.name!r}, id={self.id}, parent={self.parent}, "
                f"pass_id={self.pass_id}, ns={self.start_ns}-{self.end_ns}, "
                f"counts={self.counts})")


class SetupRecord(NamedTuple):
    name: str
    seconds: float
    fields: dict


_records = deque(maxlen=MAX_RECORDS)
_setup = []
_ids = itertools.count(1)
_open = threading.local()
_dropped = 0


def _stack():
    s = getattr(_open, "stack", None)
    if s is None:
        s = _open.stack = []
    return s


class _Span:
    __slots__ = ("name", "counts", "range", "rec")

    def __init__(self, name, counts):
        self.name, self.counts = name, counts

    def __enter__(self):
        global _dropped
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        stack = _stack()
        parent = stack[-1] if stack else None
        rec = self.rec = Record()
        rec.name, rec.id, rec.counts = self.name, next(_ids), self.counts
        rec.parent = parent.id if parent is not None else None
        rec.pass_id = rec.id if self.name == PASS else (
            parent.pass_id if parent is not None else None)
        rec.end_ns = None
        if len(_records) == _records.maxlen:
            _dropped += 1
        _records.append(rec)
        stack.append(rec)
        rec.start_ns = time.time_ns()
        return self

    def add(self, **counts):
        _add(self.rec.counts, counts)

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        _stack().pop()
        self.range.__exit__(*exc)
        return False


class _Off:
    """The span of a run with no profiler: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counts):
        pass


_OFF = _Off()


def span(name, **counts):
    """A context manager: a profiler range and a `Record` while a profiler
    runs, nothing otherwise (see the module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, counts)


def _add(into, counts):
    for k, v in counts.items():
        into[k] = into.get(k, 0) + v


def add(**counts):
    """Add counts to the innermost open span of this thread, if any."""
    stack = getattr(_open, "stack", None)
    if stack:
        _add(stack[-1].counts, counts)


def records():
    """The stored spans, oldest first (an open span has end_ns None)."""
    return list(_records)


def dropped():
    """Spans the store let go since the last `reset()`."""
    return _dropped


def reset():
    """Empty the span store (set-up records stay)."""
    global _dropped
    _records.clear()
    _dropped = 0


class setup:
    """Time the block by one `perf_counter` pair into a `SetupRecord`
    (kept, and logged at info level) when it ends without raising;
    `fields` and `add(**fields)` travel with it. While a profiler runs
    the block is also a span of the same name."""

    def __init__(self, name, **fields):
        self.name, self.fields = name, fields

    def __enter__(self):
        self.span = span(self.name)
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def add(self, **fields):
        self.fields.update(fields)

    def __exit__(self, kind, *exc):
        seconds = time.perf_counter() - self.t0
        self.span.__exit__(kind, *exc)
        if kind is None:
            _setup.append(SetupRecord(self.name, seconds, self.fields))
            logger.info("%s %.6f s %s", self.name, seconds, self.fields)
        return False


def setup_records():
    """The set-up records of this process, in order."""
    return list(_setup)

"""Spans and host-sync counts of the batched solve, kept in memory.

A span is a named interval of the host's work (`batch.setup`,
`solve.segment`, ...) with its parent span, the batch it belongs to (the
spans of one BatchedSCS construction and of its solves share one id) and a
few attributes. A host sync is a point where the host waits for the device:
a read of a device value (`bool`, `.item`, `.tolist`, `.cpu()`), a device
synchronize, or a synchronous upload. Each is recorded at its named site,
at the time the wait returned, under the innermost open span. Times are
epoch ns (`time.time_ns()`), the clock of torch.profiler's events, so a
recording lines up with a profiler trace of the same run.

Recording is on inside `with recording():` and whenever a torch.profiler
session is active; otherwise a span or a sync costs one flag check, records
nothing, and adds no device work and no wait. The newest `MAX_RECORDS`
records are kept (`records()`); nothing is written out.

    with scs_tpu_torch.trace.recording():
        res = BatchedSCS(data, cone).solve()
    spans = [r for r in scs_tpu_torch.trace.records() if isinstance(r, Span)]
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple

import torch.autograd.profiler as _profiler

MAX_RECORDS = 1 << 16

_records: deque = deque(maxlen=MAX_RECORDS)
_local = threading.local()  # .open: this thread's open spans, innermost last
_span_ids = itertools.count(1)
_batch_ids = itertools.count(1)
_forced = 0  # open recording() blocks


class Span:
    """A span: `t0` / `t1` epoch ns (recorded once it closes); `parent` the
    enclosing span's id (None at the top); `batch` the id of the solver it
    belongs to."""

    __slots__ = ("name", "id", "parent", "batch", "t0", "t1", "attrs")

    def __init__(self, name, batch, attrs):
        self.name, self.batch, self.attrs = name, batch, attrs
        self.id = self.parent = self.t0 = self.t1 = None

    def set(self, **attrs):
        """Add attributes known only once the span has run."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _open()
        if stack:
            self.parent = stack[-1].id
            if self.batch is None:
                self.batch = stack[-1].batch
        self.id = next(_span_ids)
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        stack = _open()
        if stack and stack[-1] is self:
            stack.pop()
        _records.append(self)
        return False


class Sync(NamedTuple):
    """A counted host sync: its site, the epoch ns at which the wait
    returned, and the innermost open span (id and batch; None outside any)."""

    site: str
    t: int
    span: int | None
    batch: int | None


class _Off:
    """The span handed out while recording is off: it records nothing."""

    __slots__ = ()

    def set(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _open():
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def active():
    """Whether spans and syncs are recorded now."""
    return bool(_forced) or _profiler._is_profiler_enabled


@contextmanager
def recording():
    """Record inside the block (blocks nest; the profiler needs none)."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def new_batch():
    """A fresh batch id, shared by the spans of one solver."""
    return next(_batch_ids)


def span(name, batch=None, **attrs):
    """`with span(name, **attrs) as sp:` records the block as a span; the
    batch id is the enclosing span's where not given."""
    if not (_forced or _profiler._is_profiler_enabled):
        return _OFF
    return Span(name, batch, attrs)


def host_sync(site):
    """Record a host sync at `site`; call it right after the wait returned."""
    if not (_forced or _profiler._is_profiler_enabled):
        return
    t = time.time_ns()
    stack = _open()
    top = stack[-1] if stack else None
    _records.append(Sync(site, t, top and top.id, top and top.batch))


def any_(mask, site):
    """bool(mask.any()): a read of the device, counted at `site`."""
    out = bool(mask.any())
    host_sync(site)
    return out


def uploaded(device, site):
    """Count a synchronous host-to-device copy just made to `device` at
    `site` (a copy to the CPU is no wait, and is not counted)."""
    if device.type == "cuda":
        host_sync(site)


def records(since=None, until=None):
    """The kept records, oldest first: closed `Span`s (in the order they
    closed) and `Sync`s; with `since` and `until` (epoch ns), those that
    lie between them."""
    out = list(_records)
    if since is None:
        return out

    def within(r):
        return since <= r.t <= until if isinstance(r, Sync) else since <= r.t0 <= r.t1 <= until

    return [r for r in out if within(r)]


def clear():
    _records.clear()
